"""Sorted-segment primitives: the counterpart of ``sparsetpu/ops/segments.py``.

Every sparse operation of the port keeps its entries as flat sorted streams
and merges duplicates with segmented reductions, all in device tensor ops
with shapes fixed by the caller (no host synchronisation):

  - ``sort_by_keys``: stable lexicographic sort (least significant key first);
  - ``segment_heads``: where a new key segment starts;
  - ``segment_reduce_sorted``: running segment sums on a semiring;
  - ``compact``: stable front-compaction of the kept entries;
  - ``repeat_index``: "repeat each value over its segment of positions";
  - ``reduce_sorted_coo``: merge the duplicates of a sorted COO stream.

Differences from the JAX package, and why:

- ``blocked_scan``, ``cumsum_blocked`` and ``cummax_1d`` existed only to stay
  under the TPU compiler's ceiling on long scans and are not ported: the
  port's scans are ``torch.cumsum``.  It uses no ``torch.cummax`` either,
  whose CUDA kernel took 15 ms for 2^23 elements on an H100; a running
  maximum of segment starts becomes a cumulative sum of increments
  (``repeat_index``) or a gather through the head positions
  (``segment_start``).
- The JAX package sums integer limbs in 16-bit planes of uint32, which is
  exact only while a segment holds fewer than 2^16 - 1 nonzero entries; past
  that it poisons the count to -1.  The port sums whole 32-bit limbs in
  int64: the wrap of a long running sum cancels in the difference of two
  cumulative sums, so a segment's sum is exact while it is below 2^63, that
  is at any segment length below 2^31 entries.  The port therefore never
  poisons for the count (``ROADMAP.md`` queue 3 records the divergence).
- A float32 segment sum is never a difference of cumulative sums (that
  loses the segment's precision to the running total) and never an atomic
  ``index_add_``/``scatter_add`` (whose order changes from run to run): it is
  a segmented Hillis-Steele scan, deterministic, as the JAX package's
  associative scan is.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..semiring import MASK32, Semiring, Value

INT32_SENTINEL = 0x7FFFFFFF    # column of a padded slot (JAX's sentinel)
KEY_SENTINEL = (1 << 63) - 1   # fused int64 (row, col) key of an invalid entry


def sort_by_keys(keys: Sequence[torch.Tensor], payloads: Sequence[torch.Tensor]):
    """Stable lexicographic sort by ``keys`` (first key most significant);
    returns (sorted keys, sorted payloads) as lists."""
    n = keys[0].shape[0]
    perm = torch.arange(n, device=keys[0].device)
    for k in reversed(list(keys)):
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return [k[perm] for k in keys], [p[perm] for p in payloads]


def segment_heads(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Boolean tensor: True where a new key segment starts (element 0 is True)."""
    head = torch.zeros(keys[0].shape, dtype=torch.bool, device=keys[0].device)
    head[:1] = True
    for k in keys:
        head[1:] |= k[1:] != k[:-1]
    return head


def _recombine(sr: Semiring, sums: Sequence[torch.Tensor]) -> Value:
    """Exact int64 sums of the limbs (each below 2^63) -> saturated limbs.

    One sum (u32, or u64 carried narrow in one limb) or two (u64's lo and hi
    sums); a saturating fold of non-negative values equals min(true sum, MAX)."""
    if sr.name == "u32":
        return (torch.clamp(sums[0], max=MASK32),)
    if len(sums) == 1:  # narrow u64: the carries past bit 32 are the hi limb
        return (sums[0] & MASK32, sums[0] >> 32)
    lo_sum, hi_sum = sums
    hi = hi_sum + (lo_sum >> 32)
    over = hi > MASK32
    return (torch.where(over, MASK32, lo_sum & MASK32), torch.where(over, MASK32, hi))


def segment_start(heads: torch.Tensor) -> torch.Tensor:
    """Index of the head of the segment covering each slot of a 1-D stream
    (heads[0] True)."""
    n = heads.shape[0]
    head_pos = torch.nonzero_static(heads, size=n, fill_value=n)[:, 0]
    return head_pos[torch.cumsum(heads, dim=0) - 1]


def segment_reduce_sorted(sr: Semiring, heads: torch.Tensor, values: Value,
                          axis: int = 0) -> Tuple[Value, torch.Tensor]:
    """Segmented inclusive running sums: position i holds the sum of its
    segment up to i, so each segment's total sits at its last element.
    Returns ``(totals, exact_ok)``; ``exact_ok`` is always True here (the JAX
    package's is False past its 16-bit plane bound).

    ``axis=0``: a 1-D stream, ``heads[0]`` True (as ``segment_heads`` gives).
    ``axis=1``: independent rows of (R, L) streams (the row-categorized and
    blocked SpGEMM's lane merge), ``heads[:, 0]`` True.  Since every row
    starts a segment, the rows run as one flattened stream, and no segment
    is longer than a row, which bounds the f32 scan's passes by log2(L)."""
    if heads.dim() != axis + 1 or axis not in (0, 1):
        raise ValueError(f"axis {axis} does not fit heads of shape {tuple(heads.shape)}")
    shape = heads.shape
    span = shape[-1]
    heads = heads.reshape(-1)
    values = tuple(v.reshape(-1) for v in values)
    ok = torch.ones((), dtype=torch.bool, device=heads.device)
    start = segment_start(heads)
    if sr.name != "f32":
        sums = []
        for limb in values:
            c = torch.cumsum(limb, dim=0)
            sums.append(c - (c - limb)[start])
        return tuple(x.view(shape) for x in _recombine(sr, sums)), ok
    # float32: a segmented Hillis-Steele scan.  After the pass with shift s,
    # every slot holds the sum of up to 2s slots ending at it, never reaching
    # back past its segment's head; ceil(log2(span)) passes.
    v = values[0].clone()
    dist = torch.arange(v.shape[0], device=v.device) - start
    s = 1
    while s < span:
        v[s:] += torch.where(dist[s:] >= s, v[:-s], 0.0)
        s *= 2
    return (v.view(shape),), ok


def compact(keep: torch.Tensor, arrays: Sequence[torch.Tensor], fill_values,
            out_size: int):
    """Stable-compact the entries where ``keep`` to the front of ``out_size``
    slots; the rest of each output holds its fill value.  Entries past the
    capacity are dropped.  Returns (compacted arrays, count), where the count
    (a device scalar) is the number of kept entries and may exceed
    ``out_size`` (the caller checks)."""
    n = keep.shape[0]
    device = keep.device
    # the source of each output slot (n past the kept entries), sized
    # statically: no host synchronisation
    src = torch.nonzero_static(keep, size=out_size, fill_value=n)[:, 0]
    outs = []
    for a, fill in zip(arrays, fill_values):
        padded = torch.cat([a, torch.full((1,) + tuple(a.shape[1:]), fill,
                                          dtype=a.dtype, device=device)])
        outs.append(padded[src])
    return outs, keep.sum()


def repeat_index(starts: torch.Tensor, values: torch.Tensor, length: int,
                 fill: int = -1) -> torch.Tensor:
    """out[t] = values[e] for the segment e covering position t, where segment
    e occupies [starts[e], starts[e+1]) and ``starts`` does not decrease
    (empty segments repeat a start).  Positions before the first start hold
    ``fill``; starts at or past ``length`` drop out.

    One scatter and one cumulative sum: the increment values[e] -
    values[e-1] is added at starts[e], so the sum up to t telescopes to the
    value of the last segment starting at or before t.  Integer values only
    (the sums must be exact).  Each dropped start gets a slot of its own past
    ``length``: sending them all to one slot would serialise their atomic
    adds on the GPU."""
    n = starts.shape[0]
    device = values.device
    delta = torch.diff(values, prepend=values.new_full((1,), fill))
    marks = torch.zeros(length + n, dtype=values.dtype, device=device)
    idx = torch.where(starts < length, starts.long(), length + torch.arange(n, device=device))
    marks.index_add_(0, idx, delta)
    return fill + torch.cumsum(marks[:length], dim=0)


def reduce_sorted_coo(sr: Semiring, keys: Sequence[torch.Tensor], values: Value,
                      valid: torch.Tensor, out_size: int, key_fills: Sequence,
                      drop_zeros: bool = True):
    """Merge the duplicate keys of a sorted COO stream with the semiring's
    add, drop zero totals (when ``drop_zeros``) and compact to the front of
    ``out_size`` slots.  Invalid entries carry sentinel keys, sorted last.
    Returns (out keys, out values, nnz), nnz a device scalar (may exceed
    ``out_size``; the caller poisons).

    ``values`` may carry fewer limbs than the semiring (u64 carried narrow
    in one limb): the merge rebuilds the hi limb from the carries."""
    heads = segment_heads(keys)
    device = keys[0].device
    nk = len(keys)
    tail = torch.cat([heads[1:], heads.new_ones(1)])
    if sr.name == "f32":
        (totals,), _ = segment_reduce_sorted(sr, heads, (torch.where(valid, values[0], 0.0),))
        keep = tail & valid
        if drop_zeros:
            keep = keep & (totals != 0)
        outs, count = compact(keep, list(keys) + [totals], list(key_fills) + [0.0], out_size)
        return outs[:nk], (outs[nk],), count

    nonzero = values[0] != 0
    for limb in values[1:]:
        nonzero = nonzero | (limb != 0)
    nonzero = nonzero & valid
    cums = [torch.cumsum(nonzero, dim=0)]
    cums += [torch.cumsum(torch.where(valid, limb, 0), dim=0) for limb in values]
    keep = tail & valid
    if drop_zeros:
        # a segment survives iff it holds a nonzero entry
        start = segment_start(heads)
        keep = keep & ((cums[0] - (cums[0] - nonzero.long())[start]) > 0)
    outs, count = compact(keep, list(keys) + cums, list(key_fills) + [0] * len(cums),
                          out_size)
    # adjacent differences of the compacted inclusive sums are the segment
    # sums: dropped (all-zero) segments add nothing to any sum
    in_range = torch.arange(out_size, device=device) < count
    sums = [torch.where(in_range, torch.diff(c, prepend=c.new_zeros(1)), 0)
            for c in outs[nk + 1:]]
    return outs[:nk], _recombine(sr, sums), count
