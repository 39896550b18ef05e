"""Blocked ESC SpGEMM (row-packed, batched sort): the port of
``sparsetpu/ops/escb.py``.

The ESC algorithm (expand every partial product, sort, merge duplicates)
restructured so that no sort spans the whole expansion:

  1. host half (``blocked_config``): fetch the per-row product counts fr
     (``row_flops``, one n-sized transfer), then pack whole rows into blocks
     of L lanes, next-fit decreasing (``pack_rows``), so rows never straddle
     blocks;
  2. device half (``_numeric``): gather every partial product straight into
     the (nb, L) layout, sort each block along its lanes by the fused
     (i * m + j) key, merge duplicates with the lane-axis segmented scan,
     and scatter the survivors into the output CSR.

Rows with more than L products are packed alone into blocks of a second
lane width L2 (a second ``_numeric``), merged with ``merge_disjoint_rows``;
rows past ``MAX_L`` raise.

Differences from the JAX package: the host and device halves are split
(``blocked_config``, ``blocked_numeric``), as rowcat's are, so that the
sweep times the device half with a fixed plan whether or not wide rows
exist; each row's rank among its survivors is a gather through its segment
start (``segments.segment_start``), not a running maximum (the H100's
``torch.cummax`` took 15 ms for 2^23 elements); the sort key stays int32
under JAX's n * m < 2^31 guard, so both packages refuse the same shapes.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..csr import SparseCSR
from . import segments
from .segments import INT32_SENTINEL
from .spgemm import narrow_u64_ok, pow2, row_flops, shared_stream

# lanes of a block: the batched sort and the lane scans are bounded by L
DEFAULT_L = 1 << 15
MAX_L = 1 << 20


def pack_rows(fr: np.ndarray, L: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """Next-fit-decreasing packing of rows into blocks of capacity L.

    Returns (pack2row, starts_pad, nb): pack order q -> row id, q -> padded
    start position, and the block count.  Rows with fr[r] > L must be
    filtered by the caller."""
    order = np.argsort(-fr, kind="stable")
    pack2row = np.empty(len(fr), np.int32)
    starts_pad = np.empty(len(fr), np.int32)
    block = 0
    used = 0
    for q, r in enumerate(order):
        f = int(fr[r])
        if used + f > L:
            block += 1
            used = 0
        pack2row[q] = r
        starts_pad[q] = block * L + used
        used += f
    return pack2row, starts_pad, block + 1


def _numeric(a: SparseCSR, b: SparseCSR, pack2row: torch.Tensor,
             starts_pad: torch.Tensor, fr: torch.Tensor, L: int, nb: int,
             out_cap: int, cap_g: int, narrow: bool = False) -> SparseCSR:
    """Device half for one lane width: expand into (nb, L), sort every block,
    merge along the lanes, assemble.  Output rows not in ``pack2row`` get no
    entries.  ``narrow`` (u64, max(A) * max(B) < 2^32, checked by the
    caller): the products ride one limb and the merge rebuilds the hi limb
    from the carries."""
    sr = a.sr
    n, m = a.n_rows, b.n_cols
    device = a.device
    npad = nb * L
    nq = pack2row.shape[0]

    # row of every padded slot: pack order is ascending along the stream
    q_of_slot = segments.repeat_index(starts_pad.long(), torch.arange(nq, device=device),
                                      npad)
    q_safe = torch.clamp(q_of_slot, 0, nq - 1)
    r = pack2row.long()[q_safe]
    off_in_row = torch.arange(npad, device=device) - starts_pad.long()[q_safe]
    ok = (q_of_slot >= 0) & (off_in_row < fr[r])

    # the natural expansion stream of every row of A (ESC's expand)
    cin0, src, shift, _ = shared_stream(a, b, cap_g)
    g = torch.clamp(cin0[a.row_ptr.long()[torch.clamp(r, 0, n - 1)]] + off_in_row,
                    0, cap_g - 1)
    e = torch.clamp(src[g], 0, a.capacity - 1)
    b_pos = torch.clamp(g + shift[e], 0, b.capacity - 1)
    key = torch.where(ok, r * m + b.col_idx[b_pos], INT32_SENTINEL).int()
    if narrow:
        v = (torch.where(ok, a.values[0][e] * b.values[0][b_pos], 0),)
    else:
        v = sr.mul(sr.gather(a.values, e), sr.gather(b.values, b_pos))
        v = sr.where(ok, v, sr.zeros((npad,), device=device))

    # one batched sort along the lanes, then the lane-axis segmented merge
    key_s, perm = torch.sort(key.view(nb, L), dim=1, stable=True)
    limbs_s = tuple(torch.gather(x.view(nb, L), 1, perm) for x in v)
    prev = torch.cat([key_s.new_full((nb, 1), -1), key_s[:, :-1]], dim=1)
    head = key_s != prev
    totals, exact_ok = segments.segment_reduce_sorted(sr, head, limbs_s, axis=1)
    tail = torch.cat([head[:, 1:], head.new_ones((nb, 1))], dim=1)
    keep = (tail & (key_s != INT32_SENTINEL) & ~sr.is_zero(totals)).view(-1)

    # each survivor's rank within its row (rows are contiguous in a block),
    # the rows' survivor counts at their last slots, then one index scatter
    keyf = key_s.view(-1)
    rowf = torch.where(keyf != INT32_SENTINEL, keyf // m, n).long()
    row_head = torch.cat([rowf.new_ones(1, dtype=torch.bool), rowf[1:] != rowf[:-1]])
    row_head.view(nb, L)[:, 0] = True
    row_tail = torch.cat([row_head[1:], row_head.new_ones(1)])
    keep_i = keep.long()
    excl = torch.cumsum(keep_i, dim=0) - keep_i
    rank = excl - excl[segments.segment_start(row_head)]
    slot = torch.arange(npad, device=device)
    # one dump slot per non-tail slot: no two writes meet at one address
    nr = torch.zeros(n + npad, dtype=torch.int64, device=device)
    nr[torch.where(row_tail & (rowf < n), rowf, n + slot)] = rank + keep_i
    row_ptr = torch.cat([nr.new_zeros(1), torch.cumsum(nr[:n], dim=0)])
    nnz = row_ptr[-1]
    dest = row_ptr[torch.clamp(rowf, 0, n - 1)] + rank
    dest = torch.where(keep & (dest < out_cap), dest, out_cap + slot)
    src_of_dest = torch.full((out_cap + npad,), npad, dtype=torch.int64, device=device)
    src_of_dest[dest] = slot
    src_of_dest = src_of_dest[:out_cap]
    filled = src_of_dest < npad
    sod = torch.clamp(src_of_dest, 0, npad - 1)
    col_idx = torch.where(filled, keyf[sod] % m, INT32_SENTINEL).int()
    vals = tuple(torch.where(filled, x.view(-1)[sod], 0) for x in totals)
    ok_out = (nnz <= out_cap) & exact_ok
    return SparseCSR(row_ptr=row_ptr.int(), col_idx=col_idx, values=vals,
                     nnz=torch.where(ok_out, nnz, -1), n_rows=n, n_cols=m, sr_name=sr.name)


@dataclasses.dataclass(frozen=True)
class BlockedPlan:
    """The host half of ``spgemm_blocked``: one (pack2row, starts_pad, L, nb)
    pack per lane width (the narrow rows', then the wide rows' if any), the
    per-row product counts and the capacities."""

    packs: Tuple[Tuple[torch.Tensor, torch.Tensor, int, int], ...]
    fr: torch.Tensor
    out_cap: int
    cap_g: int
    narrow: bool


def blocked_config(a: SparseCSR, b: SparseCSR, out_cap: Optional[int] = None,
                   L: int = DEFAULT_L) -> BlockedPlan:
    """Fetch the per-row product counts (one n-sized transfer; the narrow
    test fetches the two operands' largest values) and pack the rows.
    Raises ValueError where JAX's ``spgemm_blocked`` does."""
    if a.n_cols != b.n_rows:
        raise ValueError(f"shapes {a.shape} x {b.shape} do not chain")
    if a.n_rows * b.n_cols >= 1 << 31:
        # the fused i*m+j key would wrap int32 in the JAX package
        raise ValueError(f"escb fused keys need n*m < 2^31 (got {a.n_rows}x{b.n_cols}); "
                         "use a slab route")
    narrow = narrow_u64_ok(a, b)
    fr_dev = row_flops(a, b)
    fr = fr_dev.cpu().numpy()
    total = int(fr.sum())
    if total >= 1 << 31:
        raise ValueError(f"expansion of {total} products cannot be materialized")
    wide = fr > L
    lanes = [(~wide, L)]
    if wide.any():
        wmax = int(fr[wide].max())
        if wmax > MAX_L:
            raise ValueError(f"row expands to {wmax} products (> {MAX_L}); use a "
                             "dense-accumulator path for this product")
        lanes.append((wide, pow2(wmax)))
    packs: List[Tuple[torch.Tensor, torch.Tensor, int, int]] = []
    for rows_mask, lane in lanes:
        sel = np.flatnonzero(rows_mask & (fr > 0))
        if len(sel):
            p2r, starts, nb = pack_rows(fr[sel], lane)
            packs.append((torch.from_numpy(sel[p2r].astype(np.int32)).to(a.device),
                          torch.from_numpy(starts).to(a.device), lane, nb))
    return BlockedPlan(tuple(packs), fr_dev, out_cap or pow2(total), pow2(total), narrow)


def blocked_numeric(a: SparseCSR, b: SparseCSR, plan: BlockedPlan) -> SparseCSR:
    """Device half: one ``_numeric`` per pack, merged when there are two."""
    outs = [_numeric(a, b, p2r, starts, plan.fr, lane, nb, plan.out_cap, plan.cap_g,
                     narrow=plan.narrow)
            for p2r, starts, lane, nb in plan.packs]
    if not outs:
        return SparseCSR.empty(a.n_rows, b.n_cols, max(plan.out_cap, 1), a.sr, a.device)
    if len(outs) == 1:
        return outs[0]
    return merge_disjoint_rows(outs[0], outs[1], plan.out_cap)


def spgemm_blocked(a: SparseCSR, b: SparseCSR, out_cap: Optional[int] = None,
                   L: int = DEFAULT_L) -> SparseCSR:
    """C = A x B by row-packed blocked ESC: one n-sized fetch and the host
    packing, then one device pass per lane width (two when wide rows need
    a second)."""
    return blocked_numeric(a, b, blocked_config(a, b, out_cap, L))


def merge_disjoint_rows(c1: SparseCSR, c2: SparseCSR, out_cap: int) -> SparseCSR:
    """Merge two CSRs whose rows are disjoint: per-row counts add, then one
    gather per array (no sort)."""
    if c1.shape != c2.shape:
        raise ValueError(f"shapes {c1.shape} and {c2.shape} differ")
    n = c1.n_rows
    device = c1.device
    nr1 = c1.row_nnz().long()
    nr2 = c2.row_nnz().long()
    row_ptr = torch.cat([nr1.new_zeros(1), torch.cumsum(nr1 + nr2, dim=0)])
    nnz = row_ptr[-1]
    t = torch.arange(out_cap, device=device)
    rs = torch.clamp(segments.repeat_index(row_ptr[:-1], torch.arange(n, device=device),
                                           out_cap), 0, n - 1)
    k = t - row_ptr[rs]
    use1 = nr1[rs] > 0
    pos1 = torch.clamp(c1.row_ptr.long()[rs] + k, 0, c1.capacity - 1)
    pos2 = torch.clamp(c2.row_ptr.long()[rs] + k, 0, c2.capacity - 1)
    in_range = t < nnz
    col_idx = torch.where(in_range, torch.where(use1, c1.col_idx[pos1], c2.col_idx[pos2]),
                          INT32_SENTINEL)
    vals = tuple(torch.where(in_range, torch.where(use1, v1[pos1], v2[pos2]), 0)
                 for v1, v2 in zip(c1.values, c2.values))
    poisoned = (c1.nnz < 0) | (c2.nnz < 0) | (nnz > out_cap)
    return SparseCSR(row_ptr=row_ptr.int(), col_idx=col_idx, values=vals,
                     nnz=torch.where(poisoned, -1, nnz), n_rows=n, n_cols=c1.n_cols,
                     sr_name=c1.sr_name)
