"""Slab ESC SpGEMM: the port of ``sparsetpu/ops/slab.py``.

The ESC algorithm (expand, sort, merge) with every per-product pass turned
into per-entry or per-chunk work:

  1. *chunk* B once a call: its entries repacked into chunk-aligned (ncc, C)
     column and value tables (pad column -1), so any row of B is a run of
     C-wide chunks (``_chunk_tables``);
  2. *expand* per sub-entry, one (A entry, B chunk) pair: a slot map by
     ``repeat_index`` and row gathers of whole chunks, each landing in its
     (nb, L) slab position;
  3. *sort + merge* per block: one batched sort by (row, col) and the
     lane-axis segmented saturating merge (``segment_reduce_sorted``);
  4. *pack + assemble*: each block's survivors compacted to its front, then
     the prefix-coalesce kernel (``kernels/coalesce.py``) copies the
     prefixes into the flat CSR streams; row_ptr from one searchsorted over
     the (ascending) row stream.

Rows are packed next-fit in natural order (``pack_rows_ordered``), never
straddling a block, so the coalesced stream is in (row, col) order.  Rows
whose chunks exceed a block run at a second lane width and merge through
``escb.merge_disjoint_rows``; rows past ``MAX_L`` slots raise.

Differences from the JAX package, and why:

- The (row, col) sort keys are one int64 key ``row << 32 | col``, exact at
  every shape (never a fused int32 ``r * m + j``, which wraps once
  n * m > 2^31).
- The pack sort becomes a stable partition of each block (survivors first):
  the survivors are already in (row, col) order, so the result is the same.
- Compaction goes through the coalesce kernel, the assembly step the JAX
  module was designed around but could not run (Mosaic rejected the kernel;
  JAX compacts with an arithmetic gather, which is the kernel's plain
  version here).
- ``pack_rows_ordered`` loops over blocks (one ``searchsorted`` a block),
  not over rows.
- The host half (``slab_config``) and the device half (``slab_numeric``) are
  split, as ``escb``'s are, so the chain times the device half with a fixed
  plan; ``_numeric`` never synchronises.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..csr import SparseCSR
from ..kernels import coalesce
from . import segments
from .escb import merge_disjoint_rows
from .segments import INT32_SENTINEL
from .spgemm import narrow_u64_ok, pow2, symbolic_flops_exact

DEFAULT_L = 1 << 15   # lane width of a slab block (elements)
MAX_L = 1 << 20       # widest wide-row block
DEFAULT_C = 8         # B chunk width (columns gathered per sub-entry)
_KEY_SENTINEL = (INT32_SENTINEL << 32) | INT32_SENTINEL  # (row, col) key of an empty slot


def _chunk_counts(b: SparseCSR, c: int) -> torch.Tensor:
    """Chunks of C columns each row of B takes, int64[n_rows]."""
    return torch.div(b.row_nnz().long() + c - 1, c, rounding_mode="floor")


def plan_device(a: SparseCSR, b: SparseCSR, c: int):
    """Device half of planning: (rc, nch_total, sg), the sub-entries (C-wide
    chunks) of each output row, B's total chunk count and the natural
    sub-entry stream's length, as int64 device tensors."""
    nch_b = _chunk_counts(b, c)
    valid = torch.arange(a.capacity, device=a.device) < a.nnz
    acols = torch.clamp(a.col_idx.long(), 0, b.n_rows - 1)
    cnt = torch.where(valid, nch_b[acols], 0)
    cin0 = torch.cat([cnt.new_zeros(1), torch.cumsum(cnt, dim=0)])
    row_ptr = a.row_ptr.long()
    return cin0[row_ptr[1:]] - cin0[row_ptr[:-1]], nch_b.sum(), cin0[-1]


def pack_rows_ordered(rc: np.ndarray, lc: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """Next-fit packing of rows, in natural order, into blocks of ``lc``
    sub-entry slots.  Returns (sel_rows int32, starts_slot int32, nb); rows
    with rc == 0 are skipped and rows with rc > lc must be filtered by the
    caller (each still gets a block of its own, as in the JAX package).

    A row opens a new block when it does not fit the current one, so a
    block takes the longest run of rows whose sum fits: one searchsorted
    over the prefix sum a block, not a Python step a row."""
    sel = np.flatnonzero(rc > 0).astype(np.int32)
    f = np.asarray(rc, np.int64)[sel]
    cum = np.concatenate([[0], np.cumsum(f)])
    starts = np.empty(len(sel), np.int32)
    block, i = 0, 0
    opened = False  # block 0 exists before any row; later blocks are opened by a row
    while i < len(sel):
        end = int(np.searchsorted(cum, cum[i] + lc, side="right")) - 1
        if opened:
            end = max(end, i + 1)  # the opening row is placed even when it overfills
        elif end == i:
            # the first row overfills the empty block 0: it opens block 1
            block, opened = block + 1, True
            continue
        starts[i:end] = block * lc + (cum[i:end] - cum[i])
        i, block, opened = end, block + 1, True
    return sel, starts, (block if len(sel) else 1)


def _chunk_tables(b: SparseCSR, c: int, ncc: int):
    """Repack B's entries into chunk-aligned tables: cols (ncc, c) int32 with
    pad -1, one (ncc, c) table a value limb, and each row's first chunk
    (int64[n_rows + 1])."""
    device = b.device
    chstart = torch.cat([b.row_ptr.new_zeros(1, dtype=torch.int64),
                         torch.cumsum(_chunk_counts(b, c), dim=0)])
    slots = torch.arange(b.capacity, device=device)
    valid = slots < b.nnz
    rsafe = torch.clamp(b.row_of_slot(), 0, b.n_rows - 1)
    off = slots - b.row_ptr.long()[rsafe]
    # one dump slot per padded slot: no two writes meet at one address
    pos = torch.where(valid, chstart[rsafe] * c + off, ncc * c + slots)
    size = ncc * c + b.capacity
    cols = torch.full((size,), -1, dtype=torch.int32, device=device)
    cols[pos] = torch.where(valid, b.col_idx, -1)
    vals = []
    for limb in b.values:
        t = torch.zeros(size, dtype=limb.dtype, device=device)
        t[pos] = torch.where(valid, limb, 0)
        vals.append(t[:ncc * c].view(ncc, c))
    return cols[:ncc * c].view(ncc, c), tuple(vals), chstart


def _survivors(a: SparseCSR, b: SparseCSR, sel_rows: torch.Tensor,
               starts_slot: torch.Tensor, rc: torch.Tensor, c: int, l: int, nb: int,
               ncc: int, sg: int, narrow: bool):
    """Expand, sort and merge the packed rows into (nb, l) blocks, each
    block's survivors at its front in (row, col) order.  Returns (offs
    int32[nb + 1], streams (row int32, col int32, *limbs), exact_ok)."""
    sr = a.sr
    device = a.device
    cap_a = a.capacity
    lc = l // c
    nslot = nb * lc
    num_sel = sel_rows.shape[0]

    bcols, bvals, chstart_b = _chunk_tables(b, c, ncc)

    # ---- per-A-entry maps (capacity-sized)
    valid_e = torch.arange(cap_a, device=device) < a.nnz
    acols = torch.clamp(a.col_idx.long(), 0, b.n_rows - 1)
    cnt_e = torch.where(valid_e, _chunk_counts(b, c)[acols], 0)
    cin_e = torch.cumsum(cnt_e, dim=0)
    start_e = cin_e - cnt_e                      # natural sub-entry starts
    shift_e = chstart_b[acols] - start_e         # chunk id = natural index + shift[e]
    # natural sub-entry -> entry (padded entries, all at the end, drop out;
    # an entry with no chunks repeats the next one's start)
    src_nat = segments.repeat_index(torch.where(valid_e, start_e, sg),
                                    torch.arange(cap_a, device=device), sg)
    srow = torch.cat([cin_e.new_zeros(1), cin_e])[a.row_ptr.long()[:-1]]

    # ---- per-slot maps (nslot-sized)
    sel = sel_rows.long()
    st = starts_slot.long()
    q = segments.repeat_index(st, torch.arange(num_sel, device=device), nslot)
    qs = torch.clamp(q, 0, num_sel - 1)
    # one (num_sel, 4) row gather: row, natural delta, start slot, rc
    sp = torch.stack([sel, srow[sel] - st, st, rc.long()[sel]], dim=1)[qs]
    r = sp[:, 0]
    slot = torch.arange(nslot, device=device)
    gnat = torch.clamp(sp[:, 1] + slot, 0, sg - 1)
    ok_slot = (q >= 0) & (slot - sp[:, 2] < sp[:, 3])
    e = torch.clamp(src_nat[gnat], 0, cap_a - 1)
    chunk_id = torch.clamp(gnat + shift_e[e], 0, ncc - 1)

    # ---- expansion: one row gather of a chunk per slot
    bc = bcols[chunk_id]
    ok = ok_slot[:, None] & (bc >= 0)
    key = torch.where(ok, (r[:, None] << 32) | bc.long(), _KEY_SENTINEL)
    if narrow:
        v = (torch.where(ok, a.values[0][e][:, None] * bvals[0][chunk_id], 0),)
    else:
        v = sr.mul(tuple(x[e][:, None] for x in a.values),
                   tuple(x[chunk_id] for x in bvals))
        v = tuple(torch.where(ok, limb, torch.zeros((), dtype=limb.dtype, device=device))
                  for limb in v)

    # ---- batched sort by the (row, col) key + lane merge
    key_s, perm = torch.sort(key.view(nb, l), dim=1, stable=True)
    limbs_s = tuple(torch.gather(x.view(nb, l), 1, perm) for x in v)
    prev = torch.cat([key_s.new_full((nb, 1), -1), key_s[:, :-1]], dim=1)
    head = key_s != prev
    totals, exact_ok = segments.segment_reduce_sorted(sr, head, limbs_s, axis=1)
    tail = torch.cat([head[:, 1:], head.new_ones((nb, 1))], dim=1)
    keep = tail & (key_s != _KEY_SENTINEL) & ~sr.is_zero(totals)

    # ---- pack: a stable partition of each block, survivors first
    keep_i = keep.long()
    rank = torch.cumsum(keep_i, dim=1) - keep_i
    sb = keep_i.sum(dim=1)
    lane = torch.arange(l, device=device)
    dest = (torch.where(keep, rank, sb[:, None] + lane - rank)
            + (torch.arange(nb, device=device) * l)[:, None]).view(-1)

    def packed(x):
        out = torch.empty(nb * l, dtype=x.dtype, device=device)
        out[dest] = x.reshape(-1)
        return out.view(nb, l)

    streams = (packed((key_s >> 32).int()), packed((key_s & 0xFFFFFFFF).int()),
               *(packed(x) for x in totals))
    offs = torch.cat([sb.new_zeros(1), torch.cumsum(sb, dim=0)]).int()
    return offs, streams, exact_ok


def _numeric(a: SparseCSR, b: SparseCSR, sel_rows: torch.Tensor,
             starts_slot: torch.Tensor, rc: torch.Tensor, c: int, l: int, nb: int,
             ncc: int, sg: int, out_cap: int, narrow: bool) -> SparseCSR:
    """One slab-ESC pass over the packed rows ``sel_rows``; the other rows
    get no entries (wide-row callers merge).  ``narrow``: u64 with
    max(A) * max(B) < 2^32 (checked by the caller) rides one limb through
    expansion and sort; the merge rebuilds the hi limb from the carries.
    Capacities come from the plan: no host synchronisation."""
    n, m = a.n_rows, b.n_cols
    offs, streams, exact_ok = _survivors(a, b, sel_rows, starts_slot, rc, c, l, nb, ncc,
                                         sg, narrow)
    fills = [n, INT32_SENTINEL] + [0] * (len(streams) - 2)
    orow, col_idx, *vals, _ = coalesce.coalesce_blocks(offs, streams, out_cap, fills)
    row_ptr = torch.searchsorted(
        orow, torch.arange(n + 1, dtype=torch.int32, device=a.device), side="left").int()
    nnz = offs[-1].long()
    return SparseCSR(row_ptr=row_ptr, col_idx=col_idx, values=tuple(vals),
                     nnz=torch.where((nnz <= out_cap) & exact_ok, nnz, -1),
                     n_rows=n, n_cols=m, sr_name=a.sr_name)


@dataclasses.dataclass(frozen=True)
class SlabPlan:
    """The host half of ``spgemm_slab``: one (sel_rows, starts_slot, lane,
    nb) pack per lane width (the narrow rows', then the wide rows' if any),
    the per-row sub-entry counts and the static sizes."""

    packs: Tuple[Tuple[torch.Tensor, torch.Tensor, int, int], ...]
    rc: torch.Tensor
    c: int
    ncc: int
    sg: int
    out_cap: int
    narrow: bool


def slab_config(a: SparseCSR, b: SparseCSR, out_cap: Optional[int] = None,
                L: int = DEFAULT_L, C: int = DEFAULT_C) -> SlabPlan:
    """Fetch the per-row sub-entry counts (one n-sized transfer; the narrow
    test fetches the operands' largest values) and pack the rows.  Raises
    ValueError where JAX's ``spgemm_slab`` does."""
    if a.n_cols != b.n_rows or a.sr_name != b.sr_name:
        raise ValueError(f"{a.shape} {a.sr_name} x {b.shape} {b.sr_name} do not chain")
    narrow = narrow_u64_ok(a, b)
    rc_dev, nch_total, sg_dev = plan_device(a, b, C)
    with obs.span("sync/slab_plan"):
        rc = rc_dev.cpu().numpy()
    ncc = max(obs.item(nch_total, "slab_plan"), 1)
    sg = pow2(max(obs.item(sg_dev, "slab_plan"), 1))
    total_chunks = int(rc.sum())
    if total_chunks * C >= 1 << 31:
        raise ValueError(f"expansion of {total_chunks * C} slots cannot be materialized")
    if out_cap is None:
        out_cap = pow2(max(min(symbolic_flops_exact(a, b), a.n_rows * b.n_cols), 1))
    lc = L // C
    wide = rc > lc
    lanes = [(~wide, L)]
    if wide.any():
        wmax = int(rc[wide].max()) * C
        if wmax > MAX_L:
            raise ValueError(f"row expands to {wmax} slots (> {MAX_L}); route to a "
                             "dense-accumulator path")
        lanes.append((wide, pow2(wmax)))
    packs = []
    for mask, lane in lanes:
        sel, starts, nb = pack_rows_ordered(np.where(mask, rc, 0), lane // C)
        if len(sel):
            packs.append((torch.from_numpy(sel).to(a.device),
                          torch.from_numpy(starts).to(a.device), lane, nb))
    return SlabPlan(tuple(packs), rc_dev, C, ncc, sg, out_cap, narrow)


def slab_numeric(a: SparseCSR, b: SparseCSR, plan: SlabPlan) -> SparseCSR:
    """Device half: one ``_numeric`` per pack, merged when there are two."""
    outs = [_numeric(a, b, sel, starts, plan.rc, plan.c, lane, nb, plan.ncc, plan.sg,
                     plan.out_cap, plan.narrow)
            for sel, starts, lane, nb in plan.packs]
    if not outs:
        return SparseCSR.empty(a.n_rows, b.n_cols, max(plan.out_cap, 1), a.sr, a.device)
    if len(outs) == 1:
        return outs[0]
    return merge_disjoint_rows(outs[0], outs[1], plan.out_cap)


def survivor_streams(a: SparseCSR, b: SparseCSR, plan: SlabPlan, pack: int = 0):
    """The (offs, streams) that pack ``pack`` of ``plan`` hands to the
    coalesce kernel: the real input of ``coalesce_blocks`` on this product."""
    sel, starts, lane, nb = plan.packs[pack]
    offs, streams, _ = _survivors(a, b, sel, starts, plan.rc, plan.c, lane, nb, plan.ncc,
                                  plan.sg, plan.narrow)
    return offs, streams


@obs.traced("product/slab")
def spgemm_slab(a: SparseCSR, b: SparseCSR, out_cap: Optional[int] = None,
                L: int = DEFAULT_L, C: int = DEFAULT_C) -> SparseCSR:
    """C = A x B by slab ESC: one n-sized fetch and the host packing, then
    one device pass per lane width (two when wide rows need a second).  A
    poisoned operand gives a poisoned result."""
    if obs.item(a.nnz, "nnz") < 0 or obs.item(b.nnz, "nnz") < 0:
        out = SparseCSR.empty(a.n_rows, b.n_cols, max(out_cap or 1, 1), a.sr, a.device)
        return dataclasses.replace(out, nnz=torch.full_like(out.nnz, -1))
    return slab_numeric(a, b, slab_config(a, b, out_cap, L, C))
