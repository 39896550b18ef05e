"""MAGNUS-style column-chunked SpGEMM: the port of ``sparsetpu/ops/colchunk.py``.

For products whose slab expansion exceeds one pass's budget, the partial
products are cut into contiguous column chunks of B and accumulated one chunk
at a time with the slab ESC program (``ops/slab.py``):

  1. *plan*: the exact product count of every output column (``_col_flops``)
     -> a host prefix sum -> K contiguous column ranges of about equal
     product mass, each sized so that its padded slab expansion fits
     ``slot_budget`` (``plan_chunks``);
  2. *reorder*: B's entries in (chunk, row, col) order with a (K, n + 1)
     table of per-chunk row offsets, so B restricted to a chunk is a
     contiguous slice (``_reorder_b``, ``_slice_chunk``);
  3. *accumulate*: per chunk, the slab program (``slab_config`` +
     ``slab_numeric``, with its wide-row pass where rows overfill a block);
  4. *concatenate*: the chunks interleaved row by row (``_scatter_chunk``);
     chunks partition the columns in order, so each output row stays
     column-sorted.

Differences from the JAX package, and why:

- The per-column product counts are int64 (JAX's are int32, which wraps
  once a column meets 2^31 products).
- B is already in (row, col) order, so its (chunk, row, col) order is one
  stable sort by chunk, not a three-key sort.
- The chunk slices start at host offsets (the plan fetches them); the
  stream is still padded by one slice's length, so no slice runs short.
- Each chunk gets a slab plan of its own sizes, where JAX pads every chunk
  to one set of sizes so that its compiled program is reused; PyTorch
  compiles nothing, and each chunk's CSR is cut to its nnz anyway, so the
  output is the same.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..csr import SparseCSR
from . import segments, slab
from .segments import INT32_SENTINEL
from .spgemm import pow2

DEFAULT_SLOT_BUDGET = 1 << 26  # slab slots a chunk


def _scatter_count(index: torch.Tensor, valid: torch.Tensor, size: int,
                   weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[j] = the sum of ``weights`` (1 by default) over the valid slots
    whose index is j, int64[size]; each invalid slot adds into a dump slot of
    its own, so no atomic add waits on another at one address."""
    n = index.shape[0]
    slots = torch.arange(n, device=index.device)
    w = torch.ones(n, dtype=torch.int64, device=index.device) if weights is None else weights
    out = torch.zeros(size + n, dtype=torch.int64, device=index.device)
    out.index_add_(0, torch.where(valid, index.long(), size + slots), w.long())
    return out[:size]


def _col_flops(a: SparseCSR, b: SparseCSR) -> torch.Tensor:
    """fcol[j] = the exact number of partial products landing in output
    column j: over B's entries (k, j), the count of A's entries in column k.
    int64 throughout."""
    valid_a = torch.arange(a.capacity, device=a.device) < a.nnz
    wa = _scatter_count(torch.clamp(a.col_idx.long(), 0, b.n_rows - 1), valid_a, b.n_rows)
    valid_b = torch.arange(b.capacity, device=b.device) < b.nnz
    brow = torch.clamp(b.row_of_slot(), 0, b.n_rows - 1)
    bcol = torch.clamp(b.col_idx.long(), 0, b.n_cols - 1)
    return _scatter_count(bcol, valid_b, b.n_cols, wa[brow])


def plan_chunks(a: SparseCSR, b: SparseCSR, slot_budget: int = DEFAULT_SLOT_BUDGET,
                c: int = slab.DEFAULT_C) -> Tuple[np.ndarray, np.ndarray]:
    """Cut B's columns into contiguous ranges of about equal product mass.

    Returns (boundaries int64[K + 1], flops_per_chunk int64[K]).  The slot
    budget is discounted by the worst-case padding of the (A entry, chunk)
    pairs (each wastes fewer than c slots), so a chunk's padded slab
    expansion provably fits."""
    with obs.span("sync/col_flops"):
        fcol = _col_flops(a, b).cpu().numpy()
    cum = np.concatenate([[0], np.cumsum(fcol)])
    total = int(cum[-1])
    pad_bound = c * max(obs.item(a.nnz, "nnz"), 1)
    eff = max(slot_budget - pad_bound, slot_budget // 4)
    k = max(-(-total // eff), 1)
    targets = (np.arange(1, k) * total) // k
    cuts = np.searchsorted(cum, targets, side="left")
    boundaries = np.unique(np.concatenate([[0], cuts, [b.n_cols]]).astype(np.int64))
    return boundaries, cum[boundaries[1:]] - cum[boundaries[:-1]]


def _reorder_b(b: SparseCSR, bnd: torch.Tensor, k: int):
    """B's entries in (chunk, row, col) order, with local column indices;
    also the per-chunk entry starts (int64[k + 1]) and the (k, n_rows + 1)
    per-chunk row offsets (int32)."""
    m, n = b.n_cols, b.n_rows
    device = b.device
    valid = torch.arange(b.capacity, device=device) < b.nnz
    chunk_of_col = segments.repeat_index(bnd[:-1], torch.arange(k, device=device), m)
    colc = torch.clamp(b.col_idx.long(), 0, m - 1)
    ch = torch.where(valid, chunk_of_col[colc], k)
    row = torch.where(valid, b.row_of_slot(), n)
    col_local = torch.where(valid, colc - bnd[torch.clamp(ch, 0, k - 1)],
                            INT32_SENTINEL).int()
    # valid entries are in (row, col) order already: a stable sort by chunk
    # gives (chunk, row, col), padding (chunk k) last
    perm = torch.sort(ch, stable=True).indices
    counts = _scatter_count(ch, valid, k)
    starts = torch.cat([counts.new_zeros(1), torch.cumsum(counts, dim=0)])
    cnt2d = _scatter_count(ch * n + row, valid, k * n).view(k, n)
    rp2d = torch.cat([cnt2d.new_zeros((k, 1)), torch.cumsum(cnt2d, dim=1)], dim=1).int()
    return col_local[perm], tuple(v[perm] for v in b.values), starts, rp2d


def _slice_chunk(col_s: torch.Tensor, vals_s, start: int, cap_bc: int):
    return col_s[start:start + cap_bc], tuple(v[start:start + cap_bc] for v in vals_s)


def _scatter_chunk(out_col, out_vals, rp_k, col_k, vals_k, nnz_k, base_k, c0: int,
                   final_cap: int):
    """Write one chunk's output stream into the final arrays at
    base_k[row] + (slot - rp_k[row]), in place; padded slots go to dump slots
    past ``final_cap``."""
    n = rp_k.shape[0] - 1
    cap2 = col_k.shape[0]
    device = col_k.device
    s = torch.arange(cap2, device=device)
    rows = segments.repeat_index(rp_k[:-1].long(), torch.arange(n, device=device), cap2)
    rs = torch.clamp(rows, 0, n - 1)
    valid = (s < nnz_k) & (rows >= 0)
    dest = torch.where(valid, base_k[rs] + (s - rp_k.long()[rs]), final_cap + s)
    out_col[dest] = col_k + c0
    for ov, vk in zip(out_vals, vals_k):
        ov[dest] = vk


def _poisoned(n: int, m: int, sr, device) -> SparseCSR:
    out = SparseCSR.empty(n, m, 1, sr, device)
    return dataclasses.replace(out, nnz=torch.full_like(out.nnz, -1))


@obs.traced("product/colchunk")
def spgemm_colchunk(a: SparseCSR, b: SparseCSR, slot_budget: int = DEFAULT_SLOT_BUDGET,
                    c: int = slab.DEFAULT_C, l: int = slab.DEFAULT_L) -> SparseCSR:
    """C = A x B with the partial products cut into column chunks, each run
    through the slab program; the outputs are interleaved row by row.  A
    poisoned operand or chunk poisons the result (nnz -1); a row too wide
    for the wide pass raises ValueError."""
    if a.n_cols != b.n_rows or a.sr_name != b.sr_name:
        raise ValueError(f"{a.shape} {a.sr_name} x {b.shape} {b.sr_name} do not chain")
    n = a.n_rows
    device = a.device
    if obs.item(a.nnz, "nnz") < 0 or obs.item(b.nnz, "nnz") < 0:
        return _poisoned(n, b.n_cols, a.sr, device)

    boundaries, flops_k = plan_chunks(a, b, slot_budget, c)
    k = len(boundaries) - 1
    if k == 1:
        return slab.spgemm_slab(a, b, L=l, C=c)

    # ---- reorder B once; the chunk slices share one capacity
    col_s, vals_s, starts, rp2d = _reorder_b(b, torch.from_numpy(boundaries).to(device), k)
    with obs.span("sync/chunk_starts"):
        starts_h = starts.cpu().numpy()
    cap_bc = pow2(max(int((starts_h[1:] - starts_h[:-1]).max()), 1))
    # pad the stream by one slice, so that a late chunk's slice never runs
    # short (JAX's dynamic_slice would clamp its start instead)
    col_s = torch.cat([col_s, col_s.new_full((cap_bc,), INT32_SENTINEL)])
    vals_s = tuple(torch.cat([v, v.new_zeros(cap_bc)]) for v in vals_s)
    w_pad = int((boundaries[1:] - boundaries[:-1]).max())

    # ---- run every chunk through the slab program, on its own plan
    results: List[Optional[SparseCSR]] = []
    for ki in range(k):
        if flops_k[ki] == 0:
            results.append(None)
            continue
        col_k, vals_k = _slice_chunk(col_s, vals_s, int(starts_h[ki]), cap_bc)
        b_k = SparseCSR(row_ptr=rp2d[ki], col_idx=col_k, values=vals_k,
                        nnz=starts[ki + 1] - starts[ki], n_rows=b.n_rows, n_cols=w_pad,
                        sr_name=b.sr_name)
        out_cap = pow2(int(min(flops_k[ki], n * w_pad)))
        c_k = slab.slab_numeric(a, b_k, slab.slab_config(a, b_k, out_cap, l, c))
        nnz_k = obs.item(c_k.nnz, "nnz")
        if nnz_k < 0:
            return _poisoned(n, b.n_cols, a.sr, device)
        cap2 = pow2(max(nnz_k, 1))
        results.append(SparseCSR(
            row_ptr=c_k.row_ptr, col_idx=c_k.col_idx[:cap2],
            values=tuple(v[:cap2] for v in c_k.values), nnz=c_k.nnz, n_rows=n,
            n_cols=b.n_cols, sr_name=a.sr_name))
    if all(r is None for r in results):
        return SparseCSR.empty(n, b.n_cols, 1, a.sr, device)

    # ---- merge: rows interleaved in chunk (= column) order
    live = [(ki, r) for ki, r in enumerate(results) if r is not None]
    if len(live) == 1:
        ki, r = live[0]
        # a single live chunk still needs its global column offset
        return dataclasses.replace(r, col_idx=torch.where(
            torch.arange(r.capacity, device=device) < r.nnz,
            r.col_idx + int(boundaries[ki]), INT32_SENTINEL).int())
    rn = torch.stack([r.row_nnz().long() for _, r in live])     # (#live, n)
    base_excl = torch.cumsum(rn, dim=0) - rn                      # exclusive over chunks
    row_ptr_final = torch.cat([rn.new_zeros(1), torch.cumsum(rn.sum(dim=0), dim=0)])
    total_nnz = sum(obs.item(r.nnz, "nnz") for _, r in live)
    final_cap = pow2(max(total_nnz, 1))
    dump = max(r.capacity for _, r in live)
    out_col = torch.full((final_cap + dump,), INT32_SENTINEL, dtype=torch.int32, device=device)
    out_vals = a.sr.zeros((final_cap + dump,), device=device)
    for li, (ki, r) in enumerate(live):
        _scatter_chunk(out_col, out_vals, r.row_ptr, r.col_idx, r.values, r.nnz,
                       row_ptr_final[:-1] + base_excl[li], int(boundaries[ki]), final_cap)
    return SparseCSR(row_ptr=row_ptr_final.int(), col_idx=out_col[:final_cap],
                     values=tuple(v[:final_cap] for v in out_vals),
                     nnz=torch.tensor(total_nnz, dtype=torch.int64, device=device),
                     n_rows=n, n_cols=b.n_cols, sr_name=a.sr_name)
