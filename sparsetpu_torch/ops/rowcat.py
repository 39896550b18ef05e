"""Row-categorized SpGEMM (the MAGNUS numeric phase): the port of
``sparsetpu/ops/rowcat.py``.

C = A x B in three phases, as in the JAX package:

  1. ``plan`` (on the device): the product count fr[i] of every row, its
     category by the power-of-two ``THRESHOLDS``, a stable row permutation by
     category, and a (n_cats, 2) table of (rows, products) per category;
     ``rowcat_config`` fetches that table, the one host synchronisation, to
     size the slabs.
  2. per category (``numeric_cat``): the category's products gathered
     straight into an (Rp, L) padded slab (``expand_cat``), then every row
     sorted by column, merged with the semiring's saturating add and packed:
     through the sort-merge kernel (``kernels/sortmerge.py``) where it takes
     L, else JAX's batched formulation (a sort along the rows, the lane-axis
     segmented scan, a second sort to pack).  Rows past the last threshold
     take the ESC expansion restricted to them (``_esc_rows``) and are merged
     in with ``spadd``.
  3. ``assemble``: row_ptr from the per-row counts and one gather per array
     from the concatenated slabs.

Differences from the JAX package:

- One eager path.  JAX's ``FUSE_MAX_CAP``, ``_rowcat_unfused`` and the
  ``fused=`` switch existed because the remote TPU compiler choked on large
  fused programs.
- ``use_kernel=True`` is the default: JAX's default ``use_pallas=False`` was
  chosen for the Mosaic compile cost, which the GPU does not have.  The route
  of each category is decided by its shape before launch
  (``kernel_route``): the kernel takes L up to 16,384, beyond JAX's 2,048;
  the 65,536 category takes the batched route.  ``use_kernel=False`` runs
  JAX's batched formulation at every L (the sweep's ``rowcat`` row).
- Zero-count entries of A keep their place in the expansion stream's starts
  (``segments.repeat_index`` needs them non-decreasing), where JAX drops
  them; the slots that differ are masked either way.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..csr import SparseCSR
from ..kernels import sortmerge
from . import segments
from .segments import INT32_SENTINEL
from .spgemm import expand_products, pow2, row_flops, shared_stream, spadd

# powers of two: the most products a row of each category may hold
THRESHOLDS = (64, 256, 1024, 4096, 16384, 65536)
N_CATS = len(THRESHOLDS) + 1  # the last is the overflow category


def plan(a: SparseCSR, b: SparseCSR):
    """Categorization on the device: (fr, cat, perm, stats), where fr is the
    product count of every row, cat its category, perm the rows stably
    sorted by category, and stats[c] = (rows, products) of category c."""
    fr = row_flops(a, b)
    ths = torch.tensor(THRESHOLDS, dtype=torch.int64, device=a.device)
    cat = torch.searchsorted(ths, fr, side="left")
    perm = torch.argsort(cat, stable=True)
    onehot = cat[None, :] == torch.arange(N_CATS, device=a.device)[:, None]
    rows_per = onehot.sum(dim=1)
    flops_per = torch.where(onehot, fr[None, :], 0).sum(dim=1)
    return fr, cat, perm, torch.stack([rows_per, flops_per], dim=1)


def expand_cat(a: SparseCSR, b: SparseCSR, rows: torch.Tensor, fr: torch.Tensor,
               L: int, shared):
    """The products of the rows ``rows`` (global ids; n_rows marks padding)
    gathered straight into an (Rp, L) slab: (cols int32, limbs), slot (r, l)
    holding row r's l-th product, or (INT32_SENTINEL, 0) past its count."""
    sr = a.sr
    n = a.n_rows
    cin0, src, shift, _ = shared
    cap_g = src.shape[0]
    rsafe = torch.clamp(rows, 0, n - 1)
    off_r = cin0[a.row_ptr.long()[rsafe]]
    fr_sel = torch.where(rows < n, fr[rsafe], 0)
    lane = torch.arange(L, device=a.device)
    ok = lane[None, :] < fr_sel[:, None]
    slot = torch.clamp(off_r[:, None] + lane[None, :], 0, cap_g - 1)
    e = torch.clamp(src[slot], 0, a.capacity - 1)
    b_pos = torch.clamp(slot + shift[e], 0, b.capacity - 1)
    cols = torch.where(ok, b.col_idx[b_pos], INT32_SENTINEL)
    v = sr.mul(sr.gather(a.values, e), sr.gather(b.values, b_pos))
    return cols, sr.where(ok, v, sr.zeros(ok.shape, device=a.device))


def category_rows(perm: torch.Tensor, n: int, rows_pad: int, rows: int,
                  offset: int) -> torch.Tensor:
    """The global rows of one category of ``rowcat_config`` (its entry
    (L, rows_pad, rows, offset)), padded with n (no row) to rows_pad."""
    return torch.cat([perm[offset:offset + rows], perm.new_full((rows_pad - rows,), n)])


def kernel_route(L: int, nlimbs: int, use_kernel: bool) -> bool:
    """True when a category of row length L goes through
    ``sortmerge.sortmerge_rows`` (the kernel on a CUDA device)."""
    return use_kernel and sortmerge.available(L, nlimbs)


def numeric_cat(a: SparseCSR, b: SparseCSR, rows: torch.Tensor, fr: torch.Tensor,
                L: int, shared, use_kernel: bool = True):
    """One category: expand into the (Rp, L) slab, then sort, merge and pack
    every row.  Returns (cols (Rp, L), limbs (Rp, L), nr (Rp,)), nr the
    survivors per row, -1 everywhere when the shared stream overflowed."""
    sr = a.sr
    cols, limbs = expand_cat(a, b, rows, fr, L, shared)
    if kernel_route(L, sr.nlimbs, use_kernel):
        cols, limbs = sortmerge.sortmerge_rows(cols, limbs, sr.name)
    else:
        cols, limbs = sortmerge.sortmerge_rows_reference(cols, limbs, sr.name)
    nr = (cols != INT32_SENTINEL).sum(dim=1)
    return cols, limbs, torch.where(shared[3], nr, -1)


def assemble(cols_concat: torch.Tensor, limbs_concat, base_of_row: torch.Tensor,
             nr_full: torch.Tensor, out_cap: int, n_rows: int, n_cols: int,
             sr_name: str) -> SparseCSR:
    """The CSR from the concatenated slabs: row_ptr from the per-row counts
    (a -1 count poisons the result), then one gather per array at
    base_of_row[r] + k (every slab row holds its survivors packed and
    column-sorted)."""
    device = cols_concat.device
    row_ptr = torch.cat([nr_full.new_zeros(1),
                         torch.cumsum(torch.clamp(nr_full, min=0), dim=0)])
    nnz = row_ptr[-1]
    s = torch.arange(out_cap, device=device)
    r = segments.repeat_index(row_ptr[:-1], torch.arange(n_rows, device=device), out_cap)
    in_range = s < nnz
    rsafe = torch.clamp(r, 0, n_rows - 1)
    src = torch.clamp(base_of_row[rsafe] + s - row_ptr[rsafe], 0, cols_concat.shape[0] - 1)
    col_idx = torch.where(in_range, cols_concat[src], INT32_SENTINEL)
    vals = tuple(torch.where(in_range, lb[src], 0) for lb in limbs_concat)
    ok = (nnz <= out_cap) & (nr_full >= 0).all()
    return SparseCSR(row_ptr=row_ptr.int(), col_idx=col_idx, values=vals,
                     nnz=torch.where(ok, nnz, -1), n_rows=n_rows, n_cols=n_cols,
                     sr_name=sr_name)


def _esc_rows(a: SparseCSR, b: SparseCSR, row_mask: torch.Tensor, cap: int,
              out_cap: int) -> SparseCSR:
    """ESC restricted to the rows where ``row_mask`` is True: the kernel of
    the overflow category (rows past every slab threshold)."""
    i, j, v, valid, total = expand_products(a, b, cap, row_mask=row_mask)
    c = SparseCSR.from_coo_device(i, j, v, a.n_rows, b.n_cols, a.sr, out_cap, valid=valid)
    return dataclasses.replace(c, nnz=torch.where(total <= cap, c.nnz, -1))


def rowcat_config(a: SparseCSR, b: SparseCSR, out_cap: Optional[int] = None):
    """Host half: ``plan``, one fetch of its (n_cats, 2) stats table, and the
    shapes.  Returns (fr, cat, perm, cats, of_cap, cap_g, out_cap), where
    cats holds (L, rows_pad, rows, offset) per non-empty category, of_cap is
    the overflow rows' expansion capacity (0 when there are none) and cap_g
    the shared stream's.  Raises ValueError past 2^31 products."""
    fr, cat, perm, stats = plan(a, b)
    with obs.span("sync/row_stats"):
        stats_h = stats.cpu().numpy().astype(np.int64)
    rows_per, flops_per = stats_h[:, 0], stats_h[:, 1]
    of_cap = 0
    if rows_per[-1] > 0:
        of_flops = int(flops_per[-1])
        if of_flops >= 1 << 31:
            raise ValueError(f"overflow rows expand to {of_flops} products; "
                             "use a dense-accumulator chain for this product")
        of_cap = pow2(of_flops)
    if int(flops_per.sum()) >= 1 << 31:
        raise ValueError(f"expansion of {int(flops_per.sum())} products too large")
    offsets = np.concatenate([[0], np.cumsum(rows_per)])
    cats = tuple((THRESHOLDS[c], max(pow2(rows_per[c]), 8), int(rows_per[c]),
                  int(offsets[c]))
                 for c in range(N_CATS - 1) if rows_per[c] > 0)
    # the shared product stream spans every row, the overflow rows included
    cap_g = pow2(int(flops_per.sum()))
    cap = out_cap or pow2(int(flops_per[:-1].sum()))
    return fr, cat, perm, cats, of_cap, cap_g, cap


def rowcat_numeric(a: SparseCSR, b: SparseCSR, fr, cat, perm, cats, of_cap: int,
                   cap_g: int, out_cap: int, use_kernel: bool = True) -> SparseCSR:
    """Device half: every category's numeric pass, the overflow rows' ESC and
    the assembly, with no host synchronisation."""
    sr = a.sr
    n = a.n_rows
    device = a.device
    overflow = None
    if of_cap > 0:
        overflow = _esc_rows(a, b, cat == N_CATS - 1, of_cap, of_cap)
    if not cats:
        if overflow is not None:
            return overflow
        return SparseCSR.empty(n, b.n_cols, max(out_cap, 1), sr, device)

    shared = shared_stream(a, b, cap_g)
    slab_cols: List[torch.Tensor] = []
    slab_limbs: List[Tuple[torch.Tensor, ...]] = []
    base_of_row = torch.zeros(n + 1, dtype=torch.int64, device=device)
    nr_full = torch.zeros(n + 1, dtype=torch.int64, device=device)
    base = 0
    for L, rp, r, off in cats:
        rows = category_rows(perm, n, rp, r, off)
        cols, limbs, nr = numeric_cat(a, b, rows, fr, L, shared, use_kernel)
        slab_cols.append(cols.reshape(-1))
        slab_limbs.append(tuple(x.reshape(-1) for x in limbs))
        base_of_row[rows] = base + torch.arange(rp, device=device) * L
        nr_full[rows] = nr
        base += rp * L
    result = assemble(torch.cat(slab_cols),
                      tuple(torch.cat([s[k] for s in slab_limbs]) for k in range(sr.nlimbs)),
                      base_of_row[:n], nr_full[:n], out_cap, n, b.n_cols, sr.name)
    if overflow is None:
        return result
    merged_cap = result.capacity + overflow.capacity
    poisoned = (result.nnz < 0) | (overflow.nnz < 0)
    merged = spadd(result.with_capacity(merged_cap), overflow.with_capacity(merged_cap),
                   out_cap=merged_cap)
    # spadd reads a poisoned operand as empty: poison the sum again
    return dataclasses.replace(merged, nnz=torch.where(poisoned, -1, merged.nnz))


@obs.traced("product/rowcat")
def spgemm_rowcat(a: SparseCSR, b: SparseCSR, out_cap: Optional[int] = None,
                  use_kernel: bool = True) -> SparseCSR:
    """C = A x B by row categorization: one host fetch of the category table
    (``rowcat_config``), then the numeric phase (``rowcat_numeric``).
    ``use_kernel``: route every category whose L the sort-merge kernel takes
    through it (the kernel on CUDA, its plain version on the CPU); False runs
    JAX's batched formulation everywhere."""
    if a.n_cols != b.n_rows:
        raise ValueError(f"shapes {a.shape} x {b.shape} do not chain")
    return rowcat_numeric(a, b, *rowcat_config(a, b, out_cap), use_kernel=use_kernel)


def category_routes(a: SparseCSR, cats, use_kernel: bool = True) -> List[Tuple[int, int, str]]:
    """(L, rows, route) per non-empty slab category of ``rowcat_config``:
    route "sortmerge_rows" (the kernel on a CUDA device) or "batched"."""
    return [(L, r, "sortmerge_rows" if kernel_route(L, a.sr.nlimbs, use_kernel) else "batched")
            for L, _, r, _ in cats]
