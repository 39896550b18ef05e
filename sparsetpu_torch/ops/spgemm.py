"""ESC SpGEMM and SpAdd on the exact semirings: the counterpart of the ESC
part of ``sparsetpu/ops/spgemm.py``.

C = A x B by expand-sort-compress, in plain PyTorch tensor ops:

  1. *symbolic*: flops(A, B) = sum over the entries (i, k) of A of
     row_nnz_B[k], the exact expansion size and a bound on nnz(C);
  2. *expand*: every partial product (i, j, a_ik (x) b_kj) as flat streams of
     a fixed ``expand_cap``;
  3. *compress*: sort by (i, j) and merge duplicates with the semiring's add
     (``SparseCSR.from_coo_device``).

No step synchronises with the host, so a product on the GPU is one stream of
launches.  An expansion larger than ``expand_cap`` poisons nnz to -1.

``spgemm_auto`` is the public SpGEMM entry point: it counts the products on
the host and routes to one of the ported kernels (dense-dense tiers, ESC,
the slab, column-chunk, dense-accumulator and row-categorized SpGEMMs) by
the JAX package's rule, with its TPU-measured constants unchanged
(``auto_route``); re-deriving them for an 80 GB card is a ROADMAP item.
Where JAX catches the TPU's ``RESOURCE_EXHAUSTED`` the port catches
``torch.cuda.OutOfMemoryError``, and its colchunk fallback also catches it
(JAX's catches ``ValueError`` only).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from .. import obs
from ..csr import SparseCSR
from . import segments
from .segments import INT32_SENTINEL


def pow2(x: int) -> int:
    """The least power of two >= x (1 for x <= 1): a static capacity."""
    return 1 << (max(int(x), 1) - 1).bit_length()


def entry_counts(a: SparseCSR, b: SparseCSR):
    """(valid slots of A, their clamped columns, the row_nnz of B at them)."""
    valid = torch.arange(a.capacity, device=a.device) < a.nnz
    cols = torch.clamp(a.col_idx.long(), 0, b.n_rows - 1)
    counts = torch.where(valid, b.row_nnz().long()[cols], 0)
    return valid, cols, counts


def row_flops(a: SparseCSR, b: SparseCSR) -> torch.Tensor:
    """fr[i] = the number of partial products row i of A x B expands to."""
    _, _, counts = entry_counts(a, b)
    cin0 = torch.cat([counts.new_zeros(1), torch.cumsum(counts, dim=0)])
    row_ptr = a.row_ptr.long()
    return cin0[row_ptr[1:]] - cin0[row_ptr[:-1]]


def shared_stream(a: SparseCSR, b: SparseCSR, cap_g: int):
    """The natural expansion stream of A x B that the row-categorized and
    blocked SpGEMMs gather from: (cin0, src, shift, ok), where cin0 is the
    exclusive running product count over A's entries, src maps each of the
    ``cap_g`` stream slots to its entry of A, shift[e] moves a slot of entry
    e to its entry of B, and ok is False when the products exceed ``cap_g``."""
    valid_e, a_cols, counts = entry_counts(a, b)
    cincl = torch.cumsum(counts, dim=0)
    first = cincl - counts
    cin0 = torch.cat([counts.new_zeros(1), cincl])
    starts = torch.where(valid_e, first, cap_g)
    src = segments.repeat_index(starts, torch.arange(a.capacity, device=a.device), cap_g)
    shift = b.row_ptr.long()[a_cols] - first
    return cin0, src, shift, cincl[-1] <= cap_g


def symbolic_flops(a: SparseCSR, b: SparseCSR) -> torch.Tensor:
    """Number of partial products in A x B (an upper bound on nnz(C)), as an
    int64 device scalar: exact at any count, so the JAX package's chunked
    ``symbolic_flops_exact`` reduces to reading it."""
    return entry_counts(a, b)[2].sum()


def symbolic_flops_exact(a: SparseCSR, b: SparseCSR) -> int:
    """The flop count on the host (one synchronisation)."""
    with obs.span("esc/symbolic"):
        return obs.item(symbolic_flops(a, b), "flops")


def max_value(a: SparseCSR) -> int:
    """Largest stored value on the host (one synchronisation); 0 for f32."""
    if a.sr_name == "f32" or a.capacity == 0:
        return 0
    valid = torch.arange(a.capacity, device=a.device) < a.nnz
    out = 0
    for k, limb in enumerate(a.values):
        out |= obs.item(torch.where(valid, limb, 0).max(), "max_value") << (32 * k)
    return out


def narrow_u64_ok(a: SparseCSR, b: SparseCSR) -> bool:
    """True when every partial product of u64 operands provably fits 32 bits,
    so the expansion may carry one limb (``expand_products(narrow=True)``)."""
    if a.sr_name != "u64" or b.sr_name != "u64":
        return False
    ma, mb = max_value(a), max_value(b)
    return ma < (1 << 32) and mb < (1 << 32) and ma * mb < (1 << 32)


@obs.traced("esc/expand")
def expand_products(a: SparseCSR, b: SparseCSR, expand_cap: int, narrow: bool = False,
                    row_mask: Optional[torch.Tensor] = None):
    """The partial-product streams (i, j, v, valid, total) of A x B, each of
    ``expand_cap`` slots; ``total`` is the true product count (a device
    scalar; the slots past it are invalid, the products past the capacity
    are lost).

    Slot t belongs to entry e of A with cum[e-1] <= t < cum[e] (found by
    ``segments.repeat_index``, no binary search) and reads entry
    t + (row_ptr_B[col_e] - cum[e-1]) of B.  ``narrow`` (u64 only; the caller
    has checked ``narrow_u64_ok``) carries the products in one limb.
    ``row_mask`` (bool[n_rows]) expands only the rows where it is True (the
    row-categorized SpGEMM's overflow rows, ``ops/rowcat.py``)."""
    if a.n_cols != b.n_rows:
        raise ValueError(f"shapes {a.shape} x {b.shape} do not chain")
    if expand_cap < 1:
        raise ValueError(f"expand_cap must be >= 1, got {expand_cap}")
    if narrow and a.sr_name != "u64":
        raise ValueError(f"narrow expansion is for u64, not {a.sr_name}")
    sr = a.sr
    device = a.device
    valid_a, a_cols, counts = entry_counts(a, b)
    a_rows = a.row_of_slot()
    if row_mask is not None:
        counts = torch.where(torch.cat([row_mask, row_mask.new_zeros(1)])[a_rows], counts, 0)
    cum = torch.cumsum(counts, dim=0)
    first = cum - counts
    total = cum[-1]
    t = torch.arange(expand_cap, device=device)
    # padded slots of A drop out; an entry with no products repeats the next
    # entry's start and so covers no slot
    starts = torch.where(valid_a, first, expand_cap)
    src = segments.repeat_index(starts, torch.arange(a.capacity, device=device),
                                expand_cap)
    valid = t < total
    src = torch.clamp(src, 0, a.capacity - 1)
    shift = b.row_ptr.long()[a_cols] - first
    b_pos = torch.clamp(t + shift[src], 0, b.capacity - 1)
    i = torch.where(valid, a_rows[src], a.n_rows)
    j = torch.where(valid, b.col_idx[b_pos], INT32_SENTINEL)
    if narrow:
        v = (torch.where(valid, a.values[0][src] * b.values[0][b_pos], 0),)
    else:
        v = sr.mul(sr.gather(a.values, src), sr.gather(b.values, b_pos))
        v = sr.where(valid, v, sr.zeros((expand_cap,), device=device))
    return i, j, v, valid, total


@obs.traced("product/esc")
def spgemm(a: SparseCSR, b: SparseCSR, expand_cap: int,
           out_cap: Optional[int] = None, narrow: bool = False) -> SparseCSR:
    """C = A x B on the semiring.  ``expand_cap`` must be >= flops(A, B)
    (:func:`symbolic_flops`), else nnz is poisoned to -1; ``out_cap``
    defaults to ``expand_cap``.  ``narrow``: see :func:`expand_products`."""
    out_cap = out_cap or expand_cap
    i, j, v, valid, total = expand_products(a, b, expand_cap, narrow=narrow)
    c = SparseCSR.from_coo_device(i, j, v, a.n_rows, b.n_cols, a.sr, out_cap,
                                  valid=valid)
    # an expansion past expand_cap lost products: poison, so check() raises
    return dataclasses.replace(c, nnz=torch.where(total <= expand_cap, c.nnz, -1))


def spadd(a: SparseCSR, b: SparseCSR, out_cap: Optional[int] = None) -> SparseCSR:
    """C = A (+) B elementwise with the semiring's (saturating) add."""
    if a.shape != b.shape or a.sr_name != b.sr_name:
        raise ValueError(f"spadd needs equal shapes and semirings, got "
                         f"{a.shape} {a.sr_name} and {b.shape} {b.sr_name}")
    out_cap = out_cap or (a.capacity + b.capacity)
    device = a.device
    valid = torch.cat([torch.arange(a.capacity, device=device) < a.nnz,
                       torch.arange(b.capacity, device=device) < b.nnz])
    rows = torch.cat([a.row_of_slot(), b.row_of_slot()])
    cols = torch.cat([a.col_idx, b.col_idx])
    vals = tuple(torch.cat([x, y]) for x, y in zip(a.values, b.values))
    return SparseCSR.from_coo_device(rows, cols, vals, a.n_rows, a.n_cols, a.sr,
                                     out_cap, valid=valid)


def dense_acc_panel_cols(n_rows: int, budget_bytes: float = 6e9) -> int:
    """Widest column panel (a multiple of 1024, at most 8192) such that the
    tiled dense accumulator's peak panel footprint, ~4 live (n_rows, w) f32
    arrays, fits the memory budget; 0 when a 1024-wide panel does not fit
    (JAX's arithmetic and budget, unchanged)."""
    w = int(budget_bytes // (16 * max(n_rows, 1))) // 1024 * 1024
    return min(w, 8192)


def auto_route(a: SparseCSR, b: SparseCSR, flops: int) -> Tuple[List[bool], str]:
    """``spgemm_auto``'s route for kernel="auto", on the host, with JAX's
    constants (measured on a TPU v5e).  Returns (the dense-dense tiers to
    try first, in order: False the f32 tier, True the wide integer tier;
    the route to take when none is tried or each poisons).

    Dense-dense is tried when both densified operands fit
    (``densedense_fits``) and its modelled time undercuts ESC's; its f32
    tier only when both inputs are < 2^16 (the max values are read only
    then).  Otherwise: "esc" up to 2^19 products, else the cheapest of
    colchunk (~90 ns a product, up to 2^28), denseacc (~9 ns a frame
    element, while B and C dense fit 6e9 bytes) and denseacc_tiled (~4.3
    ns an element, when they do not), and "rowcat" when none fits."""
    from .denseacc import densedense_fits

    n, k, m = a.n_rows, a.n_cols, b.n_cols
    tiers: List[bool] = []
    if densedense_fits(n, k, m):
        t_dd = (1e-3 + 0.2e-9 * (n * k + k * m + 3 * n * m) + 2.0 * n * k * m / 4.5e13
                + 16e-9 * min(flops, n * m))
        t_esc = 2e-3 + flops * 110e-9
        if t_dd < t_esc:
            amax, bmax = max_value(a), max_value(b)
            if a.sr_name == "f32" or (amax < (1 << 16) and bmax < (1 << 16)):
                tiers.append(False)
            if a.sr_name in ("u32", "u64"):
                tiers.append(True)
    if flops <= (1 << 19):
        return tiers, "esc"
    padded_cols = -(-m // 1024) * 1024
    fits = n * padded_cols * 4 * 2 <= 6e9
    w = dense_acc_panel_cols(n)
    t_cc = 5e-3 + flops * 90e-9 if flops <= (1 << 28) else float("inf")
    t_dacc = n * padded_cols * 9e-9 if fits else float("inf")
    t_tiled = n * padded_cols * 4.3e-9 if (w and not fits) else float("inf")
    if min(t_dacc, t_tiled) < t_cc:
        return tiers, "denseacc" if t_dacc <= t_tiled else "denseacc_tiled"
    return tiers, "rowcat" if t_cc == float("inf") else "colchunk"


KERNELS = ("auto", "esc", "rowcat", "denseacc", "denseacc_tiled", "densedense", "colchunk",
           "slab", "escb")
AUTO_SPANS = {k: f"product/auto/{k}" for k in KERNELS[1:]}  # spgemm_auto's span by route


def spgemm_auto(a: SparseCSR, b: SparseCSR, round_to_pow2: bool = True,
                kernel: str = "auto") -> SparseCSR:
    """C = A x B routed on the host, as the JAX package's ``spgemm_auto``:
    the exact product count, then ``auto_route``'s dense-dense tiers (a
    tier that poisons, or runs out of card memory, passes to the next) and
    route, and each route's fallback: denseacc and denseacc_tiled fall back
    to rowcat when a value is too wide for the f32 carrier; colchunk, when
    it poisons or runs out of memory, to the panel sweep where a panel fits,
    else to rowcat.  ``kernel`` forces a route (``KERNELS``).  A product of
    2^31 or more partial products raises ValueError on the routes that
    materialise the expansion (esc, rowcat).  Returns the checked product
    (``check()`` raises on a poisoned one).  Under a profiler its span is
    ``product/auto/<route>``, the route tried first (``obs``)."""
    if a.n_cols != b.n_rows or a.sr_name != b.sr_name:
        raise ValueError(f"{a.shape} {a.sr_name} x {b.shape} {b.sr_name} do not chain")
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}; have {KERNELS}")
    flops = symbolic_flops_exact(a, b)
    tiers: List[bool] = []
    if kernel == "auto":
        tiers, kernel = auto_route(a, b, flops)
    with obs.span(AUTO_SPANS["densedense" if tiers else kernel]):
        return _routed(a, b, flops, tiers, kernel, round_to_pow2)


def _routed(a: SparseCSR, b: SparseCSR, flops: int, tiers: List[bool], kernel: str,
            round_to_pow2: bool) -> SparseCSR:
    """``spgemm_auto``'s product on its route: the dense-dense ``tiers``
    first, then ``kernel`` and its fallbacks."""
    from . import colchunk, denseacc, escb, rowcat, slab

    out_cap = pow2(min(flops, a.n_rows * b.n_cols))
    for wide in tiers:
        try:
            return denseacc.spgemm_dense_dense(a, b, out_cap=out_cap, wide=wide).check()
        except ValueError:
            pass  # the on-device range check poisoned: the next tier
        except torch.cuda.OutOfMemoryError:
            torch.cuda.empty_cache()  # JAX: RESOURCE_EXHAUSTED -> the sort paths
    if flops >= 1 << 31 and kernel in ("esc", "rowcat"):
        raise ValueError(f"spgemm expansion of {flops} products cannot be materialized "
                         "(int32 indexing); split the product or use a dense path")
    if kernel == "densedense":
        return denseacc.spgemm_dense_dense(a, b).check()
    if kernel in ("denseacc", "denseacc_tiled"):
        try:
            if kernel == "denseacc_tiled":
                return denseacc.spgemm_dense_acc_tiled(
                    a, b, panel_cols=dense_acc_panel_cols(a.n_rows)).check()
            return denseacc.spgemm_dense_acc(a, b).check()
        except ValueError:
            kernel = "rowcat"  # the value range is too wide for the f32 carrier
    if kernel == "colchunk":
        try:
            return colchunk.spgemm_colchunk(a, b).check()
        except (ValueError, torch.cuda.OutOfMemoryError):
            # a hub row too wide for the slab's wide pass, a poisoned chunk,
            # or the card's memory: the panel sweep where a panel fits
            torch.cuda.empty_cache()
            w = dense_acc_panel_cols(a.n_rows)
            if w:
                return denseacc.spgemm_dense_acc_tiled(a, b, panel_cols=w).check()
            kernel = "rowcat"
    if kernel == "rowcat":
        return rowcat.spgemm_rowcat(a, b).check()
    if kernel == "slab":
        return slab.spgemm_slab(a, b, out_cap=out_cap).check()
    if kernel == "escb":
        return escb.spgemm_blocked(a, b, out_cap=out_cap).check()
    cap = max(flops, 1)
    if round_to_pow2:
        cap = pow2(cap)
    return spgemm(a, b, expand_cap=cap, narrow=narrow_u64_ok(a, b)).check()
