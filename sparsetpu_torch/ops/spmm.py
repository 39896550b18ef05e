"""Sparse x dense SpMM in plain PyTorch: the counterpart of ``sparsetpu/ops/spmm.py``.

C = A x P row-wise, for each entry (i, k, v) of A:  C[i, :] += v * P[k, :]
-- a gather of P rows by A's columns, scaled, and summed into A's rows
(``index_add_``).  This is XLA code in the JAX package, outside any Pallas
kernel, so it stays plain torch here; the hand-written dense-accumulator
kernel is ``kernels/spmm.py``.

- ``prepare_spmm_operand`` / ``spmm_dense``: A cut into row-contiguous chunks
  of one padded size, so that the chunk loop of ``bench/chain.run_chain_dense``
  (``bench.py --algo dense``) gathers at most one chunk of P rows at a time;
- ``spmm_csr_dense``: C = A x D for a ``SparseCSR`` carried in f32;
- ``dense_to_csr``: dense f32 -> ``SparseCSR`` on the host;
- ``spmm_csr_dense_exact``: C = A x D on the saturating u32/u64 semirings.

Exactness: integer counts carried in f32 are exact while every value stays
below 2^24 (checked by the callers, as in the JAX package).  An integer sum
of f32 terms is then exact in any order, so ``index_add_``'s order does not
matter; f32-semiring sums may differ from the JAX package's in the last
bits.

Divergence, kept on purpose: the JAX package's ``spmm_csr_dense_exact`` sums
16-bit planes and reports ``exact_ok`` False for a row of 2^16 - 1 entries or
more.  The port sums whole 32-bit limbs in int64, exact at any row length
below 2^31 entries, and its ``exact_ok`` is always True (as ``ops/segments``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..csr import F32_EXACT_LIMIT, SparseCSR
from ..semiring import Semiring
from . import segments

# the most bytes of D rows that spmm_csr_dense gathers at once
GATHER_BYTES = 1 << 31


def prepare_spmm_operand(a: SparseCSR, n_chunks: int = 8):
    """Host preprocessing of the static sparse operand: its entries split
    into ``n_chunks`` row-contiguous chunks of one padded size, on A's
    device.  Returns (cols int64, vals f32, local_rows int64, each
    (n_chunks, cap), and rows_per_chunk).  Raises ValueError on a value
    >= 2^24."""
    if n_chunks < 1:
        raise ValueError(f"n_chunks must be >= 1, got {n_chunks}")
    n = a.n_rows
    row_ptr, col_idx, vals_np = a.to_numpy()
    row_ptr = row_ptr.astype(np.int64)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(row_ptr))
    rpc = -(-n // n_chunks)
    lo = row_ptr[np.minimum(np.arange(n_chunks) * rpc, n)]
    hi = row_ptr[np.minimum((np.arange(n_chunks) + 1) * rpc, n)]
    counts = hi - lo
    cap = max(int(counts.max()), 1)
    cols = np.zeros((n_chunks, cap), np.int64)
    vals = np.zeros((n_chunks, cap), np.float32)
    lrow = np.zeros((n_chunks, cap), np.int64)
    for c in range(n_chunks):
        base, cnt = int(lo[c]), int(counts[c])
        cols[c, :cnt] = col_idx[base:base + cnt]
        vals[c, :cnt] = vals_np[base:base + cnt].astype(np.float32)
        lrow[c, :cnt] = rows[base:base + cnt] - c * rpc
    if len(vals_np) and float(vals_np.max()) >= F32_EXACT_LIMIT:
        raise ValueError("spmm dense path requires values < 2^24")
    dev = a.device
    return (torch.from_numpy(cols).to(dev), torch.from_numpy(vals).to(dev),
            torch.from_numpy(lrow).to(dev), rpc)


def spmm_dense(cols: torch.Tensor, vals: torch.Tensor, local_rows: torch.Tensor,
               p: torch.Tensor, rows_per_chunk: int) -> torch.Tensor:
    """C = A x P with A in chunked form (``prepare_spmm_operand``) and P
    dense f32 (n, m), A square (n x n, as in the JAX package).  Each chunk
    gathers its (cap, m) P rows, scales them and adds them into its rows of
    C.  Returns dense C (n, m) f32."""
    n_chunks = cols.shape[0]
    n, m = p.shape
    c = torch.zeros(n_chunks * rows_per_chunk, m, dtype=torch.float32, device=p.device)
    for ci in range(n_chunks):
        g = p[cols[ci]] * vals[ci][:, None]
        c[ci * rows_per_chunk:(ci + 1) * rows_per_chunk].index_add_(0, local_rows[ci], g)
    return c[:n]


def _valid_slots(a: SparseCSR):
    """(valid, rows with padding at n_rows, clamped columns) of A's slots."""
    valid = torch.arange(a.capacity, device=a.device) < a.nnz
    rows = torch.where(valid, a.row_of_slot(), a.n_rows)
    cols = torch.where(valid, a.col_idx.long().clamp(0, max(a.n_cols - 1, 0)), 0)
    return valid, rows, cols


def spmm_csr_dense(a: SparseCSR, d: torch.Tensor) -> torch.Tensor:
    """C = A x D with A a one-limb (f32-carried) ``SparseCSR`` and D dense
    f32 of shape (a.n_cols, m) or (a.n_cols,): a gather of D rows by A's
    columns, scaled, summed by row; it never leaves the device.  The
    (capacity, m) gather runs in column panels of at most ``GATHER_BYTES``
    (the JAX package gathers all columns at once: 23 GB at 216,000 entries x
    27,000 columns); each output element sums the same terms either way.
    Exact for integer counts < 2^24 carried in f32."""
    if d.shape[0] != a.n_cols or d.dim() not in (1, 2):
        raise ValueError(f"D of shape {tuple(d.shape)} does not fit A {a.shape}")
    valid, rows, cols = _valid_slots(a)
    v = torch.where(valid, a.values[0].float(), 0.0)
    if d.dim() == 1:
        g = d[cols] * v
        out = torch.zeros(a.n_rows + 1, dtype=g.dtype, device=d.device)
        return out.index_add_(0, rows, g)[:a.n_rows]
    m = d.shape[1]
    w = max(1, GATHER_BYTES // (d.element_size() * max(a.capacity, 1)))
    c = None
    for c0 in range(0, m, w):
        g = d[cols, c0:c0 + w] * v[:, None]
        panel = torch.zeros((a.n_rows + 1, g.shape[1]), dtype=g.dtype, device=d.device)
        panel = panel.index_add_(0, rows, g)[:a.n_rows]
        del g
        if w >= m:
            return panel
        if c is None:
            c = torch.empty((a.n_rows, m), dtype=panel.dtype, device=d.device)
        c[:, c0:c0 + w] = panel
    return c


def dense_to_csr(c_dense: torch.Tensor, sr: Semiring,
                 capacity: Optional[int] = None) -> SparseCSR:
    """Dense f32 -> ``SparseCSR`` on ``sr`` through the host (validation,
    extraction), built on ``c_dense``'s device; integer semirings round."""
    d = c_dense.detach().cpu().numpy()
    r, cc = np.nonzero(d)
    vals = np.round(d[r, cc]).astype(np.uint64) if sr.name != "f32" else d[r, cc]
    return SparseCSR.from_coo(r, cc, vals, d.shape[0], d.shape[1], sr=sr,
                              capacity=capacity or max(len(r), 1), device=c_dense.device)


def spmm_csr_dense_exact(a: SparseCSR, d_limbs) -> Tuple[tuple, torch.Tensor]:
    """C = A x D on the exact saturating integer semiring (u32/u64), D given
    as its dense limb tensors (each (a.n_cols, m) int64, as the semiring's
    limbs): gather D rows by A's columns, saturating-multiply by A's values,
    and sum by row as whole int64 limb sums, recombined with saturation (the
    saturating fold of non-negative values is min(true sum, MAX)).  Returns
    (limbs, exact_ok); ``exact_ok`` is True (see the module docstring)."""
    sr = a.sr
    if sr.name == "f32":
        raise ValueError("spmm_csr_dense_exact is for the u32/u64 semirings; "
                         "use spmm_csr_dense for f32")
    if len(d_limbs) != sr.nlimbs or any(l.shape[0] != a.n_cols for l in d_limbs):
        raise ValueError(f"D needs {sr.nlimbs} limb tensors of {a.n_cols} rows")
    valid, rows, cols = _valid_slots(a)
    g = tuple(l[cols] for l in d_limbs)
    prod = sr.mul(tuple(l[:, None] for l in a.values), g)
    sums = []
    for limb in prod:
        limb = torch.where(valid[:, None], limb, 0)
        out = torch.zeros((a.n_rows + 1,) + tuple(limb.shape[1:]), dtype=torch.int64,
                          device=limb.device)
        sums.append(out.index_add_(0, rows, limb)[:a.n_rows])
    exact_ok = torch.ones((), dtype=torch.bool, device=a.device)
    return segments._recombine(sr, sums), exact_ok
