"""Block-band matrices and their product: the counterpart of ``sparsetpu/kernels/bandmm.py``.

A matrix whose nonzeros lie in a (cyclic) band -- a Moore torus natively --
is stored as dense block diagonals: for block size B and block half-width
Wb, ``data[I, D]`` is the dense B x B block at block row I, block column
(I + D - Wb) (mod nb when cyclic, else clipped).  A band product is then a
block-diagonal convolution,

    C[I, Dp + Da] += P[I, Dp] @ A[(I + Dp - Wbp) % nb, Da],

that is Kbp batched (nb, Kba, B, B) matrix products.  Entries outside the
band are "outliers", which ``ops/hybrid.py`` sends through the sparse
routes.  JAX computes this outside any Pallas kernel (XLA), so it stays
plain torch: batched fp32 ``matmul`` with TF32 off (it raises if TF32 is
enabled), exact while the results stay below 2^24 (the callers guard).

Divergence, kept on purpose: the JAX package's ``p_limbs``/``a_limbs``
split the inputs into bf16 planes of 8-bit limbs to run at the MXU's native
rate; they change the cost, not the result.  The port accepts them and
ignores them: its fp32 product is already exact below 2^24.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from ..csr import HostCSR, SparseCSR
from ..semiring import U64, Semiring
from . import spmm as kspmm


@dataclasses.dataclass(frozen=True)
class BandMatrix:
    """Dense block-band matrix: data[I, D, r, c] = M[I*B + r, col] with
    col = (I + D - Wb) * B + c, cyclic mod n or clipped."""

    data: torch.Tensor  # f32[nb, K, B, B]
    n: int              # logical size (nb * B when cyclic)
    block: int
    half_width_blocks: int
    cyclic: bool

    @property
    def nb(self) -> int:
        return self.data.shape[0]

    @property
    def k_blocks(self) -> int:
        return self.data.shape[1]

    @property
    def half_width(self) -> int:
        return self.half_width_blocks * self.block

    def nnz(self) -> torch.Tensor:
        return torch.count_nonzero(self.data)

    def memory_bytes(self) -> int:
        return self.data.numel() * self.data.element_size()

    def max_value(self) -> torch.Tensor:
        return self.data.max()


def band_params(n: int, half_width: int, block: int, cyclic: bool):
    """(nb, Wb) for an element half-width.  A cyclic band needs block | n."""
    if cyclic:
        if n % block:
            raise ValueError(f"cyclic band needs block | n ({block} vs {n})")
        nb = n // block
    else:
        nb = -(-n // block)
    wb = -(-half_width // block) + 1  # +1: element offset within the block row
    return nb, wb


def _host_arrays(a: Union[HostCSR, SparseCSR]):
    """(rows int64, cols int64, vals) of a host or device CSR, on the host."""
    if isinstance(a, HostCSR):
        return a.rows(), a.col_idx.astype(np.int64), a.vals
    row_ptr, col_idx, vals = a.to_numpy()
    rows = np.repeat(np.arange(a.n_rows, dtype=np.int64), np.diff(row_ptr))
    return rows, col_idx.astype(np.int64), vals


def cyclic_bandwidth(a: Union[HostCSR, SparseCSR]) -> int:
    """Max cyclic column offset min(|c - r| mod n, |r - c| mod n) over all
    entries (n = a.n_rows).  A Moore torus's exceeds the naive stride sum:
    inner-dimension wraps add stride_i * (d_i - 1) (30^3: 1,799, not 931)."""
    n = a.n_rows
    rows, cols, _ = _host_arrays(a)
    delta = cols - rows
    dc = np.minimum(np.mod(delta, n), np.mod(-delta, n))
    return int(dc.max(initial=0))


def csr_band_split(a: SparseCSR, half_width: int, block: int = 128, cyclic: bool = False):
    """Host split of a square CSR into (BandMatrix, outlier SparseCSR), both
    on A's device: an entry is in the band when its (cyclic) block diagonal
    lies within Wb of the block row's; every other entry is an outlier."""
    if a.n_rows != a.n_cols:
        raise ValueError(f"a band split needs a square matrix, got {a.shape}")
    n = a.n_rows
    nb, wb = band_params(n, half_width, block, cyclic)
    kb = min(2 * wb + 1, nb) if cyclic else 2 * wb + 1
    rows, cols, vals = _host_arrays(a)
    I, J = rows // block, cols // block
    D = np.mod(J - I + wb, nb) if cyclic else J - I + wb
    in_band = (D >= 0) & (D < kb)
    data = np.zeros((nb, kb, block, block), np.float32)
    data[I[in_band], D[in_band], rows[in_band] % block, cols[in_band] % block] = \
        vals[in_band].astype(np.float32)
    out = ~in_band
    outliers = SparseCSR.from_coo(rows[out], cols[out], vals[out], n, n, sr=a.sr,
                                  capacity=max(int(out.sum()), 1), device=a.device)
    band = BandMatrix(torch.from_numpy(data).to(a.device), n, block, wb, cyclic)
    return band, outliers


def band_to_coo(b: BandMatrix):
    """Host BandMatrix -> COO (rows, cols, f32 values)."""
    data = b.data.cpu().numpy()
    nb, _, B, _ = data.shape
    I, D, r, c = np.nonzero(data)
    J = I + D - b.half_width_blocks
    if b.cyclic:
        J = np.mod(J, nb)
    rows, cols = I * B + r, J * B + c
    keep = (rows < b.n) & (cols < b.n) & (J >= 0) & (J < nb)
    return rows[keep], cols[keep], data[I, D, r, c][keep]


def band_to_dense(b: BandMatrix) -> torch.Tensor:
    """The band as a dense (n, n) f32 tensor on its device (a port helper
    for the chain's final-value check; the JAX package checks no band
    product)."""
    nb, kb, B, _ = b.data.shape
    out = torch.zeros(nb, B, nb, B, dtype=torch.float32, device=b.data.device)
    I = torch.arange(nb, device=b.data.device)
    for d in range(kb):
        J = I + d - b.half_width_blocks
        ok = torch.ones_like(J, dtype=torch.bool) if b.cyclic else (J >= 0) & (J < nb)
        J = torch.remainder(J, nb)
        out[I[ok], :, J[ok], :] += b.data[ok, d]
    return out.reshape(nb * B, nb * B)[:b.n, :b.n]


def _band_matmul_data(p_data: torch.Tensor, a_data: torch.Tensor, wbp: int, wba: int,
                      cyclic: bool, p_limbs: int = 0, a_limbs: int = 0,
                      row_offset: int = 0) -> torch.Tensor:
    """The block-diagonal convolution: for each of P's Kbp diagonals, one
    batched fp32 product of its blocks with the Kba blocks of A's matching
    block rows, added into C's diagonals [dp, dp + Kba).  ``row_offset``
    shifts the global block row of p_data's rows (a row shard of P; A is
    whole).  ``p_limbs``/``a_limbs``
    are accepted for JAX's signature and change nothing (module docstring)."""
    if kspmm.tf32_enabled():
        raise RuntimeError("the band product needs full fp32 products: TF32 is enabled")
    nb_loc, kbp, B, _ = p_data.shape
    nb, kba = a_data.shape[:2]
    # A as (nb, B, Kba * B): block row j of every diagonal side by side, so
    # that each of P's diagonals is one (B, B) @ (B, Kba * B) product a block
    # row; C accumulates in the same (nb, B, Kbc, B) order
    a_wide = a_data.permute(0, 2, 1, 3).reshape(nb, B, kba * B)
    c = torch.zeros(nb_loc, B, kbp + kba - 1, B, dtype=torch.float32, device=p_data.device)
    iota = torch.arange(nb_loc, device=p_data.device) + row_offset
    for dp in range(kbp):
        src = iota + dp - wbp
        if cyclic:
            a_rows = a_wide[torch.remainder(src, nb)]
        else:
            valid = (src >= 0) & (src < nb)
            a_rows = a_wide[src.clamp(0, nb - 1)] * valid[:, None, None]
        c[:, :, dp:dp + kba] += torch.bmm(p_data[:, dp], a_rows).view(nb_loc, B, kba, B)
    return c.permute(0, 2, 1, 3).contiguous()


def limbs_for_max(vmax: float) -> int:
    """Number of 8-bit limbs that represent integer values <= vmax."""
    v = max(int(vmax), 1)
    return max(1, -(-v.bit_length() // 8))


def band_matmul(p: BandMatrix, a: BandMatrix, p_limbs: int = 0, a_limbs: int = 0) -> BandMatrix:
    """C = P x A for two block-band matrices of one block size and wrap mode;
    a cyclic product wider than the matrix is folded (``fold_cyclic``)."""
    if p.block != a.block or p.cyclic != a.cyclic or p.n != a.n:
        raise ValueError("band_matmul needs one size, block size and wrap mode")
    c_data = _band_matmul_data(p.data, a.data, p.half_width_blocks, a.half_width_blocks,
                               p.cyclic, p_limbs=p_limbs, a_limbs=a_limbs)
    wbc = p.half_width_blocks + a.half_width_blocks
    if p.cyclic and c_data.shape[1] > p.nb:
        return BandMatrix(fold_cyclic(c_data, wbc, p.nb), p.n, p.block, 0, True)
    return BandMatrix(c_data, p.n, p.block, wbc, p.cyclic)


def fold_cyclic(c_data: torch.Tensor, wbc: int, nb: int) -> torch.Tensor:
    """A band wider than the matrix aliases under the cyclic wrap: diagonal
    d goes to slot (d - wbc) mod nb, re-anchored at Wb = 0 (a full block
    circulant); diagonals on one slot add."""
    slot = torch.remainder(torch.arange(c_data.shape[1], device=c_data.device) - wbc, nb)
    folded = torch.zeros((c_data.shape[0], nb) + tuple(c_data.shape[2:]),
                         dtype=torch.float32, device=c_data.device)
    return folded.index_add_(1, slot, c_data)


def band_to_csr(b: BandMatrix, sr: Semiring = U64, capacity: Optional[int] = None) -> SparseCSR:
    """Host conversion to a ``SparseCSR`` on the band's device (integer
    semirings round)."""
    rows, cols, vals = band_to_coo(b)
    v = np.round(vals).astype(np.uint64) if sr.name != "f32" else vals
    return SparseCSR.from_coo(rows, cols, v, b.n, b.n, sr=sr,
                              capacity=capacity or max(len(rows), 1), device=b.data.device)
