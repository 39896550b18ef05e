"""Categorized SpGEMM and the chain router: the counterpart of ``sparsetpu/ops/hybrid.py``.

Entries are categorized by band membership: in-band entries take the dense
block-band product (``kernels/bandmm.py``), out-of-band "outliers" take the
sparse routes (``spgemm_auto``), and the linear decomposition
(Pb + Po) x A = Pb@A + Po@A makes the merge exact.  A Moore torus is
cyclic-banded, so its outlier set is empty.  The band path carries integer
counts in f32, exact while values stay below 2^24 (checked; a larger value
raises).

``choose_strategy`` keeps the JAX package's rule and constants unchanged,
including ``dense_bytes <= 4e9`` and the 1024-column padding, so that the two
routers can be held equal in the tests.  Re-deriving them for an 80 GB card
is a ROADMAP item (the constants for 80 GB, beside ``spgemm_auto``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from ..csr import F32_EXACT_LIMIT, HostCSR, SparseCSR
from ..kernels.bandmm import (BandMatrix, band_matmul, band_to_csr, csr_band_split,
                              cyclic_bandwidth)
from ..semiring import F32SR, U64, Semiring
from .spgemm import spadd, spgemm_auto

__all__ = ["F32_EXACT_LIMIT", "HybridMatrix", "choose_strategy", "hybrid_from_csr",
           "hybrid_matmul"]


@dataclasses.dataclass
class HybridMatrix:
    """The band + outliers decomposition of one matrix (values add)."""

    band: BandMatrix
    outliers: SparseCSR

    @property
    def n(self) -> int:
        return self.band.n

    def nnz(self) -> int:
        """An upper bound after a product (band and outliers may overlap);
        exact at split time, where their supports are disjoint."""
        return int(self.band.nnz()) + int(self.outliers.nnz)

    def to_csr(self, sr: Semiring = U64) -> SparseCSR:
        bc = band_to_csr(self.band, sr=sr)
        if int(self.outliers.nnz) == 0:
            return bc
        cap = bc.capacity + self.outliers.capacity
        return spadd(bc.with_capacity(cap), self.outliers.with_capacity(cap),
                     out_cap=cap).check()


def hybrid_from_csr(a: SparseCSR, half_width: int, block: int = 128,
                    cyclic: bool = False) -> HybridMatrix:
    vmax = _csr_max_value(a)
    if vmax >= F32_EXACT_LIMIT:
        raise ValueError(f"band path requires values < 2^24 (got {vmax}); use ESC")
    return HybridMatrix(*csr_band_split(a, half_width, block, cyclic))


def _csr_max_value(a: Union[HostCSR, SparseCSR]) -> float:
    if isinstance(a, HostCSR):
        return float(a.vals.max()) if a.nnz else 0.0
    if int(a.nnz) == 0:
        return 0.0
    vals = a.to_numpy()[2]
    return float(vals.max()) if len(vals) else 0.0


def _band_times_sparse(p: BandMatrix, a_out: SparseCSR) -> SparseCSR:
    """C2 = P_band x A_out by column gathers: for each outlier entry (k, j,
    v) of the f32-carried A_out, band column k of P (its blocks on column
    block k's diagonals) is scaled by v and scattered as COO entries of
    column j."""
    if int(a_out.nnz) == 0:
        return a_out
    B, nb, kbp, wbp = p.block, p.nb, p.k_blocks, p.half_width_blocks
    device = a_out.device
    valid = torch.arange(a_out.capacity, device=device) < a_out.nnz
    k = torch.where(valid, a_out.row_of_slot(), 0)
    j = torch.where(valid, a_out.col_idx.long(), 0)
    v = a_out.values[0]
    d = torch.arange(kbp, device=device)
    I = (k // B)[:, None] + wbp - d[None, :]  # (cap_o, kbp) block rows holding column k
    if p.cyclic:
        I_idx = torch.remainder(I, nb)
        blk_valid = torch.ones_like(I, dtype=torch.bool)
    else:
        I_idx = I.clamp(0, nb - 1)
        blk_valid = (I >= 0) & (I < nb)
    col_p = p.data[I_idx, d[None, :], :, (k % B)[:, None]]  # (cap_o, kbp, B)
    contrib = torch.where(blk_valid[:, :, None] & valid[:, None, None],
                          col_p * v[:, None, None], 0.0)
    rows = (I_idx * B)[:, :, None] + torch.arange(B, device=device)[None, None, :]
    cols = j[:, None, None].expand(rows.shape)
    keep = (contrib != 0) & (rows < p.n)
    return SparseCSR.from_coo_device(rows.reshape(-1), cols.reshape(-1),
                                     (contrib.reshape(-1),), p.n, p.n, a_out.sr,
                                     max(contrib.numel(), 1), valid=keep.reshape(-1))


def hybrid_matmul(p: HybridMatrix, a: HybridMatrix,
                  a_csr: Optional[SparseCSR] = None) -> HybridMatrix:
    """C = (Pb + Po) x A = Pb@Ab [band product] + Pb@Ao [column gathers] +
    Po@A [``spgemm_auto``].  ``a_csr``, the whole right operand as a CSR, is
    needed only when P has outliers."""
    c_band = band_matmul(p.band, a.band)
    if float(c_band.max_value()) >= F32_EXACT_LIMIT - 8:
        raise OverflowError("band matmul result reached the f32 exact-integer limit "
                            "(2^24); use the ESC path for this product")
    sr = p.outliers.sr
    parts = []
    if int(a.outliers.nnz) > 0:
        parts.append(_f32_to_sr_csr(_band_times_sparse(p.band, _as_f32_csr(a.outliers)), sr))
    if int(p.outliers.nnz) > 0:
        if a_csr is None:
            raise ValueError("P has outliers: pass the whole right operand as a_csr")
        parts.append(spgemm_auto(p.outliers, a_csr))
    out = SparseCSR.empty(p.n, p.n, 1, sr, p.outliers.device)
    for part in parts:
        cap = out.capacity + part.capacity
        out = spadd(out.with_capacity(cap), part.with_capacity(cap), out_cap=cap).check()
    return HybridMatrix(c_band, out)


def _as_f32_csr(a: SparseCSR) -> SparseCSR:
    if a.sr_name == "f32":
        return a
    vals = a.sr.to_numpy(a.values).astype(np.float32)
    if float(vals.max(initial=0.0)) >= F32_EXACT_LIMIT:
        raise OverflowError("outlier values exceed the f32 exact-integer range")
    return dataclasses.replace(a, values=(torch.from_numpy(vals).to(a.device),),
                               sr_name=F32SR.name)


def _f32_to_sr_csr(a: SparseCSR, sr: Semiring) -> SparseCSR:
    if sr.name == "f32":
        return a
    vals = np.round(a.values[0].cpu().numpy()).astype(np.uint64)
    return dataclasses.replace(a, values=sr.from_numpy(vals, device=a.device),
                               sr_name=sr.name)


def choose_strategy(a: Union[HostCSR, SparseCSR], steps: int = 1) -> str:
    """Pick the kernel category for C = A^(steps+1) chains (a host or a
    device CSR):

      - "dense-acc": the product densifies (expected final row degree
        deg^(steps+1) reaches 1% of n) and the dense product fits
        (kernels/spmm.py);
      - "band": (cyclic-)banded support with an occupied band (the
        block-band product, kernels/bandmm.py);
      - "esc": everything else, and any value beyond the f32 carrier (the
        chain driver runs it as the rowcat chain, ops/rowcat.py, as
        bench.py does).
    """
    n = a.n_rows
    nnz = a.nnz if isinstance(a, HostCSR) else int(a.nnz)
    if nnz == 0 or n == 0:
        return "esc"
    if _csr_max_value(a) >= F32_EXACT_LIMIT:
        return "esc"
    deg = max(nnz / max(n, 1), 1.0)
    exp_row_deg = min(deg ** (steps + 1), float(n))
    padded_cols = -(-n // 1024) * 1024
    dense_bytes = n * padded_cols * 4
    if dense_bytes <= 4e9 and exp_row_deg >= 0.01 * n:
        return "dense-acc"
    bw = cyclic_bandwidth(a)
    band_frac = 2.0 * bw / max(n, 1)
    band_density = nnz / max(band_frac * n * n, 1.0)
    if band_density > 0.01:
        return "band"
    return "esc"
