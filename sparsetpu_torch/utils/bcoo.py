"""``torch.sparse`` comparator, the library baseline: the counterpart of ``sparsetpu/utils/bcoo.py``.

The JAX package holds its hand-written kernels against the experimental BCOO
format of ``jax.experimental.sparse``; the port holds them against
``torch.sparse``: a COO tensor on both devices, whose sparse x sparse product
runs cuSPARSE on the card.  It is a comparator only: nothing on a main path
calls it (the general-SpGEMM sweep times it as its ``bcoo`` row).

``torch.sparse`` carries one float dtype and no limbed semiring, so the
comparator is exact only while values stay in the dtype's exact-integer
range (float32: 2^24); callers guard, and below that range saturation never
triggers, so results equal the semiring kernels' bit for bit.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..csr import SparseCSR
from ..semiring import U64, Semiring


def csr_to_bcoo(a: SparseCSR, dtype=torch.float32) -> torch.Tensor:
    """``SparseCSR`` -> coalesced sparse COO tensor on A's device (one host
    read of nnz; comparator only).  u64 values ride as lo + hi * 2^32."""
    nnz = int(a.check().nnz)
    rows = torch.repeat_interleave(torch.arange(a.n_rows, device=a.device),
                                   a.row_nnz().long())
    data = a.values[0][:nnz].to(torch.float64)
    if a.sr_name == "u64":
        data = data + a.values[1][:nnz].to(torch.float64) * float(1 << 32)
    idx = torch.stack([rows, a.col_idx[:nnz].long()])
    return torch.sparse_coo_tensor(idx, data.to(dtype), a.shape, is_coalesced=True,
                                   check_invariants=False)


def bcoo_to_csr(m: torch.Tensor, sr: Semiring = U64,
                capacity: Optional[int] = None) -> SparseCSR:
    """Sparse COO tensor -> ``SparseCSR`` on ``sr`` (duplicates summed,
    explicit zeros dropped, integer semirings rounded), on m's device."""
    m = m.coalesce()
    idx = m.indices().cpu().numpy()
    data = m.values().cpu().numpy()
    keep = data != 0
    vals = data[keep]
    if sr.name != "f32":
        vals = np.round(vals).astype(np.uint64)
    return SparseCSR.from_coo_host(idx[0, keep], idx[1, keep], vals, m.shape[0], m.shape[1],
                                   sr=sr, capacity=capacity, device=m.device)


def spgemm_bcoo(a: SparseCSR, b: SparseCSR, sr: Optional[Semiring] = None,
                dtype=torch.float32) -> SparseCSR:
    """C = A x B through ``torch.sparse.mm`` (sparse x sparse -> sparse)."""
    if a.n_cols != b.n_rows:
        raise ValueError(f"shapes {a.shape} x {b.shape} do not chain")
    return bcoo_to_csr(torch.sparse.mm(csr_to_bcoo(a, dtype), csr_to_bcoo(b, dtype)),
                       sr=sr or a.sr)
