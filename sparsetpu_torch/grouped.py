"""Batched (compound-row) sparse tensors: the port of ``sparsetpu/grouped.py``.

A (g, n, m) batched sparse tensor is stored as a block-diagonal
``SparseCSR`` of shape (g * n, g * m): distinct batch entries never meet,
so one flat SpGEMM computes every batch's product.  This is how the einsum
engine lowers ``bij,bjk->bik`` (``einsum/engine.py``) and how sparse
attention lays out its operands (``attention/scores.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from .csr import DEFAULT_DEVICE, SparseCSR
from .ops.spgemm import pow2, spgemm, symbolic_flops
from .semiring import U64, Semiring


@dataclasses.dataclass(frozen=True)
class GroupedCSR:
    """(g, n, m) batched sparse tensor as a block-diagonal SparseCSR."""

    flat: SparseCSR
    g: int
    n: int
    m: int

    @property
    def shape(self) -> Tuple[int, int, int]:
        return (self.g, self.n, self.m)

    @property
    def device(self):
        return self.flat.device

    @staticmethod
    def from_coo(batch, rows, cols, vals, g: int, n: int, m: int, sr: Semiring = U64,
                 capacity: Optional[int] = None, device=DEFAULT_DEVICE) -> "GroupedCSR":
        """Batched COO (numpy arrays or lists) -> GroupedCSR on ``device``."""
        batch = np.asarray(batch, np.int64)
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        flat = SparseCSR.from_coo(batch * n + rows, batch * m + cols, vals, g * n, g * m,
                                  sr=sr, capacity=capacity, device=device)
        return GroupedCSR(flat, g, n, m)

    @staticmethod
    def from_dense(x, sr: Semiring = U64, capacity: Optional[int] = None,
                   device=DEFAULT_DEVICE) -> "GroupedCSR":
        """A dense (g, n, m) numpy tensor -> GroupedCSR of its nonzeros."""
        x = np.asarray(x)
        if x.ndim != 3:
            raise ValueError(f"GroupedCSR.from_dense needs a 3-D tensor, got {x.shape}")
        g, n, m = x.shape
        b, r, c = np.nonzero(x)
        return GroupedCSR.from_coo(b, r, c, x[b, r, c], g, n, m, sr, capacity, device)

    def to_dense(self) -> np.ndarray:
        """Dense (g, n, m) numpy tensor (uint64 for u32/u64, float32 for
        f32): each batch's diagonal block of the flat CSR, read entry by
        entry (O(nnz), never the (g * n, g * m) square); entries off the
        blocks are dropped."""
        row_ptr, col_idx, vals = self.flat.to_numpy()
        rows = np.repeat(np.arange(self.g * self.n), np.diff(row_ptr))
        b = rows // self.n
        c = col_idx.astype(np.int64) - b * self.m
        keep = (c >= 0) & (c < self.m)
        out = np.zeros((self.g, self.n, self.m), vals.dtype)
        out[b[keep], rows[keep] % self.n, c[keep]] = vals[keep]
        return out

    def matmul(self, other: "GroupedCSR") -> "GroupedCSR":
        """Batched C[g] = A[g] x B[g] as ONE flat ESC SpGEMM at the
        power-of-two capacity of its product count (block-diagonal operands
        never cross batches); ``check()`` raises on a poisoned product."""
        if self.g != other.g or self.m != other.n:
            raise ValueError(f"grouped shapes {self.shape} x {other.shape} do not chain")
        cap = pow2(int(symbolic_flops(self.flat, other.flat)))
        c = spgemm(self.flat, other.flat, cap).check()
        return GroupedCSR(c, self.g, self.n, other.m)

    def transpose(self) -> "GroupedCSR":
        return GroupedCSR(self.flat.transpose(), self.g, self.m, self.n)
