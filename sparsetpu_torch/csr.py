"""Host CSR for the port: the COO -> CSR merge of ``sparsetpu/csr.py``.

Only the host half exists so far: ``HostCSR.from_coo`` is the port of
``SparseCSR.host_csr_arrays`` (lexsort, saturating u64/u32 merge of
duplicates, dropping of zeros), and ``HostCSR.to_device`` hands the arrays to
the GPU kernels in their f32-carrier form.  The arrays are unpadded: the
power-of-two capacity of the JAX package is an artifact of XLA's static
shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

SEMIRINGS = ("u64", "u32", "f32")
F32_EXACT_LIMIT = float(1 << 24)  # integers carried in f32 are exact below this
_SATURATE = {"u64": (1 << 64) - 1, "u32": (1 << 32) - 1}


@dataclasses.dataclass(frozen=True)
class HostCSR:
    """n_rows x n_cols CSR in numpy; entries sorted by (row, col), no zeros."""

    row_ptr: np.ndarray  # int64[n_rows + 1]
    col_idx: np.ndarray  # int32[nnz]
    vals: np.ndarray     # uint64[nnz] (u64, u32) or float32[nnz] (f32)
    n_rows: int
    n_cols: int
    sr_name: str

    @property
    def nnz(self) -> int:
        return int(self.row_ptr[-1])

    def rows(self) -> np.ndarray:
        """int64[nnz]: the row of every entry."""
        return np.repeat(np.arange(self.n_rows, dtype=np.int64),
                         np.diff(self.row_ptr))

    @staticmethod
    def from_coo(rows, cols, vals, n_rows: int, n_cols: Optional[int] = None,
                 sr_name: str = "u64") -> "HostCSR":
        """COO -> CSR: duplicates merge with the semiring's (saturating) add
        and zero entries are dropped."""
        if sr_name not in SEMIRINGS:
            raise ValueError(f"unknown semiring {sr_name!r}; have {SEMIRINGS}")
        n_cols = n_rows if n_cols is None else n_cols
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        vals = np.asarray(vals)
        out_dtype = np.float32 if sr_name == "f32" else np.uint64
        if rows.size:
            order = np.lexsort((cols, rows))
            rows, cols, vals = rows[order], cols[order], vals[order]
            key = rows * n_cols + cols
            head = np.ones(len(key), bool)
            head[1:] = key[1:] != key[:-1]
            seg = np.cumsum(head) - 1
            if sr_name == "f32":
                totals = np.zeros(seg[-1] + 1, np.float64)
                np.add.at(totals, seg, vals.astype(np.float64))
                totals = totals.astype(np.float32)
            else:
                # saturating segment sum in python ints (exact)
                totals = np.zeros(seg[-1] + 1, dtype=object)
                np.add.at(totals, seg, vals.astype(np.uint64).astype(object))
                totals = np.minimum(totals, _SATURATE[sr_name]).astype(np.uint64)
            rows, cols = rows[head], cols[head]
            keep = totals != 0
            rows, cols, totals = rows[keep], cols[keep], totals[keep]
        else:
            totals = np.zeros(0, out_dtype)
        row_ptr = np.zeros(n_rows + 1, np.int64)
        np.add.at(row_ptr, rows + 1, 1)
        return HostCSR(np.cumsum(row_ptr), cols.astype(np.int32),
                       totals.astype(out_dtype), n_rows, n_cols, sr_name)

    def to_device(self, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(row_ptr int32, col_idx int32, vals float32) tensors on ``device``.

        Integer semirings ride an f32 carrier, exact only below 2^24, so a
        larger value raises ValueError (the f32 semiring has no such bound)."""
        if (self.sr_name != "f32" and self.nnz
                and float(self.vals.max()) >= F32_EXACT_LIMIT):
            raise ValueError("the f32 carrier requires integer values < 2^24")
        if self.nnz >= 2**31:
            raise ValueError(f"nnz {self.nnz} does not fit int32 row offsets")
        return (
            torch.from_numpy(self.row_ptr.astype(np.int32)).to(device),
            torch.from_numpy(self.col_idx.astype(np.int32)).to(device),
            torch.from_numpy(self.vals.astype(np.float32)).to(device),
        )
