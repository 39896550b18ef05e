"""Dense-accumulator SpMM, C = A x P: the port of ``sparsetpu/kernels/spmm_pallas.py``.

The chain's hot step.  For each entry (i, k, v) of the static sparse operand
A, one row of the dense P is read and ``v * P[k, :]`` is accumulated into row
i of C; C is written once.  On a CUDA tensor ``spmm_dense_acc`` launches the
hand-written kernel ``csrc/spmm_dense_acc.cu`` (the counterpart of
``_spmm_kernel``); on a CPU tensor it runs the plain PyTorch version
``spmm_dense_acc_reference``, which the tests hold against the JAX kernel.

On the GPU the operand is plain CSR and P is plain row-major (n, m) f32: the
TPU's per-tile entry lists, the padding of each tile to a multiple of NBUF,
the S-plane offsets and the 1024-column row planes are Mosaic artifacts and
are dropped.

Exactness: integer counts ride an f32 carrier, exact while all values stay
below 2^24.  ``prepare_sparse_operand`` guards A's values; the chain driver
guards the products.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..csr import HostCSR
from . import _build

LAUNCHES = 0  # kernel launches by spmm_dense_acc (CUDA tensors only)


@dataclasses.dataclass(frozen=True)
class SparseOperand:
    """The static CSR operand A on a device, in the kernel's types."""

    row_ptr: torch.Tensor  # int32[n_rows + 1], row_ptr[0] == 0
    col_idx: torch.Tensor  # int32[nnz]
    vals: torch.Tensor     # float32[nnz]
    n_rows: int
    n_cols: int

    @property
    def device(self) -> torch.device:
        return self.vals.device


def prepare_sparse_operand(a: HostCSR, device) -> SparseOperand:
    """Host CSR -> device operand (the counterpart of tile_sparse_operand).
    Raises ValueError on an integer value >= 2^24."""
    row_ptr, col_idx, vals = a.to_device(device)
    return SparseOperand(row_ptr, col_idx, vals, a.n_rows, a.n_cols)


def row_slice(op: SparseOperand, start: int, stop: int) -> SparseOperand:
    """Rows [start, stop) of the operand, as an operand of its own."""
    if not 0 <= start <= stop <= op.n_rows:
        raise ValueError(f"row slice [{start}, {stop}) outside [0, {op.n_rows})")
    e0, e1 = int(op.row_ptr[start]), int(op.row_ptr[stop])
    return SparseOperand(op.row_ptr[start:stop + 1] - e0, op.col_idx[e0:e1],
                         op.vals[e0:e1], stop - start, op.n_cols)


def _entry_rows(op: SparseOperand) -> torch.Tensor:
    counts = torch.diff(op.row_ptr).long()
    return torch.repeat_interleave(
        torch.arange(op.n_rows, device=op.device), counts)


def spmm_dense_acc_reference(op: SparseOperand, p: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch C = A x P in f32: gather the referenced P rows, scale,
    and index_add them into C.  It materialises an (nnz, m) gather, so on the
    card it is for comparisons at small shapes.  Do not replace it by a
    dense product: on the GPU that may run in TF32, which is not exact."""
    rows = _entry_rows(op)
    out = torch.zeros(op.n_rows, p.shape[1], dtype=torch.float32, device=p.device)
    return out.index_add_(0, rows, op.vals[:, None] * p[op.col_idx.long()])


def _check(op: SparseOperand, p: torch.Tensor, out: Optional[torch.Tensor]) -> None:
    if p.dtype != torch.float32 or p.dim() != 2:
        raise ValueError(f"P must be a 2-D float32 tensor, got {p.dtype} {tuple(p.shape)}")
    if not p.is_contiguous():
        raise ValueError("P must be contiguous (row-major)")
    if p.shape[0] != op.n_cols:
        raise ValueError(f"P has {p.shape[0]} rows, A has {op.n_cols} columns")
    for name, t, dtype in (("row_ptr", op.row_ptr, torch.int32),
                           ("col_idx", op.col_idx, torch.int32),
                           ("vals", op.vals, torch.float32)):
        if t.device != p.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"A.{name} must be contiguous {dtype} on {p.device}, "
                             f"got {t.dtype} on {t.device}")
    if op.row_ptr.numel() != op.n_rows + 1 or op.col_idx.numel() != op.vals.numel():
        raise ValueError("A's row_ptr, col_idx and vals disagree in size")
    check_out(out, (op.n_rows, p.shape[1]), p)


def tf32_enabled() -> bool:
    """True when float32 matrix products on CUDA may round through TF32."""
    return (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest")


def check_out(out: Optional[torch.Tensor], shape, p: torch.Tensor) -> None:
    """An ``out`` buffer (if given) must be a contiguous float32 ``shape``
    tensor on P's device that does not share P's storage; raises
    ValueError."""
    if out is None:
        return
    if out.dtype != torch.float32 or tuple(out.shape) != tuple(shape):
        raise ValueError(f"out must be float32 {tuple(shape)}, "
                         f"got {out.dtype} {tuple(out.shape)}")
    if out.device != p.device or not out.is_contiguous():
        raise ValueError("out must be a contiguous tensor on P's device")
    if out.untyped_storage().data_ptr() == p.untyped_storage().data_ptr():
        raise ValueError("out must not share storage with P")


def spmm_dense_acc(op: SparseOperand, p: torch.Tensor,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """C = A x P.  On CUDA: one launch of the hand-written kernel on the
    current stream, without synchronising; ``out`` (if given) receives C, so
    a chain can ping-pong two buffers.  On the CPU: the plain version."""
    global LAUNCHES
    _check(op, p, out)
    if p.device.type == "cpu":
        c = spmm_dense_acc_reference(op, p)
        return c if out is None else out.copy_(c)
    if p.device.type != "cuda":
        raise ValueError(f"spmm_dense_acc runs on cpu or cuda, not {p.device}")
    n_rows, m = op.n_rows, p.shape[1]
    if out is None:
        out = torch.empty(n_rows, m, dtype=torch.float32, device=p.device)
    if out.numel() == 0:
        return out
    lib = _build.load()
    if n_rows >= 2**31 or m > lib.spmm_dense_acc_max_cols():
        raise ValueError(f"({n_rows}, {m}) exceeds the kernel's launch grid")
    with torch.cuda.device(p.device):
        err = lib.spmm_dense_acc_f32(
            op.row_ptr.data_ptr(), op.col_idx.data_ptr(), op.vals.data_ptr(),
            p.data_ptr(), out.data_ptr(), n_rows, m,
            torch.cuda.current_stream(p.device).cuda_stream)
    if err != 0:
        raise RuntimeError("spmm_dense_acc launch failed: "
                           + lib.spmm_error_string(err).decode())
    LAUNCHES += 1
    return out


def densify(op: SparseOperand, n_cols: Optional[int] = None) -> torch.Tensor:
    """Dense (n_rows, n_cols) f32 copy of A, scattered on A's device (the
    chain's P0)."""
    n_cols = op.n_cols if n_cols is None else n_cols
    out = torch.zeros(op.n_rows, n_cols, dtype=torch.float32, device=op.device)
    out[_entry_rows(op), op.col_idx.long()] = op.vals
    return out
