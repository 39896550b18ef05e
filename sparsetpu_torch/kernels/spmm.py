"""Dense-accumulator SpMM, C = A x P: the port of ``sparsetpu/kernels/spmm_pallas.py``.

The chain's hot step.  For each entry (i, k, v) of the static sparse operand
A, one row of the dense P is read and ``v * P[k, :]`` is accumulated into row
i of C; C is written once.  On a CUDA tensor ``spmm_dense_acc`` launches the
hand-written kernel ``csrc/spmm_dense_acc.cu`` (the counterpart of
``_spmm_kernel``); on a CPU tensor it runs the plain PyTorch version
``spmm_dense_acc_reference``, which the tests hold against the JAX kernel.

``spmm_dense_acc_csr_panel`` is the tiled dense accumulator's CSR-panel
form: one (n, w) C panel of A x B, columns [lo, lo + w), with B read from
its CSR (``CsrPanels``: its columns, its values in the f32 carrier and a
table of each row's first slot at each panel boundary) instead of from a
densified panel.  On a CUDA tensor it launches
``csrc/spmm_dense_acc_csr_panel.cu`` (a dense accumulator in shared memory,
the reference's Gustavson SpGEMM a panel at a time); on a CPU tensor it runs
``spmm_dense_acc_csr_panel_reference``.  ``ops/denseacc`` picks the form.

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
from typing import Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..csr import HostCSR
from . import _build

LAUNCHES = 0  # dense-acc launches of either form (CUDA tensors only)
CSR_PANEL_LAUNCHES = 0  # of those, the CSR-panel form's (spmm_dense_acc_csr_panel)


@dataclasses.dataclass(frozen=True)
class SparseOperand:
    """The static CSR operand A on a device, in the kernel's types."""

    row_ptr: torch.Tensor  # int32[n_rows + 1], row_ptr[0] == 0
    col_idx: torch.Tensor  # int32[nnz]
    vals: torch.Tensor     # float32[nnz]
    n_rows: int
    n_cols: int
    distinct_cols: Optional[int] = None  # columns A references, counted on the host

    @property
    def device(self) -> torch.device:
        return self.vals.device


def prepare_sparse_operand(a: HostCSR, device) -> SparseOperand:
    """Host CSR -> device operand (the counterpart of tile_sparse_operand),
    with the number of distinct columns A references, counted on the host.
    Raises ValueError on an integer value >= 2^24."""
    row_ptr, col_idx, vals = a.to_device(device)
    distinct = int(np.count_nonzero(np.bincount(a.col_idx, minlength=a.n_cols)))
    return SparseOperand(row_ptr, col_idx, vals, a.n_rows, a.n_cols, distinct)


def csr_spmm_bytes(n_rows: int, nnz: int, distinct_cols: int, width_in: int, width_out: int,
                   value_bytes: int) -> int:
    """The least bytes of C = A x P with A in CSR: A's row offsets and
    columns (4 B each), its values and any other array of A the kernel
    reads (``value_bytes`` in all), each distinct P row that A references
    read once (``width_in`` f32) and C written once (``width_out`` f32 a
    row)."""
    return (4 * (n_rows + 1) + 4 * nnz + value_bytes + 4 * distinct_cols * width_in
            + 4 * n_rows * width_out)


def launch_bytes(op: SparseOperand, m: int) -> Optional[int]:
    """The least bytes of one ``spmm_dense_acc`` launch with P of ``m``
    columns (``csr_spmm_bytes``); None where the operand's distinct columns
    were not counted (``row_slice``, ``SparseOperand`` built by hand)."""
    if op.distinct_cols is None:
        return None
    nnz = op.col_idx.numel()
    return csr_spmm_bytes(op.n_rows, nnz, op.distinct_cols, m, m, 4 * nnz)


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
    a chain can ping-pong two buffers.  On the CPU: the plain version.  Under
    a profiler the launch is the span ``kernel/spmm_dense_acc`` with its
    ``launch_bytes`` (``obs``)."""
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
    with torch.cuda.device(p.device), obs.kernel("spmm_dense_acc", launch_bytes, op, m):
        err = lib.spmm_dense_acc_f32(
            op.row_ptr.data_ptr(), op.col_idx.data_ptr(), op.vals.data_ptr(),
            p.data_ptr(), out.data_ptr(), n_rows, m,
            torch.cuda.current_stream(p.device).cuda_stream)
    if err != 0:
        raise RuntimeError("spmm_dense_acc launch failed: "
                           + lib.spmm_error_string(err).decode())
    LAUNCHES += 1
    return out


def csr_panel_rows(panel_cols: int) -> int:
    """Rows of C a block of the CSR-panel kernel owns at panels of
    ``panel_cols``: as many accumulator rows of min(panel_cols, 8,192)
    floats (rounded up to 4) as fit the block's 8,192 (32 KiB of shared
    memory), 1 to 32 (``csrc/spmm_dense_acc_csr_panel.cu``'s kBlockFloats
    and kMaxRows)."""
    chunk = min(-(-panel_cols // 4) * 4, 8192)
    return max(1, min(8192 // chunk, 32))


def csr_panel_order(op: SparseOperand, b_row_nnz: torch.Tensor, rows: int) -> torch.Tensor:
    """int32: A's blocks of ``rows`` rows, most products first (each entry
    (i, k) of A makes ``b_row_nnz[k]`` over the panels), the order in which
    the CSR-panel kernel starts them, so that the blocks of hub rows do not
    start last and hold the launch alone."""
    made = torch.cat([b_row_nnz.new_zeros(1), torch.cumsum(b_row_nnz[op.col_idx.long()], 0)])
    edges = op.row_ptr.long()[torch.arange(0, op.n_rows + rows, rows,
                                           device=op.device).clamp_(max=op.n_rows)]
    return torch.argsort(made[edges[1:]] - made[edges[:-1]], descending=True, stable=True).int()


@dataclasses.dataclass(frozen=True)
class CsrPanels:
    """The right operand B of the CSR-panel form, for column panels of
    ``panel_cols`` (the last one ragged): B's columns and its values in the
    f32 carrier at every slot, ``offsets[k, p]``, the first slot of B's row
    k whose column is at least min(p * panel_cols, n_cols), so row k's
    entries in panel p are slots [offsets[k, p], offsets[k, p + 1]), and
    the kernel's order of A's row blocks (``csr_panel_order``)."""

    col_idx: torch.Tensor  # int32[capacity]
    vals: torch.Tensor     # float32[capacity]
    offsets: torch.Tensor  # int32[k, panels + 1]
    order: torch.Tensor    # int32[ceil(n / rows_per_block)]
    rows_per_block: int
    n_cols: int
    panel_cols: int
    panel_nnz: Tuple[int, ...]  # B's entries in each panel, read to the host

    @property
    def panels(self) -> int:
        return self.offsets.shape[1] - 1

    def panel(self, p: int) -> Tuple[int, int]:
        """(lo, w): panel p's first column and its width."""
        lo = p * self.panel_cols
        return lo, min(self.panel_cols, self.n_cols - lo)


def csr_panel_bytes(op: SparseOperand, b: CsrPanels, p: int) -> int:
    """The least bytes of one ``spmm_dense_acc_csr_panel`` launch: A's row
    offsets, columns and values once, B's two offsets of panel p a row, each
    entry of B in the panel once (its column and f32 value, 8 B) and the C
    panel written once."""
    nnz = op.col_idx.numel()
    return (csr_spmm_bytes(op.n_rows, nnz, 0, 0, b.panel(p)[1], 4 * nnz)
            + 8 * b.offsets.shape[0] + 8 * b.panel_nnz[p])


def spmm_dense_acc_csr_panel_reference(op: SparseOperand, b: CsrPanels, p: int) -> torch.Tensor:
    """Plain PyTorch panel p of C = A x B in f32, from the same table: each
    entry (i, k, a) of A repeated once for each entry (k, j, v) of B's row k
    in the panel, and a * v index_add-ed at (i, j - lo) of an (n, w) panel.
    It materialises every product of the panel, so on the card it is for
    comparisons."""
    lo, w = b.panel(p)
    start = b.offsets[:, p].long()
    seg = b.offsets[:, p + 1].long() - start
    k = op.col_idx.long()
    reps = seg[k]  # B's entries in the panel for each entry of A
    e = torch.repeat_interleave(torch.arange(k.numel(), device=k.device), reps)
    first = torch.cumsum(reps, 0) - reps
    slot = start[k][e] + torch.arange(e.numel(), device=k.device) - first[e]
    at = _entry_rows(op)[e] * w + (b.col_idx[slot].long() - lo)
    out = torch.zeros(op.n_rows * w, dtype=torch.float32, device=op.device)
    return out.index_add_(0, at, op.vals[e] * b.vals[slot]).view(op.n_rows, w)


def _check_csr_panel(op: SparseOperand, b: CsrPanels, p: int) -> None:
    dev = op.device
    for name, t, dtype in (("A.row_ptr", op.row_ptr, torch.int32),
                           ("A.col_idx", op.col_idx, torch.int32),
                           ("A.vals", op.vals, torch.float32),
                           ("B.col_idx", b.col_idx, torch.int32),
                           ("B.vals", b.vals, torch.float32),
                           ("B.offsets", b.offsets, torch.int32),
                           ("the order", b.order, torch.int32)):
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype} on {dev}, "
                             f"got {t.dtype} on {t.device}")
    if op.row_ptr.numel() != op.n_rows + 1 or op.col_idx.numel() != op.vals.numel():
        raise ValueError("A's row_ptr, col_idx and vals disagree in size")
    if b.col_idx.dim() != 1 or b.col_idx.shape != b.vals.shape:
        raise ValueError("B's col_idx and vals must be 1-D of one size")
    if b.offsets.dim() != 2 or b.offsets.shape[0] != op.n_cols:
        raise ValueError(f"B's offsets must be ({op.n_cols}, panels + 1), "
                         f"got {tuple(b.offsets.shape)}")
    if not 0 <= p < b.panels:
        raise ValueError(f"panel {p} outside B's {b.panels} panels")
    if b.order.shape != (-(-op.n_rows // b.rows_per_block),):
        raise ValueError(f"the order must hold A's blocks of {b.rows_per_block} rows, "
                         f"got {tuple(b.order.shape)}")


def spmm_dense_acc_csr_panel(op: SparseOperand, b: CsrPanels, p: int) -> torch.Tensor:
    """Panel p of C = A x B, an (n, w) f32 tensor, B read from its CSR.
    On CUDA: one launch of the hand-written kernel on the current stream,
    without synchronising, counted in ``LAUNCHES`` and
    ``CSR_PANEL_LAUNCHES``; under a profiler the span
    ``kernel/spmm_dense_acc`` with its ``csr_panel_bytes``.  On the CPU: the
    plain version.  The kernel takes the integer semirings' values, whole
    and non-negative (A's below 2^24, as ``ops/denseacc.plan_dense_acc``
    checks), and sums them in no fixed order: exact while every value of
    the panel stays below 2^24, and a panel that reaches 2^24 holds a value
    at or above it, which the caller's check of the panel finds."""
    global LAUNCHES, CSR_PANEL_LAUNCHES
    _check_csr_panel(op, b, p)
    dev = op.device
    if dev.type == "cpu":
        return spmm_dense_acc_csr_panel_reference(op, b, p)
    if dev.type != "cuda":
        raise ValueError(f"spmm_dense_acc_csr_panel runs on cpu or cuda, not {dev}")
    lo, w = b.panel(p)
    out = torch.empty(op.n_rows, w, dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    if op.n_rows >= 2**31:
        raise ValueError(f"{op.n_rows} rows exceed the kernel's launch grid")
    lib = _build.load()
    with torch.cuda.device(dev), obs.kernel("spmm_dense_acc", csr_panel_bytes, op, b, p):
        err = lib.spmm_dense_acc_csr_panel_f32(
            op.row_ptr.data_ptr(), op.col_idx.data_ptr(), op.vals.data_ptr(),
            b.col_idx.data_ptr(), b.vals.data_ptr(), b.offsets.data_ptr(), b.panels + 1, p,
            b.order.data_ptr(), b.rows_per_block, out.data_ptr(), op.n_rows, lo, w,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("spmm_dense_acc_csr_panel launch failed: "
                           + lib.spmm_error_string(err).decode())
    LAUNCHES += 1
    CSR_PANEL_LAUNCHES += 1
    return out


def densify(op: SparseOperand, n_cols: Optional[int] = None) -> torch.Tensor:
    """Dense (n_rows, n_cols) f32 copy of A, scattered on A's device (the
    chain's P0)."""
    n_cols = op.n_cols if n_cols is None else n_cols
    out = torch.zeros(op.n_rows, n_cols, dtype=torch.float32, device=op.device)
    out[_entry_rows(op), op.col_idx.long()] = op.vals
    return out
