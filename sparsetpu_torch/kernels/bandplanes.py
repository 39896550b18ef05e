"""Fold-band SpMM, C_band = A x P_band: the port of ``sparsetpu/kernels/bandplanes.py``.

A^k of a banded A is banded: row i of A^k has support only in the columns
[i - k*h, i + k*h], h being A's half-width.  The fold (``fold_perm``)
relabels a Moore torus so that its wrap edges become local and A becomes a
pure band; each chain step then stores and moves only a window of every row
instead of the full row.

Layout.  A band matrix is a row-major (n, w) f32 tensor plus an int32
``base[n]`` of absolute column starts: entry (i, j) of the window is column
``base[i] + j``.  ``band_layout`` quantises the starts to ``quantum`` columns
(32 on the GPU: 128 B, so every window start keeps 16-byte loads aligned;
1024 reproduces the JAX package's 8-plane layout, whose (n, S, 128) planes
``interop.band_from_jax_planes`` reads).

Chaining slack: none.  The TPU kernel adds the whole (s_in, 128) input window
to the output at an unmasked offset, so JAX widens every output window by
the worst source offset (``min_s``, ``bandplanes.py:85-89``).  The port's
kernel gathers: output column j of row i reads ``P_in[c, j - dp]``,
dp = base_in[c] - base_out[i], only where that index lies in [0, w_in).  Each
output window then covers just its row's true support, the columns outside
a row's support hold zeros, and the masked-off input columns are zeros of
the source row (``prepare_band_operand`` checks this from the half-widths).

On a CUDA tensor ``spmm_band`` launches the hand-written kernel
``csrc/spmm_band.cu`` (the counterpart of ``_band_kernel``); on a CPU tensor
it runs the plain version ``spmm_band_reference``.  Exactness: integers in
f32, exact below 2^24 (``prepare_sparse_operand`` guards A, ``bench/chain.py``
the products).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build
from .spmm import SparseOperand, _entry_rows, check_out

QUANTUM = 32  # the GPU chain's window quantum, in columns (128 B)

LAUNCHES = 0  # kernel launches by spmm_band (CUDA tensors only)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def fold_perm(dims: Sequence[int]) -> np.ndarray:
    """Boustrophedon node relabeling: perm[old_flat] = new_flat.

    Per dimension of size d: sigma(x) = 2x for x < ceil(d/2) else
    2(d-x)-1, so wrap neighbours (0, d-1) land at labels (0, 1) and interior
    neighbours differ by <= 2: a torus edge's folded flat offset is bounded
    by 2 * sum(strides)."""
    dims = list(dims)

    def sigma(d):
        x = np.arange(d)
        return np.where(x < -(-d // 2), 2 * x, 2 * (d - x) - 1)

    coords = np.indices(dims).reshape(len(dims), -1)
    new = np.zeros(coords.shape[1], np.int64)
    for axis, d in enumerate(dims):
        new = new * d + sigma(d)[coords[axis]]
    return new


def band_halfwidth(rows: np.ndarray, cols: np.ndarray) -> int:
    """Max |i - j| over entries (the linear band half-width)."""
    if len(rows) == 0:
        return 0
    return int(np.abs(rows.astype(np.int64) - cols.astype(np.int64)).max())


def band_layout(n: int, h: int, total: int,
                quantum: int = QUANTUM) -> Tuple[np.ndarray, int]:
    """(base int32[n], w) in columns: the windows of an n-row band matrix of
    half-width h whose rows are ``total`` columns wide (a multiple of
    ``quantum``).

    base[i] is i - h rounded down to a multiple of ``quantum`` and clipped to
    [0, total - w].  w is the window rounded to a lane (min(quantum, 128)
    columns) plus one lane of slack, plus one quantum for the rounding of
    base, rounded to the quantum and capped at ``total``: at quantum 1024
    this is JAX's ``band_layout`` (with no ``min_s``) times 128.  Raises
    ValueError if a row's true window [i - h, i + h] does not fit its
    columns."""
    if total % quantum:
        raise ValueError(f"total {total} is not a multiple of the quantum {quantum}")
    lane = min(quantum, 128)
    i = np.arange(n, dtype=np.int64)
    base = quantum * np.floor_divide(i - h, quantum)
    w = min(_round_up(_round_up(2 * h + 1, lane) + lane, quantum) + quantum, total)
    base = np.clip(base, 0, total - w).astype(np.int32)
    lo = np.maximum(i - h, 0)
    top = np.minimum(i + h, n - 1)
    if not ((lo >= base) & (top < base.astype(np.int64) + w)).all():
        raise ValueError(f"band layout broken: half-width {h} does not fit "
                         f"windows of {w} of {total} columns")
    return base, w


@dataclasses.dataclass(frozen=True)
class BandOperand:
    """A on a device with the in and out layouts of one chain step."""

    a: SparseOperand
    base_in: torch.Tensor   # int32[a.n_cols], window start of each P_in row
    base_out: torch.Tensor  # int32[a.n_rows], window start of each C row
    w_in: int
    w_out: int
    aligned4: bool  # every window start is a multiple of 4 columns


def prepare_band_operand(op: SparseOperand, base_in: np.ndarray, w_in: int,
                         base_out: np.ndarray, w_out: int,
                         h_in: int) -> BandOperand:
    """The band operand of one step (the counterpart of tile_band_operand).

    The kernel computes each entry's offset dp = base_in[col] - base_out[row]
    itself; here, on the host, every entry (i, c) is checked as JAX asserts
    it, and a failure raises ValueError:
      - dp >= 0: no source window starts left of its output window;
      - the window fits: the columns of source row c that can be nonzero,
        [c - h_in, c + h_in] within its stored window, lie inside row i's
        output window, so the kernel's masking drops only zeros.
    A's values are guarded below 2^24 by ``prepare_sparse_operand``."""
    base_in = np.asarray(base_in, np.int64)
    base_out = np.asarray(base_out, np.int64)
    if base_in.shape != (op.n_cols,) or base_out.shape != (op.n_rows,):
        raise ValueError(f"bases of {base_in.shape} and {base_out.shape} do not "
                         f"match A's ({op.n_rows}, {op.n_cols})")
    if w_in < 1 or w_out < 1 or base_in.min(initial=0) < 0 or base_out.min(initial=0) < 0:
        raise ValueError("band windows must be nonempty and start at column >= 0")
    row_ptr = op.row_ptr.cpu().numpy().astype(np.int64)
    rows = np.repeat(np.arange(op.n_rows, dtype=np.int64), np.diff(row_ptr))
    cols = op.col_idx.cpu().numpy().astype(np.int64)
    dp = base_in[cols] - base_out[rows]
    if (dp < 0).any():
        raise ValueError("band layout broken: a source window starts left of "
                         "its output window (dp < 0)")
    lo = np.maximum(cols - h_in, base_in[cols])
    hi = np.minimum(cols + h_in, base_in[cols] + w_in - 1)
    if ((lo < base_out[rows]) | (hi >= base_out[rows] + w_out)).any():
        raise ValueError(f"band layout broken: a source row's support (half-width "
                         f"{h_in}) leaves its output window of {w_out} columns")
    dev = op.device
    return BandOperand(
        op,
        torch.from_numpy(base_in.astype(np.int32)).to(dev),
        torch.from_numpy(base_out.astype(np.int32)).to(dev),
        int(w_in), int(w_out),
        bool((base_in % 4 == 0).all() and (base_out % 4 == 0).all()),
    )


def spmm_band_reference(bop: BandOperand, p: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch C_band = A x P_band in f32: for every entry, gather the
    source row's window at the output window's columns (zero where it has
    none), scale, and index_add into C.  It materialises (nnz, w_out)
    gathers, so on the card it is for comparisons at small shapes."""
    op = bop.a
    rows = _entry_rows(op)
    cols = op.col_idx.long()
    dp = bop.base_in.long()[cols] - bop.base_out.long()[rows]
    src = torch.arange(bop.w_out, device=p.device)[None, :] - dp[:, None]
    inside = (src >= 0) & (src < bop.w_in)
    gathered = p[cols[:, None], src.clamp(0, bop.w_in - 1)] * inside
    out = torch.zeros(op.n_rows, bop.w_out, dtype=torch.float32, device=p.device)
    return out.index_add_(0, rows, op.vals[:, None] * gathered)


def _check(bop: BandOperand, p: torch.Tensor, out: Optional[torch.Tensor]) -> None:
    op = bop.a
    if p.dtype != torch.float32 or tuple(p.shape) != (op.n_cols, bop.w_in):
        raise ValueError(f"P_band must be float32 {(op.n_cols, bop.w_in)}, "
                         f"got {p.dtype} {tuple(p.shape)}")
    if not p.is_contiguous():
        raise ValueError("P_band must be contiguous (row-major)")
    for name, t in (("row_ptr", op.row_ptr), ("col_idx", op.col_idx),
                    ("vals", op.vals), ("base_in", bop.base_in),
                    ("base_out", bop.base_out)):
        if t.device != p.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {p.device}, got {t.device}")
    check_out(out, (op.n_rows, bop.w_out), p)


def spmm_band(bop: BandOperand, p: torch.Tensor,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """C_band = A x P_band: P_band is (n_cols, w_in) in the step's input
    layout, C_band (n_rows, w_out) in its output layout.  On CUDA: one launch
    of the hand-written kernel on the current stream, without synchronising.
    On the CPU: the plain version."""
    global LAUNCHES
    _check(bop, p, out)
    if p.device.type == "cpu":
        c = spmm_band_reference(bop, p)
        return c if out is None else out.copy_(c)
    if p.device.type != "cuda":
        raise ValueError(f"spmm_band runs on cpu or cuda, not {p.device}")
    op = bop.a
    if out is None:
        out = torch.empty(op.n_rows, bop.w_out, dtype=torch.float32, device=p.device)
    if out.numel() == 0:
        return out
    lib = _build.load()
    if op.n_rows >= 2**31 or bop.w_out > lib.spmm_band_max_cols():
        raise ValueError(f"({op.n_rows}, {bop.w_out}) exceeds the kernel's launch grid")
    with torch.cuda.device(p.device):
        err = lib.spmm_band_f32(
            op.row_ptr.data_ptr(), op.col_idx.data_ptr(), op.vals.data_ptr(),
            bop.base_in.data_ptr(), bop.base_out.data_ptr(),
            p.data_ptr(), out.data_ptr(), op.n_rows, bop.w_in, bop.w_out,
            int(bop.aligned4), torch.cuda.current_stream(p.device).cuda_stream)
    if err != 0:
        raise RuntimeError("spmm_band launch failed: " + lib.spmm_error_string(err).decode())
    LAUNCHES += 1
    return out


def csr_to_band(op: SparseOperand, base: np.ndarray, w: int) -> torch.Tensor:
    """Scatter of a (folded) CSR matrix into its band layout, (n_rows, w) f32
    on the operand's device.  Raises ValueError if an entry lies outside its
    row's window."""
    rows = _entry_rows(op)
    base_t = torch.from_numpy(np.asarray(base, np.int64)).to(op.device)
    off = op.col_idx.long() - base_t[rows]
    if bool(((off < 0) | (off >= w)).any()):
        raise ValueError("an entry lies outside its row's band window")
    out = torch.zeros(op.n_rows * w, dtype=torch.float32, device=op.device)
    out[rows * w + off] = op.vals
    return out.view(op.n_rows, w)


def band_to_dense(p: torch.Tensor, base: np.ndarray, n_cols: int) -> torch.Tensor:
    """Unfold a band matrix to the dense (n, n_cols) f32 on its device (the
    counterpart of band_to_planes).  Rows that share a window start are
    copied as one slice."""
    n, w = p.shape
    base = np.asarray(base, np.int64)
    total = max(n_cols, int(base.max(initial=0)) + w)
    out = torch.zeros(n, total, dtype=torch.float32, device=p.device)
    if n:
        starts = np.flatnonzero(np.r_[True, base[1:] != base[:-1]])
        for r0, r1 in zip(starts, np.r_[starts[1:], n]):
            b = int(base[r0])
            out[r0:r1, b:b + w] = p[r0:r1]
    return out[:, :n_cols]
