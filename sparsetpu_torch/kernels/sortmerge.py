"""Per-row sort + saturating merge + pack: the port of
``sparsetpu/kernels/sortmerge.py``, the numeric kernel of the
row-categorized SpGEMM (``ops/rowcat.py``).

For each row of an (R, L) slab of (column int32, value) pairs:
sort by column (sentinel columns last), merge equal columns with the
semiring's saturating add, drop sentinels and zero totals, and pack the
survivors to the front in ascending column order, the rest of the row
``(INT32_SENTINEL, 0)``.  Values are the port's limbs: u64 as (lo, hi)
int64 tensors, u32 as one int64 tensor, f32 as one float32 tensor.

On a CUDA tensor ``sortmerge_rows`` launches the hand-written kernel
``csrc/sortmerge_rows.cu`` (the counterpart of ``_kernel``): one block per
row (or per 2048 / L rows), staged in shared memory, for L a power of two up
to ``MAX_L`` = 16,384, beyond JAX's 2,048.  On a CPU tensor it runs the plain
version ``sortmerge_rows_reference``: JAX's batched formulation (sort along
the rows, the lane-axis segmented scan, a second sort to pack), which is
also the route of ``ops/rowcat.py`` with ``use_kernel=False``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops import segments
from ..ops.segments import INT32_SENTINEL
from ..semiring import Value, by_name
from . import _build

MAX_L = 16384  # the longest row one block's shared memory holds (12 B a slot)
LAUNCHES = 0   # kernel launches by sortmerge_rows (CUDA tensors only)
_MODE = {"u64": 0, "u32": 1, "f32": 2}


def available(L: int, nlimbs: int) -> bool:
    """True when the kernel takes rows of L slots with ``nlimbs`` limbs."""
    return 1 <= L <= MAX_L and (L & (L - 1)) == 0 and nlimbs in (1, 2)


def _check(cols: torch.Tensor, limbs: Value, sr_name: str) -> None:
    sr = by_name(sr_name)
    if cols.dtype != torch.int32 or cols.dim() != 2 or not cols.is_contiguous():
        raise ValueError(f"cols must be a contiguous 2-D int32 tensor, got "
                         f"{cols.dtype} {tuple(cols.shape)}")
    if len(limbs) != sr.nlimbs:
        raise ValueError(f"{sr_name} takes {sr.nlimbs} limbs, got {len(limbs)}")
    for x in limbs:
        if (x.dtype != sr.dtype or x.shape != cols.shape or not x.is_contiguous()
                or x.device != cols.device):
            raise ValueError(f"each limb must be a contiguous {sr.dtype} tensor of "
                             f"shape {tuple(cols.shape)} on {cols.device}")


def sortmerge_rows_reference(cols: torch.Tensor, limbs: Value,
                             sr_name: str) -> Tuple[torch.Tensor, Value]:
    """Plain PyTorch sort-merge-pack of every row (any L): a stable sort
    along the rows, the semiring's segmented running sums along the rows,
    the keep mask, and a second sort that packs the kept columns first."""
    sr = by_name(sr_name)
    cols_s, perm = torch.sort(cols, dim=1, stable=True)
    limbs_s = tuple(torch.gather(x, 1, perm) for x in limbs)
    prev = torch.cat([cols_s.new_full((cols_s.shape[0], 1), -1), cols_s[:, :-1]], dim=1)
    head = cols_s != prev
    totals, _ = segments.segment_reduce_sorted(sr, head, limbs_s, axis=1)
    tail = torch.cat([head[:, 1:], head.new_ones((head.shape[0], 1))], dim=1)
    keep = tail & (cols_s != INT32_SENTINEL) & ~sr.is_zero(totals)
    keyed = torch.where(keep, cols_s, INT32_SENTINEL)
    packed, perm2 = torch.sort(keyed, dim=1, stable=True)
    return packed, tuple(torch.gather(torch.where(keep, x, 0), 1, perm2) for x in totals)


def sortmerge_rows(cols: torch.Tensor, limbs: Value,
                   sr_name: str) -> Tuple[torch.Tensor, Value]:
    """cols (R, L) int32 and the semiring's limbs -> (sorted, merged and
    packed cols, limbs), new tensors.  On CUDA: one launch of the kernel on
    the current stream, without synchronising, for L with
    ``available(L, nlimbs)``; it raises on any other shape.  On the CPU: the
    plain version."""
    global LAUNCHES
    _check(cols, limbs, sr_name)
    if cols.device.type == "cpu":
        return sortmerge_rows_reference(cols, limbs, sr_name)
    if cols.device.type != "cuda":
        raise ValueError(f"sortmerge_rows runs on cpu or cuda, not {cols.device}")
    R, L = cols.shape
    if not available(L, len(limbs)):
        raise ValueError(f"the kernel takes rows of a power of two up to {MAX_L} "
                         f"slots, not {L}")
    out_cols = torch.empty_like(cols)
    out_limbs = tuple(torch.empty_like(x) for x in limbs)
    if R == 0:
        return out_cols, out_limbs
    lib = _build.load()
    lo, hi = limbs[0], limbs[-1]
    with torch.cuda.device(cols.device):
        err = lib.sortmerge_rows(
            cols.data_ptr(), lo.data_ptr(), hi.data_ptr(), out_cols.data_ptr(),
            out_limbs[0].data_ptr(), out_limbs[-1].data_ptr(), R, L, _MODE[sr_name],
            torch.cuda.current_stream(cols.device).cuda_stream)
    if err != 0:
        raise RuntimeError("sortmerge_rows launch failed: "
                           + lib.spmm_error_string(err).decode())
    LAUNCHES += 1
    return out_cols, out_limbs
