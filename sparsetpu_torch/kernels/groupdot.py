"""Group-dot SpMM, C = A x P by per-group contractions: the port of the MXU
variant in ``sparsetpu/kernels/spmm_pallas.py`` (``_spmm_mxu_kernel``).

A's entries are cut into output-row tiles of R rows; each tile's entry
stream, in CSR order, is padded to a nonzero multiple of 2G and cut into
groups of G entries.  Group q holds G column indices and an (R, G) matrix M
with M[local_row_e, e mod G] = val_e, and the product is

    C[tile rows, :] += M_q (R, G) @ P[cols_q, :] (G, m)     for every group q,

so G per-entry FMAs become one small dense contraction (on the TPU, one MXU
pass).  Padded entries have column 0 and value 0: their P rows are read and
multiplied by zero, as on the TPU.

The port stores the groups ragged (``group_ptr`` per tile) instead of JAX's
(T, ngmax * R, G) array padded to the longest tile.  On a CUDA tensor
``spmm_group_dot`` launches the hand-written kernel
``csrc/spmm_group_dot.cu`` (fp32 FMAs, never TF32); on a CPU tensor it runs
the plain version ``spmm_group_dot_reference``.  Exactness as JAX states it:
A's values below 2^8, P's below 2^24, integers carried in f32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..csr import F32_EXACT_LIMIT, HostCSR
from . import _build
from .spmm import check_out, tf32_enabled

G = 32               # entries per group (JAX's G_MXU)
ROWS_PER_TILE = 40   # R, as bench.py passes it at 30^3
_R_SUPPORTED = range(8, 65, 8)  # the kernel's compiled tile heights
MAX_G = 128          # the kernel stages G * (R + 1) words of shared memory

LAUNCHES = 0  # kernel launches by spmm_group_dot (CUDA tensors only)


@dataclasses.dataclass(frozen=True)
class GroupOperand:
    """A on a device as tiles of groups, in the kernel's types."""

    group_ptr: torch.Tensor  # int32[n_tiles + 1]: tile t has groups [ptr[t], ptr[t+1])
    cols: torch.Tensor       # int32[n_groups * g]: the P row of every slot
    m: torch.Tensor          # float32[n_groups, rows_per_tile, g]
    n_rows: int
    n_cols: int
    rows_per_tile: int
    g: int

    @property
    def n_tiles(self) -> int:
        return self.group_ptr.numel() - 1

    @property
    def n_groups(self) -> int:
        return self.m.shape[0]


def prepare_group_operand(a: HostCSR, device, rows_per_tile: int = ROWS_PER_TILE,
                          g: int = G) -> GroupOperand:
    """Host prep of A (the counterpart of tile_sparse_operand_mxu): per tile
    the entry stream padded to a nonzero multiple of 2g, and per group its
    (R, g) matrix.  The last tile may be partial (JAX's ``pad_rows``).
    Raises ValueError on a value >= 2^24 or >= 2^8, as JAX does, and on a
    tile shape the kernel was not compiled for."""
    if rows_per_tile not in _R_SUPPORTED or not 1 <= g <= MAX_G:
        raise ValueError(f"rows_per_tile must be one of {list(_R_SUPPORTED)} and "
                         f"g in 1..{MAX_G}, got {rows_per_tile}, {g}")
    if a.nnz and float(a.vals.max()) >= F32_EXACT_LIMIT:
        raise ValueError("group-dot spmm requires values < 2^24")
    if a.nnz and float(a.vals.max()) >= 256.0:
        raise ValueError("group-dot spmm requires static-operand values < 2^8 "
                         "(exact tile matrix)")
    r = rows_per_tile
    n_tiles = -(-a.n_rows // r)
    rows = a.rows()
    tile = rows // r
    counts = np.bincount(tile, minlength=n_tiles)
    slots = np.maximum(-(-counts // (2 * g)) * (2 * g), 2 * g)
    group_ptr = np.concatenate([[0], np.cumsum(slots // g)])
    n_groups = int(group_ptr[-1])
    # slot of every entry: its tile's first slot + its place in the tile
    first_entry = a.row_ptr[np.arange(n_tiles) * r]
    slot = group_ptr[tile] * g + (np.arange(a.nnz) - first_entry[tile])
    cols = np.zeros(n_groups * g, np.int32)
    cols[slot] = a.col_idx
    m = np.zeros((n_groups, r, g), np.float32)
    m[slot // g, rows - tile * r, slot % g] = a.vals.astype(np.float32)
    return GroupOperand(
        torch.from_numpy(group_ptr.astype(np.int32)).to(device),
        torch.from_numpy(cols).to(device), torch.from_numpy(m).to(device),
        a.n_rows, a.n_cols, r, g)


def spmm_group_dot_reference(gop: GroupOperand, p: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch C = A x P: gather every group's G P rows and contract
    them with its (R, G) matrix in one batched product, then add the groups
    of each tile.  It materialises (n_groups, G, m) and (n_groups, R, m), so
    on the card it is for comparisons at small shapes.  A TF32 product would
    not be exact, so on CUDA it raises while TF32 is enabled."""
    if p.device.type == "cuda" and tf32_enabled():
        raise RuntimeError("TF32 is enabled for float32 products; the plain "
                           "group-dot version would not be exact")
    r, m_cols = gop.rows_per_tile, p.shape[1]
    b = p[gop.cols.long()].view(gop.n_groups, gop.g, m_cols)
    prod = torch.bmm(gop.m, b)
    tile_of_group = torch.repeat_interleave(
        torch.arange(gop.n_tiles, device=p.device), torch.diff(gop.group_ptr).long())
    out = torch.zeros(gop.n_tiles, r, m_cols, dtype=torch.float32, device=p.device)
    out.index_add_(0, tile_of_group, prod)
    return out.view(-1, m_cols)[:gop.n_rows]


def _check(gop: GroupOperand, p: torch.Tensor, out: Optional[torch.Tensor]) -> None:
    if p.dtype != torch.float32 or p.dim() != 2 or p.shape[0] != gop.n_cols:
        raise ValueError(f"P must be float32 with {gop.n_cols} rows, "
                         f"got {p.dtype} {tuple(p.shape)}")
    if not p.is_contiguous():
        raise ValueError("P must be contiguous (row-major)")
    for name, t in (("group_ptr", gop.group_ptr), ("cols", gop.cols), ("m", gop.m)):
        if t.device != p.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {p.device}, got {t.device}")
    check_out(out, (gop.n_rows, p.shape[1]), p)


def spmm_group_dot(gop: GroupOperand, p: torch.Tensor,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """C = A x P.  On CUDA: one launch of the hand-written kernel on the
    current stream, without synchronising; ``out`` (if given) receives C.
    On the CPU: the plain version."""
    global LAUNCHES
    _check(gop, p, out)
    if p.device.type == "cpu":
        c = spmm_group_dot_reference(gop, p)
        return c if out is None else out.copy_(c)
    if p.device.type != "cuda":
        raise ValueError(f"spmm_group_dot runs on cpu or cuda, not {p.device}")
    m_cols = p.shape[1]
    if out is None:
        out = torch.empty(gop.n_rows, m_cols, dtype=torch.float32, device=p.device)
    if out.numel() == 0:
        return out
    lib = _build.load()
    if gop.n_tiles >= 2**31 or m_cols > lib.spmm_group_dot_max_cols():
        raise ValueError(f"({gop.n_tiles} tiles, {m_cols}) exceeds the kernel's launch grid")
    with torch.cuda.device(p.device):
        err = lib.spmm_group_dot_f32(
            gop.group_ptr.data_ptr(), gop.cols.data_ptr(), gop.m.data_ptr(),
            p.data_ptr(), out.data_ptr(), gop.n_tiles, gop.n_rows, m_cols,
            gop.rows_per_tile, gop.g, torch.cuda.current_stream(p.device).cuda_stream)
    if err != 0:
        raise RuntimeError("spmm_group_dot launch failed: "
                           + lib.spmm_error_string(err).decode())
    LAUNCHES += 1
    return out
