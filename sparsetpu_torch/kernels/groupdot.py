"""Group-dot SpMM, C = A x P by per-group contractions: the port of the MXU
variant in ``sparsetpu/kernels/spmm_pallas.py`` (``_spmm_mxu_kernel``).

A's entries are cut into output-row tiles of R rows; each tile's entry
stream, in CSR order, is padded to a nonzero multiple of 2G and cut into
groups of G entries.  Group q holds G column indices and an (R, G) matrix M
with M[local_row_e, e mod G] = val_e, and the product is

    C[tile rows, :] += M_q (R, G) @ P[cols_q, :] (G, m)     for every group q,

so G per-entry FMAs become one small dense contraction (on the TPU, one MXU
pass).  Padded entries have column 0 and value 0, as on the TPU.

The port stores the groups ragged (``group_ptr`` per tile) instead of JAX's
(T, ngmax * R, G) array padded to the longest tile, and beside them the
kernel's forms: M as u8 with its slots zero-padded to a multiple of 32, and
each tile's count of real entries.  On a CUDA tensor ``spmm_group_dot``
launches the hand-written kernel ``csrc/spmm_group_dot.cu``, which runs the
contractions on the int8 tensor cores, exactly: P split into three u8 limbs,
s32 sums, recombined in int64.  On a CPU tensor it runs
``spmm_group_dot_limbs_reference``, the same limb arithmetic in plain
torch.  ``spmm_group_dot_reference`` is the f32 form of the same product.

Exactness: A's values below 2^8 (guarded here, as JAX does) and every P value
an integer in [0, 2^24), integers carried in f32.  The f32 form computes any
P; the limb forms do not: on the CPU a P outside that domain raises
ValueError, and on the card the kernel writes NaN over every output tile
(R rows x 16 columns) whose gathered values include one (ROADMAP queue 3, a
divergence kept on purpose).
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
MAX_G = 128          # the kernel walks a group in at most 4 k-steps of 32 slots
K_STEP = 32          # slots of one u8 tensor-core step: M's u8 rows are padded to it
N_LIMBS = 3          # u8 limbs of a P value below 2^24
POISON_COLS = 16     # columns of the output tile the kernel poisons as one (a warp's)

LAUNCHES = 0  # kernel launches by spmm_group_dot (CUDA tensors only)


@dataclasses.dataclass(frozen=True)
class GroupOperand:
    """A on a device as tiles of groups, in the kernel's types."""

    group_ptr: torch.Tensor  # int32[n_tiles + 1]: tile t has groups [ptr[t], ptr[t+1])
    cols: torch.Tensor       # int32[n_groups * g]: the P row of every slot
    m: torch.Tensor          # float32[n_groups, rows_per_tile, g]
    m8: torch.Tensor         # uint8[n_groups, rows_per_tile, kpad]: m, slots 0-padded
    count: torch.Tensor      # int32[n_tiles]: real entries (the leading slots) a tile
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
    the entry stream padded to a nonzero multiple of 2g and its count of
    real entries, and per group its (R, g) matrix, in f32 and as the
    kernel's u8 (R, kpad), kpad = g rounded up to a multiple of 32.  The last
    tile may be partial (JAX's ``pad_rows``).
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
    m8 = np.zeros((n_groups, r, -(-g // K_STEP) * K_STEP), np.uint8)
    m8[:, :, :g] = m
    return GroupOperand(
        torch.from_numpy(group_ptr.astype(np.int32)).to(device),
        torch.from_numpy(cols).to(device), torch.from_numpy(m).to(device),
        torch.from_numpy(m8).to(device), torch.from_numpy(counts.astype(np.int32)).to(device),
        a.n_rows, a.n_cols, r, g)


def _sum_tiles(gop: GroupOperand, prod: torch.Tensor) -> torch.Tensor:
    """(n_groups, R, m) group products -> (n_rows, m), each tile's groups
    added (in prod's type)."""
    m_cols = prod.shape[2]
    tile_of_group = torch.repeat_interleave(
        torch.arange(gop.n_tiles, device=prod.device), torch.diff(gop.group_ptr).long())
    out = torch.zeros(gop.n_tiles, gop.rows_per_tile, m_cols, dtype=prod.dtype,
                      device=prod.device)
    out.index_add_(0, tile_of_group, prod)
    return out.view(-1, m_cols)[:gop.n_rows]


def spmm_group_dot_reference(gop: GroupOperand, p: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch C = A x P in f32: gather every group's G P rows and
    contract them with its (R, G) matrix in one batched product, then add the
    groups of each tile.  It materialises (n_groups, G, m) and (n_groups, R,
    m), so on the card it is for comparisons at small shapes.  A TF32 product
    would not be exact, so on CUDA it raises while TF32 is enabled."""
    if p.device.type == "cuda" and tf32_enabled():
        raise RuntimeError("TF32 is enabled for float32 products; the plain "
                           "group-dot version would not be exact")
    b = p[gop.cols.long()].view(gop.n_groups, gop.g, p.shape[1])
    return _sum_tiles(gop, torch.bmm(gop.m, b))


def _check_p_domain(p: torch.Tensor) -> None:
    """Raise ValueError unless every value of P is an integer in [0, 2^24),
    the domain of the limb split (NaN and inf are outside it)."""
    ok = (p >= 0) & (p < F32_EXACT_LIMIT) & (p == torch.floor(p))
    if not bool(ok.all()):
        raise ValueError("group-dot spmm needs every P value an integer in [0, 2^24) "
                         "(three u8 limbs)")


def spmm_group_dot_limbs_reference(gop: GroupOperand, p: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch C = A x P with the kernel's arithmetic: M as u8, every
    gathered P value split into limbs p_k = (p >> 8k) & 255, one batched
    integer product a limb, the limb sums recombined as S_0 + (S_1 << 8) +
    (S_2 << 16) in int64 and rounded to f32 once.  The products run in int64
    on the CPU; on the card, which has no integer batched product, in
    float64, exact here (every limb sum stays below 2^53).  Raises
    ValueError on a P value outside [0, 2^24) or not an integer."""
    _check_p_domain(p)
    work = torch.int64 if p.device.type == "cpu" else torch.float64
    m = gop.m8[:, :, :gop.g].to(work)
    u = p[gop.cols.long()].view(gop.n_groups, gop.g, p.shape[1]).to(torch.int64)
    total = None
    for k in range(N_LIMBS):
        s_k = torch.bmm(m, ((u >> (8 * k)) & 255).to(work)).to(torch.int64) << (8 * k)
        total = s_k if total is None else total + s_k
    return _sum_tiles(gop, total).to(torch.float32)


def _check(gop: GroupOperand, p: torch.Tensor, out: Optional[torch.Tensor]) -> None:
    if p.dtype != torch.float32 or p.dim() != 2 or p.shape[0] != gop.n_cols:
        raise ValueError(f"P must be float32 with {gop.n_cols} rows, "
                         f"got {p.dtype} {tuple(p.shape)}")
    if not p.is_contiguous():
        raise ValueError("P must be contiguous (row-major)")
    for name, t in (("group_ptr", gop.group_ptr), ("cols", gop.cols), ("m", gop.m),
                    ("m8", gop.m8), ("count", gop.count)):
        if t.device != p.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {p.device}, got {t.device}")
    check_out(out, (gop.n_rows, p.shape[1]), p)


def spmm_group_dot(gop: GroupOperand, p: torch.Tensor,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """C = A x P for P of integers in [0, 2^24).  On CUDA: one launch of the
    hand-written kernel on the current stream, without synchronising; a
    warp that meets a P value outside the domain writes NaN over its output
    tile (R rows x 16 columns).  ``out`` (if given) receives C.  On the CPU: the plain limb
    version, which raises ValueError on such a P."""
    global LAUNCHES
    _check(gop, p, out)
    if p.device.type == "cpu":
        c = spmm_group_dot_limbs_reference(gop, p)
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
        err = lib.spmm_group_dot_u8(
            gop.group_ptr.data_ptr(), gop.count.data_ptr(), gop.cols.data_ptr(),
            gop.m8.data_ptr(), p.data_ptr(), out.data_ptr(), gop.n_tiles, gop.n_rows, m_cols,
            gop.rows_per_tile, gop.g, torch.cuda.current_stream(p.device).cuda_stream)
    if err != 0:
        raise RuntimeError("spmm_group_dot launch failed: "
                           + lib.spmm_error_string(err).decode())
    LAUNCHES += 1
    return out
