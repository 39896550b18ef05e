"""Block-sparse matrices and SDD block scores: the port of
``sparsetpu/kernels/blocksparse.py``.

- ``BlockSparseMatrix``: packed storage of the present (bm, bn) tiles of a
  matrix, with their block rows and columns.
- ``sdd_block_scores``: the sampled dense-dense product
  ``out[t] = Q[qi[t]*bm : +bm] @ K[ki[t]*bn : +bn]^T`` for a list of block
  pairs, the block-sparse attention primitive.  On a CUDA tensor it launches
  the hand-written kernel ``csrc/sdd_block_scores.cu`` (the counterpart of
  ``_sdd_kernel``; fp32 FMAs, never TF32); on a CPU tensor it runs the plain
  version ``sdd_block_scores_reference``, a gather of the blocks and one
  batched product.
- ``block_sparse_attention_scores``: (b, s, h, d) Q and K -> the score blocks
  of the group-diagonal pairs whose Q and K blocks are both occupied, and
  ``scores_blocks_to_dense`` back to (b, s, h, h).

The pair list and the scatter back to (b, s, h, h) are vectorised with numpy
where the JAX package loops over groups in Python; the pairs are the same,
element for element.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..csr import DEFAULT_DEVICE, resolve_device
from . import _build
from .spmm import tf32_enabled

BLOCK = 128   # bm = bn on the attention path; the only size the kernel takes
LAUNCHES = 0  # kernel launches by sdd_block_scores (CUDA tensors only)


@dataclasses.dataclass(frozen=True)
class BlockSparseMatrix:
    """Packed block-sparse matrix: only present blocks are stored."""

    blocks: torch.Tensor      # f32[nblocks, bm, bn] dense tiles
    block_rows: torch.Tensor  # int32[nblocks] block row of each tile
    block_cols: torch.Tensor  # int32[nblocks] block column of each tile
    shape: Tuple[int, int]
    block_shape: Tuple[int, int]

    @property
    def nblocks(self) -> int:
        return self.blocks.shape[0]

    def density(self) -> float:
        bm, bn = self.block_shape
        total = (self.shape[0] // bm) * (self.shape[1] // bn)
        return self.nblocks / max(total, 1)

    def memory_bytes(self) -> int:
        """Storage: the tiles and two int32 indices a tile."""
        return int(self.blocks.numel() * 4 + self.nblocks * 8)

    def to_dense(self) -> torch.Tensor:
        bm, bn = self.block_shape
        m, n = self.shape
        out = torch.zeros(m // bm, n // bn, bm, bn, dtype=torch.float32,
                          device=self.blocks.device)
        out.index_put_((self.block_rows.long(), self.block_cols.long()), self.blocks,
                       accumulate=True)
        return out.transpose(1, 2).reshape(m, n)

    @staticmethod
    def from_dense(x, block_shape=(BLOCK, BLOCK),
                   device=DEFAULT_DEVICE) -> "BlockSparseMatrix":
        device = resolve_device(device)
        x = np.asarray(x, np.float32)
        m, n = x.shape
        bm, bn = block_shape
        if m % bm or n % bn:
            raise ValueError(f"shape {x.shape} is not a multiple of {block_shape}")
        tiles = x.reshape(m // bm, bm, n // bn, bn).transpose(0, 2, 1, 3)
        present = np.argwhere(np.abs(tiles).sum(axis=(2, 3)) > 0)
        if len(present) == 0:
            present = np.zeros((1, 2), np.int64)
            blocks = np.zeros((1, bm, bn), np.float32)
        else:
            blocks = tiles[present[:, 0], present[:, 1]]
        return BlockSparseMatrix(
            blocks=torch.from_numpy(np.ascontiguousarray(blocks)).to(device),
            block_rows=torch.from_numpy(present[:, 0].astype(np.int32)).to(device),
            block_cols=torch.from_numpy(present[:, 1].astype(np.int32)).to(device),
            shape=(m, n), block_shape=tuple(block_shape))


def _check(q, k, qi, ki, block_m: int, block_n: int) -> None:
    for name, x in (("q", q), ("k", k)):
        if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D float32 tensor, "
                             f"got {x.dtype} {tuple(x.shape)}")
    if q.shape[1] != k.shape[1]:
        raise ValueError(f"q and k widths differ: {q.shape[1]} != {k.shape[1]}")
    if q.shape[0] % block_m or k.shape[0] % block_n:
        raise ValueError(f"q rows {q.shape[0]} and k rows {k.shape[0]} must be "
                         f"multiples of the blocks ({block_m}, {block_n})")
    for name, x in (("qi", qi), ("ki", ki)):
        if x.dtype != torch.int32 or x.dim() != 1 or x.device != q.device:
            raise ValueError(f"{name} must be a 1-D int32 tensor on {q.device}")
    if k.device != q.device or qi.numel() != ki.numel():
        raise ValueError("q, k, qi, ki must share a device, and qi, ki a length")


def sdd_block_scores_reference(q: torch.Tensor, k: torch.Tensor, qi: torch.Tensor,
                               ki: torch.Tensor, block_m: int = BLOCK,
                               block_n: int = BLOCK) -> torch.Tensor:
    """Plain PyTorch SDD: gather the listed Q and K blocks and take one
    batched product.  TF32 would miss the 1e-4 agreement bar, so on CUDA it
    raises while TF32 is enabled."""
    _check(q, k, qi, ki, block_m, block_n)
    if q.device.type == "cuda" and tf32_enabled():
        raise RuntimeError("TF32 is enabled for float32 products; the plain SDD "
                           "version would round to about three digits")
    d = q.shape[1]
    qb = q.view(-1, block_m, d)[qi.long()]
    kb = k.view(-1, block_n, d)[ki.long()]
    return torch.bmm(qb, kb.transpose(1, 2))


def sdd_block_scores(q: torch.Tensor, k: torch.Tensor, qi: torch.Tensor,
                     ki: torch.Tensor, block_m: int = BLOCK,
                     block_n: int = BLOCK) -> torch.Tensor:
    """C blocks ``C[t] = Q[qi[t]*bm : +bm] @ K[ki[t]*bn : +bn]^T``.

    q: f32[M, D], k: f32[N, D]; qi, ki: int32[T] block indices.  Returns
    f32[T, bm, bn].  On CUDA: one launch of the hand-written kernel on the
    current stream, without synchronising; it takes bm = bn = 128 and D a
    multiple of 8 and raises on anything else.  On the CPU: the plain
    version."""
    global LAUNCHES
    _check(q, k, qi, ki, block_m, block_n)
    if q.device.type == "cpu":
        return sdd_block_scores_reference(q, k, qi, ki, block_m, block_n)
    if q.device.type != "cuda":
        raise ValueError(f"sdd_block_scores runs on cpu or cuda, not {q.device}")
    (m, d), n, t = q.shape, k.shape[0], qi.numel()
    if (block_m, block_n) != (BLOCK, BLOCK):
        raise ValueError(f"the kernel takes {BLOCK} x {BLOCK} blocks, not "
                         f"{block_m} x {block_n}")
    if d == 0 or d % 8:
        raise ValueError(f"the kernel takes D a positive multiple of 8, not {d}")
    if q.data_ptr() % 16 or k.data_ptr() % 16 or qi.stride(0) != 1 or ki.stride(0) != 1:
        raise ValueError("q and k must be 16-byte aligned, qi and ki contiguous")
    out = torch.empty(t, BLOCK, BLOCK, dtype=torch.float32, device=q.device)
    if t == 0:
        return out
    lib = _build.load()
    if t > lib.sdd_block_scores_max_pairs():
        raise ValueError(f"{t} pairs exceed the kernel's launch grid")
    with torch.cuda.device(q.device):
        err = lib.sdd_block_scores_f32(
            q.data_ptr(), k.data_ptr(), qi.data_ptr(), ki.data_ptr(), out.data_ptr(),
            t, m, n, d, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError("sdd_block_scores launch failed: "
                           + lib.spmm_error_string(err).decode())
    LAUNCHES += 1
    return out


def group_block_pairs(g: int, h: int, block: int, occ_q: np.ndarray,
                      occ_k: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The sorted (qi, ki) block pairs a group-diagonal score matrix needs:
    (i, j) such that some group's h rows land in both block i and block j,
    kept where Q's block i and K's block j are occupied; (0, 0) when none."""
    nb = len(occ_q)
    starts = np.arange(g, dtype=np.int64) * h
    a0, a1 = starts // block, (starts + h - 1) // block
    span = int((a1 - a0).max()) + 1 if g else 1
    blk = a0[:, None] + np.arange(span)[None, :]
    ok = blk <= a1[:, None]
    both = ok[:, :, None] & ok[:, None, :]
    keys = np.unique((blk[:, :, None] * nb + blk[:, None, :])[both])
    qi, ki = keys // nb, keys % nb
    keep = occ_q[qi] & occ_k[ki]
    qi, ki = qi[keep], ki[keep]
    if len(qi) == 0:
        qi, ki = np.zeros(1, np.int64), np.zeros(1, np.int64)
    return qi.astype(np.int32), ki.astype(np.int32)


def attention_block_operands(q4: np.ndarray, k4: np.ndarray, block: int = BLOCK,
                             device=DEFAULT_DEVICE):
    """(b, s, h, d) Q and K -> the SDD operands: Q and K flattened to
    (pad_rows, dpad) f32 on ``device`` (rows padded to the block, d to a
    multiple of 8), and the pair list (qi, ki) as int32 tensors.  Returns
    (qf, kf, qi, ki, meta)."""
    device = resolve_device(device)
    b, s, h, d = q4.shape
    g = b * s
    rows = g * h
    pad_rows = -(-rows // block) * block
    dpad = -(-d // 8) * 8

    def flat(x):
        xf = np.zeros((pad_rows, dpad), np.float32)
        xf[:rows, :d] = np.asarray(x, np.float32).reshape(rows, d)
        return xf

    qf, kf = flat(q4), flat(k4)
    nb = pad_rows // block
    occ_q = np.abs(qf).reshape(nb, block, dpad).sum(axis=(1, 2)) > 0
    occ_k = np.abs(kf).reshape(nb, block, dpad).sum(axis=(1, 2)) > 0
    qi, ki = group_block_pairs(g, h, block, occ_q, occ_k)
    qf_t, kf_t = torch.from_numpy(qf).to(device), torch.from_numpy(kf).to(device)
    meta = dict(shape4=(b, s, h, d), block=block, pad_rows=pad_rows, qf=qf_t, kf=kf_t)
    return (qf_t, kf_t, torch.from_numpy(qi).to(device), torch.from_numpy(ki).to(device),
            meta)


def block_sparse_attention_scores(q4: np.ndarray, k4: np.ndarray, block: int = BLOCK,
                                  device=DEFAULT_DEVICE):
    """Block-sparse attention scores (bshd,bsgd->bshg) on (block, block) tiles.

    Flattens (b, s, h) to rows, pads to the block, builds the group-diagonal
    pair list intersected with Q/K block occupancy, and computes only those
    score blocks with ``sdd_block_scores``.  Returns (packed blocks, qi, ki,
    meta); ``scores_blocks_to_dense`` materialises them for verification."""
    qf, kf, qi, ki, meta = attention_block_operands(q4, k4, block, device)
    return sdd_block_scores(qf, kf, qi, ki, block, block), qi, ki, meta


def scores_blocks_to_dense(blocks, qi, ki, meta) -> np.ndarray:
    """Packed score blocks -> (b, s, h, h) dense numpy: each group's diagonal
    (h, h) window of the padded score matrix, zero where no block is listed
    (cross-group parts of the tiles are discarded)."""
    b, s, h, _ = meta["shape4"]
    block = meta["block"]
    nb = meta["pad_rows"] // block
    blocks = blocks.cpu().numpy()
    qi, ki = qi.cpu().numpy().astype(np.int64), ki.cpu().numpy().astype(np.int64)
    which = np.full((nb, nb), -1, np.int64)
    which[qi, ki] = np.arange(len(qi))  # a repeated pair keeps its last block
    g = b * s
    base = (np.arange(g, dtype=np.int64) * h)[:, None, None]
    r = base + np.arange(h)[None, :, None]
    c = base + np.arange(h)[None, None, :]
    t = which[r // block, c // block]
    vals = blocks[np.maximum(t, 0), r % block, c % block]
    return np.where(t >= 0, vals, 0.0).astype(np.float32).reshape(b, s, h, h)
