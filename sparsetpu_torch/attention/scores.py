"""Attention scores ``bshd,bsgd->bshg``, dense and sparse: the port of
``sparsetpu/attention/scores.py``.

Raw Q.K^T scores at GPT-2 shapes, as in the reference: no softmax, no mask,
no V.  Tensors are (batch, seq, heads, head_dim); the contraction is over
head_dim for each (batch, seq) group, giving (batch, seq, heads, heads).

- Dense: one ``torch.einsum``, which must not run in TF32 (it raises on CUDA
  while TF32 is enabled).  It is a plain product in the JAX package too.
- Element-sparse: Q and K^T as block-diagonal CSRs over the groups
  g = (batch, seq) (``tensor_to_grouped_csr``), and every group's product in
  one ESC SpGEMM (``ops/spgemm.spgemm``) on the f32 semiring.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..csr import DEFAULT_DEVICE, SparseCSR, resolve_device
from ..kernels.spmm import tf32_enabled
from ..ops.spgemm import spgemm
from ..semiring import F32SR


def attention_flops(shape: Tuple[int, int, int, int]) -> int:
    """Multiply count of the dense scores."""
    b, s, h, d = shape
    return b * s * h * h * d


def attention_scores_dense(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(b, s, h, d), (b, s, h, d) -> (b, s, h, h) f32 scores."""
    if q.device.type == "cuda" and tf32_enabled():
        raise RuntimeError("TF32 is enabled for float32 products; the dense scores "
                           "would round to about three digits")
    return torch.einsum("bshd,bsgd->bshg", q, k)


def random_sparse_tensor(shape, density: float, seed: int, scale: float = 1.0) -> np.ndarray:
    """Dense numpy tensor with about ``density`` of its entries nonzero,
    uniform in [-scale, scale); the JAX package's draws, bit for bit."""
    rng = np.random.default_rng(seed)
    mask = rng.random(shape) < density
    vals = (rng.random(shape, dtype=np.float32) * 2.0 - 1.0) * scale
    return np.where(mask, vals, 0.0).astype(np.float32)


def tensor_to_grouped_csr(x: np.ndarray, transpose_last: bool = False,
                          capacity: Optional[int] = None,
                          device=DEFAULT_DEVICE) -> SparseCSR:
    """(b, s, h, d) tensor -> block-diagonal f32 CSR over the groups g = b*s:
    rows (g, h) and columns (g, d) flattened, so groups never meet and one
    SpGEMM computes every Q[g] x K[g]^T.  ``transpose_last`` swaps (h, d) to
    build K^T.  The merge runs in numpy; one copy to ``device``."""
    device = resolve_device(device)
    b, s, h, d = x.shape
    g = b * s
    xg = x.reshape(g, h, d)
    if transpose_last:
        xg = np.swapaxes(xg, 1, 2)
        h, d = d, h
    gi, hi, di = np.nonzero(xg)
    rows = gi.astype(np.int64) * h + hi
    cols = gi.astype(np.int64) * d + di
    vals = xg[gi, hi, di]
    cap = capacity or max(len(rows), 1)
    return SparseCSR.from_coo_host(rows, cols, vals, g * h, g * d, sr=F32SR,
                                   capacity=cap, device=device)


def attention_scores_sparse(q_csr: SparseCSR, kt_csr: SparseCSR, expand_cap: int,
                            out_cap: Optional[int] = None) -> SparseCSR:
    """Sparse scores = Q_grouped x K^T_grouped (one ESC SpGEMM)."""
    return spgemm(q_csr, kt_csr, expand_cap, out_cap)


def sparse_scores_to_dense(c: SparseCSR, shape) -> np.ndarray:
    """(g*h, g*h) block-diagonal sparse scores -> (b, s, h, h) dense numpy."""
    b, s, h, _ = shape
    dense = np.zeros((b * s * h, h), np.float32)
    row_ptr, col_idx, vals = c.check().to_numpy()
    rows = np.repeat(np.arange(c.n_rows), np.diff(row_ptr))
    dense[rows, col_idx - (rows // h) * h] = vals
    return dense.reshape(b, s, h, h)
