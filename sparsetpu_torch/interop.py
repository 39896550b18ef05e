"""Carry state across from the JAX package, as numpy arrays.

The tests feed the same state to ``sparsetpu`` and to the port and compare
like with like; these functions translate the JAX package's host forms
into the port's, without importing jax.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .csr import DEFAULT_DEVICE, SEMIRINGS, HostCSR, SparseCSR, resolve_device
from .dist.shard import ShardedCSR
from .grouped import GroupedCSR
from .kernels.blocksparse import BlockSparseMatrix
from .semiring import by_name


def csr_from_jax_host(row_ptr, col_idx, limbs, nnz: int, n_rows: int,
                      n_cols: int, sr_name: str) -> HostCSR:
    """The port's HostCSR from the numpy arrays of a JAX ``HostCSR`` or of a
    ``SparseCSR``'s fields: capacity padding is cut at ``nnz`` and the u64
    semiring's two uint32 limbs (lo, hi) are joined into uint64."""
    if sr_name not in SEMIRINGS:
        raise ValueError(f"unknown semiring {sr_name!r}; have {SEMIRINGS}")
    nnz = int(nnz)
    lo = np.asarray(limbs[0])[:nnz]
    if sr_name == "f32":
        vals = lo.astype(np.float32)
    else:
        vals = lo.astype(np.uint64)
        if sr_name == "u64":
            vals |= np.asarray(limbs[1])[:nnz].astype(np.uint64) << np.uint64(32)
    return HostCSR(np.asarray(row_ptr, np.int64),
                   np.asarray(col_idx)[:nnz].astype(np.int32),
                   vals, int(n_rows), int(n_cols), sr_name)


def dense_from_row_planes(planes, n_cols: int) -> np.ndarray:
    """JAX's (n, S, 128) row-plane P or C -> plain (n, n_cols)."""
    planes = np.asarray(planes)
    return planes.reshape(planes.shape[0], -1)[:, :n_cols]


def band_from_jax_planes(planes, base_planes) -> Tuple[np.ndarray, np.ndarray]:
    """JAX's band-compact (n, S, 128) planes with plane starts ``base`` ->
    the port's band layout: the (n, S * 128) window of every row and its
    absolute column start (base * 128, int32)."""
    planes = np.asarray(planes)
    base = np.asarray(base_planes, np.int64) * 128
    return planes.reshape(planes.shape[0], -1), base.astype(np.int32)


def sparse_csr_from_jax(row_ptr, col_idx, limbs, nnz, n_rows: int, n_cols: int,
                        sr_name: str, device=DEFAULT_DEVICE) -> SparseCSR:
    """The port's device ``SparseCSR`` from the numpy arrays of a JAX
    ``SparseCSR``'s fields, keeping its capacity (padding included) and its
    limbs: uint32 limbs widen to the port's int64, f32 stays f32."""
    return SparseCSR.from_host_arrays(row_ptr, col_idx, limbs, nnz, int(n_rows),
                                      int(n_cols), by_name(sr_name), device)


def carry_csr(j, device=DEFAULT_DEVICE) -> SparseCSR:
    """``sparse_csr_from_jax`` of a JAX ``SparseCSR`` object itself (its
    fields read as numpy arrays)."""
    return sparse_csr_from_jax(j.row_ptr, j.col_idx, [np.asarray(x) for x in j.values],
                               j.nnz, j.n_rows, j.n_cols, j.sr_name, device)


def block_sparse_from_jax(blocks, block_rows, block_cols, shape, block_shape,
                          device=DEFAULT_DEVICE) -> BlockSparseMatrix:
    """The port's ``BlockSparseMatrix`` from the arrays of a JAX one."""
    device = resolve_device(device)
    return BlockSparseMatrix(
        blocks=torch.tensor(np.asarray(blocks, np.float32), device=device),
        block_rows=torch.tensor(np.asarray(block_rows, np.int32), device=device),
        block_cols=torch.tensor(np.asarray(block_cols, np.int32), device=device),
        shape=tuple(int(x) for x in shape),
        block_shape=tuple(int(x) for x in block_shape))


def grouped_from_jax(row_ptr, col_idx, limbs, nnz, sr_name: str, g: int, n: int, m: int,
                     device=DEFAULT_DEVICE) -> GroupedCSR:
    """The port's ``GroupedCSR`` from the numpy arrays of a JAX
    ``GroupedCSR``'s flat CSR (capacity and padding kept) and its (g, n, m)."""
    flat = sparse_csr_from_jax(row_ptr, col_idx, limbs, nnz, g * n, g * m, sr_name, device)
    return GroupedCSR(flat, int(g), int(n), int(m))


def dense_limbs_from_jax(limbs, device=DEFAULT_DEVICE) -> Tuple[torch.Tensor, ...]:
    """A JAX dense limb tuple (uint32 numpy arrays, or float32 for f32) as
    the port's limb tensors on ``device``: uint32 widens to int64."""
    device = resolve_device(device)
    out = []
    for l in limbs:
        a = np.asarray(l)
        a = a.astype(np.float32 if a.dtype.kind == "f" else np.int64)
        out.append(torch.from_numpy(np.ascontiguousarray(a)).to(device))
    return tuple(out)


def sharded_from_jax(row_ptr, col_idx, limbs, nnz, rank: int, n_rows: int, n_cols: int,
                     sr_name: str, device=DEFAULT_DEVICE) -> ShardedCSR:
    """Shard ``rank`` of a JAX ``ShardedCSR`` in the port's rank-local form,
    from the numpy arrays of its fields (``row_ptr`` [nd, n_local + 1],
    ``col_idx`` and each limb [nd, capacity], ``nnz`` [nd]): capacity and
    padding kept, uint32 limbs widened to the port's int64."""
    row_ptr = np.asarray(row_ptr)
    nd, n_local = row_ptr.shape[0], row_ptr.shape[1] - 1
    local = sparse_csr_from_jax(row_ptr[rank], np.asarray(col_idx)[rank],
                                [np.asarray(l)[rank] for l in limbs], int(np.asarray(nnz)[rank]),
                                n_local, n_cols, sr_name, device)
    return ShardedCSR(row_ptr=local.row_ptr, col_idx=local.col_idx, values=local.values,
                      nnz=local.nnz, n_rows=int(n_rows), n_cols=int(n_cols), sr_name=sr_name,
                      n_local=n_local, n_shards=nd, rank=rank)
