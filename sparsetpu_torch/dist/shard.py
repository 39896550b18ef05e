"""Row-partitioned CSR over a 1-D device mesh and the sharded ESC SpGEMM:
the counterpart of ``sparsetpu/dist/shard.py`` on ``torch.distributed``.

The JAX package splits the left operand's rows into ``n_devices`` contiguous
blocks over a ``jax.sharding.Mesh`` whose axis is "row", replicates the
right operand, and runs the local ESC kernel per block in one ``shard_map``.
Here the mesh is a ``torch.distributed`` device mesh with the same axis
name, one rank per block: every rank holds **its own** block as rank-local
tensors beside the global metadata (``n_rows``, ``n_cols``, ``sr_name``,
``n_local``, ``n_shards``, ``rank``), and a replicated operand is a whole
``SparseCSR`` on every rank.  The product of a chain step stays sharded in
place and the numeric step needs no communication.

The layout is JAX's, slot for slot: ``n_local = ceil(n / nd)`` rows a
shard, one uniform capacity (the largest block nnz), the tail rows past
``n_rows`` empty with ``row_ptr`` padded by its last value, ``col_idx``
padded with ``INT32_SENTINEL``, values in the port's limbs.  The uniform
capacity also gives every collective fixed-size buffers.

**Transport.** NCCL (one rank a card) moves device tensors as they are.
Gloo moves host memory: a CUDA tensor crosses through a pinned host copy,
a CPU tensor directly (``transport`` names the case from the group's
backend; no other backend is taken).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..csr import SparseCSR
from ..ops.segments import INT32_SENTINEL
from ..ops.spgemm import spgemm
from ..semiring import Value, by_name

AXIS = "row"


def default_mesh(n_devices: int) -> DeviceMesh:
    """1-D mesh over the ``n_devices`` ranks of the default process group,
    axis name "row".  The caller brings the group up (``multihost.run_local``
    or ``multihost.initialize``) with exactly that many ranks.  The mesh's
    device type names where its collectives' buffers live: the card under
    NCCL, host memory under gloo."""
    if not dist.is_initialized():
        raise RuntimeError("no torch.distributed process group: bring one up first "
                           "(multihost.run_local or multihost.initialize)")
    world = dist.get_world_size()
    if world != n_devices:
        raise ValueError(f"need a world of {n_devices} ranks, have {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n_devices,), mesh_dim_names=(AXIS,))


def transport(mesh: DeviceMesh) -> str:
    """How tensors cross ranks on the mesh's "row" group: "nccl" (device
    tensors as they are) or "gloo" (host memory; CUDA tensors staged through
    pinned host buffers)."""
    backend = dist.get_backend(mesh.get_group(AXIS))
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unsupported backend {backend!r}: the port moves shards over "
                         "nccl or gloo")
    return backend


def _staged(t: torch.Tensor, mesh: DeviceMesh) -> bool:
    return t.is_cuda and transport(mesh) == "gloo"


def _wire_buffer(like: torch.Tensor, staged: bool) -> torch.Tensor:
    """An empty buffer for a tensor's trip between ranks: pinned host memory
    where the trip is staged, else the tensor's own device."""
    if staged:
        return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
    return torch.empty_like(like)


def to_wire(t: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """``t`` as the mesh's transport sends it (a pinned host copy under gloo
    for a CUDA tensor; synchronises with the device for that copy)."""
    t = t.contiguous()
    if not _staged(t, mesh):
        return t
    return _wire_buffer(t, True).copy_(t)


def all_gather(t: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """[nd, *t.shape]: every rank's ``t`` in rank order, on ``t``'s device.
    ``t`` must have the same shape and dtype on every rank."""
    group = mesh.get_group(AXIS)
    wire = to_wire(t, mesh)
    outs = [_wire_buffer(wire, _staged(t, mesh)) for _ in range(mesh.size())]
    dist.all_gather(outs, wire, group=group)
    return torch.stack(outs).to(t.device, non_blocking=True)


def mesh_rank(mesh: DeviceMesh) -> int:
    return mesh.get_local_rank(AXIS)


@dataclasses.dataclass(frozen=True)
class ShardedCSR:
    """One rank's block of a CSR row-partitioned into ``n_shards`` equal
    blocks (the last zero-padded): the rows [rank * n_local, (rank + 1) *
    n_local).  ``row_ptr`` holds local offsets, ``col_idx`` global columns;
    local rows whose global index is >= n_rows are empty padding.  ``nnz``
    is -1 where an operation overflowed its capacity."""

    row_ptr: torch.Tensor  # int32[n_local + 1]
    col_idx: torch.Tensor  # int32[capacity]
    values: Value          # sr.nlimbs tensors [capacity]
    nnz: torch.Tensor      # int64 scalar on the device
    n_rows: int            # global (unpadded)
    n_cols: int
    sr_name: str
    n_local: int           # rows a shard
    n_shards: int
    rank: int

    @property
    def sr(self):
        return by_name(self.sr_name)

    @property
    def capacity(self) -> int:
        return self.col_idx.shape[0]

    @property
    def device(self) -> torch.device:
        return self.col_idx.device

    def local(self) -> SparseCSR:
        """This rank's block as an n_local x n_cols ``SparseCSR``."""
        return SparseCSR(row_ptr=self.row_ptr, col_idx=self.col_idx, values=self.values,
                         nnz=self.nnz, n_rows=self.n_local, n_cols=self.n_cols,
                         sr_name=self.sr_name)

    def total_nnz(self, mesh: Optional[DeviceMesh] = None) -> int:
        """Sum of the shards' nnz, -1 for a poisoned one (a collective), as
        JAX's ``total_nnz``."""
        mesh = mesh if mesh is not None else default_mesh(self.n_shards)
        return int(all_gather(self.nnz.reshape(1), mesh).sum())

    def memory_bytes(self) -> int:
        """Storage of all shards together (8 bytes a limb for the integer
        semirings, whose uint32 limbs ride int64; JAX stores 4)."""
        limb_bytes = sum(l.element_size() for l in self.values)
        return int(self.n_shards * ((self.n_local + 1) * 4 + self.capacity * (4 + limb_bytes)))


def shard(a: SparseCSR, n_devices: int, mesh: Optional[DeviceMesh] = None,
          capacity: Optional[int] = None) -> ShardedCSR:
    """This rank's block of the replicated CSR ``a`` (every rank holds the
    whole ``a``), cut on ``a``'s device with no collective.  Every shard
    gets one capacity (the largest block nnz, or ``capacity``)."""
    mesh = mesh if mesh is not None else default_mesh(n_devices)
    if mesh.size() != n_devices:
        raise ValueError(f"the mesh has {mesh.size()} ranks, not {n_devices}")
    rank = mesh_rank(mesh)
    n = a.n_rows
    n_local = -(-n // n_devices)
    if int(a.nnz) < 0:
        raise ValueError("cannot shard a capacity-poisoned SparseCSR")
    bounds = [min(d * n_local, n) for d in range(n_devices + 1)]
    starts = a.row_ptr[bounds].long().tolist()
    counts = [starts[d + 1] - starts[d] for d in range(n_devices)]
    cap = capacity or max(max(counts), 1)
    if cap < max(counts):
        raise ValueError(f"capacity {cap} < max block nnz {max(counts)}")

    r0, r1 = bounds[rank], bounds[rank + 1]
    loc = a.row_ptr[r0:r1 + 1] - a.row_ptr[r0]
    row_ptr = torch.cat([loc, loc[-1:].expand(n_local - (r1 - r0))]).int()
    s, c = starts[rank], counts[rank]
    col_idx = torch.full((cap,), INT32_SENTINEL, dtype=torch.int32, device=a.device)
    col_idx[:c] = a.col_idx[s:s + c]
    values = tuple(torch.cat([l[s:s + c], l.new_zeros(cap - c)]) for l in a.values)
    return ShardedCSR(row_ptr=row_ptr, col_idx=col_idx, values=values,
                      nnz=torch.tensor(c, dtype=torch.int64, device=a.device),
                      n_rows=n, n_cols=a.n_cols, sr_name=a.sr_name, n_local=n_local,
                      n_shards=n_devices, rank=rank)


def unshard(s: ShardedCSR, mesh: Optional[DeviceMesh] = None) -> SparseCSR:
    """The whole CSR on every rank: an all-gather of the fixed-size shards,
    then their valid prefixes joined in row order.  Raises ValueError where
    a shard's nnz is poisoned, as JAX's does; the capacity is max(nnz, 1),
    as JAX's ``from_coo`` gives it.  The shards' entries are already sorted
    and merged, so joining them is JAX's COO build without its sort."""
    mesh = mesh if mesh is not None else default_mesh(s.n_shards)
    nnz = all_gather(s.nnz.reshape(1), mesh)[:, 0]
    nnz_host = nnz.cpu().numpy()
    if (nnz_host < 0).any():
        raise ValueError("ShardedCSR capacity overflow on shard(s) "
                         f"{np.nonzero(nnz_host < 0)[0].tolist()} (nnz poisoned to -1)")
    rp = all_gather(s.row_ptr, mesh).long()
    keep = torch.arange(s.capacity, device=s.device)[None, :] < nnz[:, None]
    col_idx = all_gather(s.col_idx, mesh)[keep]
    values = tuple(all_gather(l, mesh)[keep] for l in s.values)
    base = torch.cumsum(nnz, 0) - nnz
    row_ptr = torch.cat([rp.new_zeros(1), (rp[:, 1:] + base[:, None]).reshape(-1)])
    total = int(nnz_host.sum())
    out = SparseCSR(row_ptr=row_ptr[:s.n_rows + 1].int(), col_idx=col_idx, values=values,
                    nnz=torch.tensor(total, dtype=torch.int64, device=s.device),
                    n_rows=s.n_rows, n_cols=s.n_cols, sr_name=s.sr_name)
    return out.with_capacity(max(total, 1))


def symbolic_flops_sharded(s: ShardedCSR, b: SparseCSR,
                           mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """Every shard's partial-product count for S x B, int64[nd] on every
    rank (the local count, then an all-gather).  The host sizes the numeric
    pass's uniform ``expand_cap`` from its max."""
    mesh = mesh if mesh is not None else default_mesh(s.n_shards)
    valid = torch.arange(s.capacity, device=s.device) < s.nnz
    col = torch.clamp(s.col_idx.long(), 0, b.n_rows - 1)
    local = torch.where(valid, b.row_nnz().long()[col], 0).sum()
    return all_gather(local.reshape(1), mesh)[:, 0]


def spgemm_sharded(s: ShardedCSR, b: SparseCSR, expand_cap: int,
                   out_cap: Optional[int] = None,
                   mesh: Optional[DeviceMesh] = None) -> ShardedCSR:
    """C = S x B with S row-sharded and B replicated; C stays row-sharded.
    Every rank runs the port's ESC ``ops.spgemm.spgemm`` on its block with
    the same ``expand_cap`` (>= the largest shard's symbolic flop count) and
    ``out_cap`` (default ``expand_cap``); no communication.  A shard whose
    expansion passes ``expand_cap`` has its nnz poisoned to -1.  ``mesh``
    is accepted for JAX's signature; the step needs none."""
    if s.n_cols != b.n_rows:
        raise ValueError(f"shapes ({s.n_rows}, {s.n_cols}) x {b.shape} do not chain")
    c = spgemm(s.local(), b, expand_cap, out_cap or expand_cap)
    return ShardedCSR(row_ptr=c.row_ptr, col_idx=c.col_idx, values=c.values, nnz=c.nnz,
                      n_rows=s.n_rows, n_cols=b.n_cols, sr_name=s.sr_name,
                      n_local=s.n_local, n_shards=s.n_shards, rank=s.rank)


def shard_arrays(s: ShardedCSR) -> List[np.ndarray]:
    """(row_ptr, col_idx, *limbs, nnz) of this rank's shard as numpy arrays
    (limbs as the port carries them), for comparisons outside the world."""
    return ([s.row_ptr.cpu().numpy(), s.col_idx.cpu().numpy()]
            + [l.cpu().numpy() for l in s.values] + [np.int64(int(s.nnz))])
