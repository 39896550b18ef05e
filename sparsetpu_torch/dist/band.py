"""The sharded block-band product: block rows partitioned over the row
mesh, the counterpart of ``sparsetpu/dist/band.py``.

The band product C[I, dp + da] += P[I, dp] @ A[(I + dp - Wbp) mod nb, da]
(``kernels/bandmm.py``) reads only A's block rows, so with A replicated
every output block row comes from local P data: each rank runs the
unsharded product's ``_band_matmul_data`` on its own block rows with the
global block-row offset threaded through ``row_offset``, then the cyclic
fold where the product is wider than the matrix.  Each output element sums
the same terms as the unsharded product; the values are integers below
2^24 in f32, where every order of the sums is exact, so the result is bit
for bit the unsharded product's (the reference's ``matmul_par ==
matmul``).

A sharded ``BandMatrix`` holds this rank's ``nb / nd`` block rows in
``data`` (its ``nb`` is the local count); ``n``, ``block``, the half-width
and the wrap mode stay global.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..kernels.bandmm import BandMatrix, _band_matmul_data, fold_cyclic
from .shard import default_mesh, mesh_rank


def _rows_per_rank(nb: int, nd: int) -> int:
    if nb % nd:
        raise ValueError(f"block rows {nb} not divisible by {nd} devices")
    return nb // nd


def _world_mesh() -> DeviceMesh:
    """The mesh over the whole world (JAX's default: every device)."""
    return default_mesh(dist.get_world_size())


def shard_band(b: BandMatrix, mesh: Optional[DeviceMesh] = None) -> BandMatrix:
    """This rank's block rows of the replicated ``b`` (data axis 0)."""
    mesh = mesh if mesh is not None else _world_mesh()
    nb_local = _rows_per_rank(b.nb, mesh.size())
    start = mesh_rank(mesh) * nb_local
    return dataclasses.replace(b, data=b.data[start:start + nb_local].contiguous())


def replicate_band(b: BandMatrix, mesh: Optional[DeviceMesh] = None) -> BandMatrix:
    """The static right operand on every rank: each rank already holds the
    whole ``b``, so it is returned as it is (JAX places a copy on every
    device)."""
    return b


def band_matmul_sharded(p: BandMatrix, a: BandMatrix, p_limbs: int = 0, a_limbs: int = 0,
                        mesh: Optional[DeviceMesh] = None) -> BandMatrix:
    """C = P x A with P's block rows sharded and A replicated; C stays
    sharded.  Mirrors ``kernels.bandmm.band_matmul``, the cyclic fold
    included; ``p_limbs`` / ``a_limbs`` change nothing, as there."""
    if p.block != a.block or p.cyclic != a.cyclic or p.n != a.n:
        raise ValueError("band_matmul_sharded needs one size, block size and wrap mode")
    mesh = mesh if mesh is not None else _world_mesh()
    nb = a.nb
    nb_local = _rows_per_rank(nb, mesh.size())
    if p.nb != nb_local:
        raise ValueError(f"P holds {p.nb} block rows, not {nb_local} of {nb}")
    wbp, wba = p.half_width_blocks, a.half_width_blocks
    wbc = wbp + wba
    kbc = p.k_blocks + a.k_blocks - 1
    fold = p.cyclic and kbc > nb
    c = _band_matmul_data(p.data, a.data, wbp, wba, p.cyclic, p_limbs=p_limbs,
                          a_limbs=a_limbs, row_offset=mesh_rank(mesh) * nb_local)
    if fold:
        return BandMatrix(fold_cyclic(c, wbc, nb), p.n, p.block, 0, True)
    return BandMatrix(c, p.n, p.block, wbc, p.cyclic)
