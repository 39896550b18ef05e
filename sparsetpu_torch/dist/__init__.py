"""Row-partitioned multi-device execution on ``torch.distributed``: the
counterpart of ``sparsetpu/dist/``.

The reference's only parallelism is rayon's shared-memory row-parallel
SpGEMM (src/graph_csr.rs:350-484).  The JAX package partitions CSR row
blocks over a 1-D device mesh ("row") with ``shard_map``; the port gives
each block a rank of its own, one card a rank under NCCL (ranks sharing a
card, or the CPU, run over gloo), with collectives in place of the shared
address space.

Modules:
  - :mod:`sparsetpu_torch.dist.shard`     -- ShardedCSR and the sharded ESC chain;
  - :mod:`sparsetpu_torch.dist.panels`    -- the B-panel ring (both operands sharded);
  - :mod:`sparsetpu_torch.dist.band`      -- the sharded block-band product;
  - :mod:`sparsetpu_torch.dist.multihost` -- initialisation, the pod mesh, ``run_local``;
  - :mod:`sparsetpu_torch.dist.programs`  -- the rank programs ``run_local`` runs.
"""

from . import band, multihost, panels, shard
from .multihost import run_local
from .shard import (
    ShardedCSR,
    default_mesh,
    shard as shard_csr,
    spgemm_sharded,
    symbolic_flops_sharded,
    unshard,
)

__all__ = [
    "ShardedCSR",
    "band",
    "default_mesh",
    "multihost",
    "panels",
    "run_local",
    "shard",
    "shard_csr",
    "spgemm_sharded",
    "symbolic_flops_sharded",
    "unshard",
]
