"""Named benchmark configurations matching BASELINE.json's config list: a
copy of ``sparsetpu/bench/configs.py`` (plain dataclasses, no jax).

The reference has no CLI config system — it uses compile-time const tables
(GPT_CONFIGS src/main.rs:46-52, grid arrays inside each bench).  Here the
equivalents are typed dataclasses addressable by name.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class ChainConfig:
    name: str
    dims: Tuple[int, int, int]
    density: float            # thin() keep probability
    max_step: int
    block: int                # block-band tile (must divide prod(dims))
    seed: int = 42

    @property
    def n(self) -> int:
        d0, d1, d2 = self.dims
        return d0 * d1 * d2

    @property
    def half_width(self) -> int:
        d0, d1, d2 = self.dims
        return d1 * d2 + d2 + 1


@dataclasses.dataclass(frozen=True)
class RandomSweepConfig:
    """Erdős–Rényi sweep grid (reference bench_matmul_magnus,
    src/graph_magnus.rs:790-929: side x edges-per-node grid)."""

    name: str
    sides: Tuple[int, ...]
    edges_per_node: Tuple[float, ...]
    iters: int = 3
    seed: int = 42


@dataclasses.dataclass(frozen=True)
class PowerLawConfig:
    """Skewed-degree stress (BASELINE config 4: MAGNUS categorization on
    power-law graphs)."""

    name: str
    n: int
    m_per_node: int
    seed: int = 7


CHAIN_CONFIGS: Dict[str, ChainConfig] = {
    # BASELINE configs 1-2: the 30^3 Moore torus chain
    "torus30": ChainConfig("torus30", (30, 30, 30), 3.0 / 26.0, 7, 125),
    "torus12": ChainConfig("torus12", (12, 12, 12), 3.0 / 26.0, 5, 108),
    "torus8": ChainConfig("torus8", (8, 8, 8), 3.0 / 26.0, 5, 64),
}

RANDOM_SWEEPS: Dict[str, RandomSweepConfig] = {
    # BASELINE config 3: random-graph sweep, ESC-vs-band crossover
    "er_sweep": RandomSweepConfig(
        "er_sweep", sides=(1000, 3375, 8000), edges_per_node=(3.0, 5.0, 10.0)
    ),
}

POWER_LAW: Dict[str, PowerLawConfig] = {
    "pl27k": PowerLawConfig("pl27k", n=27000, m_per_node=3),
    "pl2k": PowerLawConfig("pl2k", n=2000, m_per_node=3),
}
