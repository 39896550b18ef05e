"""Real-graph loading and skewed-degree generators: the port of
``sparsetpu/graphs/datasets.py`` (numpy only).

- ``load_edges`` reads a whitespace ``src dst`` edge file;
- ``power_law`` is the Barabási–Albert-style preferential-attachment graph
  of BASELINE config 4 (the general-SpGEMM sweep's skewed-degree case);
- ``degree_stats``, ``PUBLISHED_STATS`` and ``check_substitute`` describe
  and check the substitutes for the reference's real graphs.

Every function is a copy of the JAX package's, bit-identical for the same
seed: the attachment loop keeps the set of targets and the Python endpoint
pool, because set order and the order of the generator's calls fix the
edges.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .generate import Coo, _dedup_coo


def load_edges(path: str, undirected: bool = False) -> Coo:
    """Read a ``src dst`` edge list file (one edge per line, '#' comments)."""
    src, dst = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            a, b = line.split()[:2]
            src.append(int(a))
            dst.append(int(b))
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    n = int(max(src.max(initial=-1), dst.max(initial=-1))) + 1
    if undirected:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    return _dedup_coo(n, src, dst, np.ones(len(src), np.uint64))


def power_law(n: int, m_per_node: int = 3, seed: int = 0,
              target_directed_edges: Optional[int] = None) -> Coo:
    """Preferential-attachment (Barabási–Albert) multigraph, undirected: each
    new node attaches to m endpoints drawn from the pool of current edge
    endpoints (preferential by degree), so a few hubs carry a long tail.

    ``target_directed_edges`` aims the stored (directed) entry count at this
    value by a fractional number of attachments per node."""
    if not n > m_per_node >= 1:
        raise ValueError(f"power_law needs n > m_per_node >= 1, got {n}, {m_per_node}")
    rng = np.random.default_rng(seed)
    if target_directed_edges is not None:
        t = target_directed_edges / 2.0 / max(n - m_per_node - 1, 1)
        base = max(1, int(t))
        frac = max(0.0, min(1.0, t - base))
        m_of = base + (rng.random(n) < frac).astype(np.int64)
    else:
        m_of = np.full(n, m_per_node, np.int64)
    m0 = m_per_node
    # seed clique endpoints
    pool = [i for i in range(m0 + 1) for _ in range(m0)]
    src_list = []
    dst_list = []
    for v in range(m0 + 1, n):
        targets = rng.choice(len(pool), size=int(m_of[v]))
        ts = {pool[t] for t in targets}
        for t in ts:
            src_list.append(v)
            dst_list.append(t)
            pool.append(t)
            pool.append(v)
    src = np.asarray(src_list, np.int64)
    dst = np.asarray(dst_list, np.int64)
    rows = np.concatenate([src, dst])
    cols = np.concatenate([dst, src])
    return _dedup_coo(n, rows, cols, np.ones(len(rows), np.uint64))


def degree_stats(coo: Coo) -> Tuple[int, float]:
    """(max, mean) row degree."""
    rows, _, _, n = coo
    deg = np.bincount(rows, minlength=n)
    return int(deg.max()), float(deg.mean())


# Published degree structure of the graphs the reference benches: Planetoid
# cora/nell and ogbn-arxiv node and directed-edge counts, and a lower bound
# on the hub degree (cora's published maximum is 168).
PUBLISHED_STATS = {
    #  name:        (n,      directed_edges, min_max_deg)
    "cora":        (2708,    10556,          60),
    "nell":        (65755,   251550,         300),
    "ogbn_arxiv":  (169343,  1166243,        1000),
}


def check_substitute(name: str, coo: Coo, edge_tol: float = 0.05) -> dict:
    """Raise AssertionError unless a synthetic stand-in matches the named
    real graph's published degree moments: exact node count, directed-edge
    count and mean degree within ``edge_tol``, and a hub tail (max degree
    >= the published floor and >= 10x the mean).  Returns the measured
    stats."""
    n_pub, e_pub, min_max = PUBLISHED_STATS[name]
    rows, _, _, n = coo
    deg = np.bincount(rows, minlength=n)
    e = len(rows)
    mean = float(deg.mean())
    mean_pub = e_pub / n_pub
    mx = int(deg.max())
    problems = []
    if n != n_pub:
        problems.append(f"n={n} != published {n_pub}")
    if abs(e - e_pub) > edge_tol * e_pub:
        problems.append(f"edges={e} vs published {e_pub} (tol {edge_tol:.0%})")
    if abs(mean - mean_pub) > edge_tol * mean_pub:
        problems.append(f"mean degree {mean:.2f} vs published {mean_pub:.2f}")
    if not (mx >= min_max and mx >= 10 * mean):
        problems.append(f"max degree {mx} lacks the published hub tail "
                        f"(floor {min_max}, mean {mean:.2f})")
    if problems:
        raise AssertionError(f"{name}: " + "; ".join(problems))
    return dict(name=name, n=n, edges=e, mean_deg=mean, max_deg=mx,
                p99_deg=float(np.percentile(deg, 99)))
