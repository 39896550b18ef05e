"""Graph 500's Kronecker graph, in GraphChallenge's undirected adjacency form.

The loop of the Graph 500 specification's reference generator
(``kronecker_generator.m``, section "Graph generation"): M = edgefactor x
2^SCALE edges, and for each of the SCALE levels one bit of every edge's
start and end drawn from the initiator A, B, C (D = 1 - A - B - C),

    ii = rand(M) > A + B
    jj = rand(M) > C / (1 - (A + B)) * ii + A / (A + B) * not(ii)

then a random permutation of the vertices.  The draws come from numpy's
PCG64 (``default_rng(draw_seed)``, one stream for every level) in place of
Octave's ``rand``, so the graph's structure is fixed by ``draw_seed``; the
run's seed draws only the vertex permutation, which renames the vertices
and changes none of the work.  The edges are then made undirected as MIT
GraphChallenge publishes these graphs: symmetrised, self-loops dropped,
duplicates merged, every value 1.  The spec's shuffle of the edge list does
not survive the merge and is left out.

Frozen numpy: it imports nothing of the program, and the port's
``graphs/generate.graph500_kronecker`` is held equal to it bit for bit.
COO triplets are ``(rows int32, cols int32, vals uint64, n)``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def kronecker(scale: int, edgefactor: int, initiator: Sequence[float], draw_seed: int,
              perm_seed: int):
    """The undirected Kronecker graph of 2^scale vertices."""
    a, b, c = (float(x) for x in initiator[:3])
    n = 1 << scale
    m = edgefactor * n
    ab, c_norm, a_norm = a + b, c / (1.0 - (a + b)), a / (a + b)
    rng = np.random.default_rng(draw_seed)
    i = np.zeros(m, np.int64)
    j = np.zeros(m, np.int64)
    for level in range(scale):
        ii = rng.random(m) > ab
        jj = rng.random(m) > np.where(ii, c_norm, a_norm)
        i += ii.astype(np.int64) << level
        j += jj.astype(np.int64) << level
    perm = np.random.default_rng(perm_seed).permutation(n)
    i, j = perm[i], perm[j]
    off = i != j
    key = np.unique(np.concatenate([i[off] * n + j[off], j[off] * n + i[off]]))
    return ((key // n).astype(np.int32), (key % n).astype(np.int32),
            np.ones(len(key), np.uint64), n)


def build(cfg: dict, seed: int):
    return kronecker(cfg["scale"], cfg["edgefactor"], cfg["initiator"], cfg["draw_seed"], seed)
