"""Host-side graph generators (numpy), ported from ``sparsetpu/graphs/generate.py``.

Numpy-only copies of the generators the chain needs, bit-identical to the
originals for the same seed: Moore-neighbourhood lattices with optional torus
wrap, random directed multigraphs, and symmetric ``thin`` density reduction.
Results are COO triplets ``(rows, cols, vals u64, n)``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

Coo = Tuple[np.ndarray, np.ndarray, np.ndarray, int]  # rows, cols, vals(u64), n


def _dedup_coo(n: int, rows, cols, vals) -> Coo:
    """Sort by (row, col), merge duplicates with saturating-u64 add, drop zeros."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals, np.uint64)
    if rows.size == 0:
        return rows.astype(np.int32), cols.astype(np.int32), vals, n
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    key = rows * n + cols
    head = np.ones(len(key), bool)
    head[1:] = key[1:] != key[:-1]
    seg = np.cumsum(head) - 1
    # saturating segment sum in python ints (exact)
    totals = np.zeros(seg[-1] + 1, dtype=object)
    np.add.at(totals, seg, vals.astype(object))
    totals = np.minimum(totals, 0xFFFFFFFFFFFFFFFF).astype(np.uint64)
    ur, uc = rows[head], cols[head]
    keep = totals != 0
    return ur[keep].astype(np.int32), uc[keep].astype(np.int32), totals[keep], n


def random_graph(n: int, m: int, seed: int = 0) -> Coo:
    """Random directed multigraph, m edge draws, no self-loops: the column is
    drawn in [0, n-1) and shifted past the row."""
    if n < 2:
        raise ValueError(f"random_graph needs n >= 2, got {n}")
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, size=m)
    c = rng.integers(0, n - 1, size=m)
    c = np.where(c >= r, c + 1, c)
    return _dedup_coo(n, r, c, np.ones(m, np.uint64))


def lattice(dims: Sequence[int], torus: bool) -> Coo:
    """N-D Moore-neighbourhood lattice; node index row-major.  Each node
    connects to all <= 3^N - 1 neighbours differing by at most 1 per
    coordinate; ``torus`` wraps coordinates.

    With torus=True and any dim <= 2, wrapped offsets alias; the aliased
    entries are summed by _dedup_coo, exactly as the JAX package does.
    """
    dims = list(dims)
    ndim = len(dims)
    total = int(np.prod(dims))
    coords = np.stack(
        np.meshgrid(*[np.arange(d) for d in dims], indexing="ij"), axis=-1
    ).reshape(total, ndim)
    strides = np.ones(ndim, np.int64)
    for i in range(ndim - 2, -1, -1):
        strides[i] = strides[i + 1] * dims[i + 1]

    rows_parts: List[np.ndarray] = []
    cols_parts: List[np.ndarray] = []
    node_ids = np.arange(total, dtype=np.int64)
    # offsets decoded in base 3 with dim 0 as the least significant digit;
    # the enumeration order does not matter after the sort in _dedup_coo
    for off_idx in range(3**ndim):
        tmp = off_idx
        deltas = []
        for _ in range(ndim):
            deltas.append(tmp % 3 - 1)
            tmp //= 3
        deltas = np.array(deltas, np.int64)
        if not deltas.any():
            continue
        nc = coords + deltas
        if torus:
            nc = nc % np.array(dims, np.int64)
            valid = np.ones(total, bool)
        else:
            valid = ((nc >= 0) & (nc < np.array(dims, np.int64))).all(axis=1)
        neighbor = (nc * strides).sum(axis=1)
        rows_parts.append(node_ids[valid])
        cols_parts.append(neighbor[valid])
    rows = np.concatenate(rows_parts) if rows_parts else np.zeros(0, np.int64)
    cols = np.concatenate(cols_parts) if cols_parts else np.zeros(0, np.int64)
    return _dedup_coo(total, rows, cols, np.ones(len(rows), np.uint64))


def thin(coo: Coo, density: float, seed: int = 0) -> Coo:
    """Randomly keep a fraction of edges, preserving symmetry: one rng draw
    per entry with r <= c (in the input's entry order); when an upper entry
    is kept, its transpose (if present) is kept too."""
    rows, cols, vals, n = coo
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals, np.uint64)
    rng = np.random.default_rng(seed)
    upper = rows <= cols
    keep_up = np.zeros(len(rows), bool)
    keep_up[upper] = rng.random(int(upper.sum())) < density
    ur, uc, uv = rows[keep_up], cols[keep_up], vals[keep_up]
    # transposes of kept strict-upper entries that exist in the input,
    # joined on (row, col) keys
    strict = ur != uc
    want_key = uc[strict] * n + ur[strict]
    key_all = rows * n + cols
    order = np.argsort(key_all, kind="stable")
    key_sorted = key_all[order]
    pos = np.searchsorted(key_sorted, want_key)
    pos_c = np.clip(pos, 0, len(key_sorted) - 1)
    found = (len(key_sorted) > 0) & (key_sorted[pos_c] == want_key)
    src_idx = order[pos_c[found]]
    out_r = np.concatenate([ur, rows[src_idx]])
    out_c = np.concatenate([uc, cols[src_idx]])
    out_v = np.concatenate([uv, vals[src_idx]])
    return _dedup_coo(n, out_r, out_c, out_v)
