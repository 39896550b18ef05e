"""Frozen numpy copies of the graph generators the configurations use.

Copies of ``lattice`` and ``_dedup_coo`` (``graphs/generate.py``) and of
``StdRng`` and ``thin_reference`` (``utils/stdrng.py``: the draws of Rust's
``rand::StdRng``, with which the reference thins its matrices) of the port,
kept here so that a change to the program cannot change the benchmark's
inputs.  They give the port's arrays bit for bit for the same arguments
(``tests/test_spbench_generators.py``).  COO triplets are
``(rows int32, cols int32, vals uint64, n)``.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def dedup_coo(n: int, rows, cols, vals):
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
    totals = np.zeros(seg[-1] + 1, dtype=object)
    np.add.at(totals, seg, vals.astype(object))
    totals = np.minimum(totals, 0xFFFFFFFFFFFFFFFF).astype(np.uint64)
    ur, uc = rows[head], cols[head]
    keep = totals != 0
    return ur[keep].astype(np.int32), uc[keep].astype(np.int32), totals[keep], n


def lattice(dims: Sequence[int], torus: bool):
    """N-D Moore-neighbourhood lattice, node index row-major: each node
    connects to every neighbour differing by at most 1 in each coordinate;
    ``torus`` wraps the coordinates."""
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
    return dedup_coo(total, rows, cols, np.ones(len(rows), np.uint64))


_SIGMA = np.array([0x61707865, 0x3320646E, 0x79622D32, 0x6B206574], np.uint32)


def _rotl(x: np.ndarray, n: int) -> np.ndarray:
    return (x << np.uint32(n)) | (x >> np.uint32(32 - n))


def _quarter(w, a, b, c, d):
    w[a] += w[b]
    w[d] = _rotl(w[d] ^ w[a], 16)
    w[c] += w[d]
    w[b] = _rotl(w[b] ^ w[c], 12)
    w[a] += w[b]
    w[d] = _rotl(w[d] ^ w[a], 8)
    w[c] += w[d]
    w[b] = _rotl(w[b] ^ w[c], 7)


def chacha12_words(key: np.ndarray, counter0: int, nblocks: int) -> np.ndarray:
    """ChaCha12 keystream words of blocks [counter0, counter0 + nblocks),
    block-major: state [sigma, key(8), counter64(2), stream64(2) = 0], 12
    rounds, output = working + initial."""
    assert key.dtype == np.uint32 and key.shape == (8,)
    ctr = np.uint64(counter0) + np.arange(nblocks, dtype=np.uint64)
    x = np.empty((16, nblocks), np.uint32)
    x[:4] = _SIGMA[:, None]
    x[4:12] = key[:, None]
    x[12] = (ctr & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    x[13] = (ctr >> np.uint64(32)).astype(np.uint32)
    x[14] = 0
    x[15] = 0
    w = x.copy()
    with np.errstate(over="ignore"):
        for _ in range(6):  # 12 rounds = 6 double rounds
            _quarter(w, 0, 4, 8, 12)
            _quarter(w, 1, 5, 9, 13)
            _quarter(w, 2, 6, 10, 14)
            _quarter(w, 3, 7, 11, 15)
            _quarter(w, 0, 5, 10, 15)
            _quarter(w, 1, 6, 11, 12)
            _quarter(w, 2, 7, 8, 13)
            _quarter(w, 3, 4, 9, 14)
        w += x
    return w.T.reshape(-1)


class StdRng:
    """Rust ``rand::StdRng::from_seed(seed)`` (rand 0.9, ChaCha12): u64
    draws as two consecutive words, low first, and ``random_range(0.0..1.0)``
    as the top 52 bits of a u64 over a float in [1, 2), minus 1."""

    def __init__(self, seed: bytes = b"\x2a" * 32):
        assert len(seed) == 32
        self.key = np.frombuffer(seed, "<u4").copy()
        self.counter = 0  # the next ChaCha block
        self._buf = np.empty(0, np.uint32)
        self._idx = 0

    def _words(self, n: int) -> np.ndarray:
        avail = len(self._buf) - self._idx
        if avail < n:
            nblk = -(-(n - avail) // 16)
            fresh = chacha12_words(self.key, self.counter, nblk)
            self.counter += nblk
            self._buf = np.concatenate([self._buf[self._idx:], fresh])
            self._idx = 0
        out = self._buf[self._idx: self._idx + n]
        self._idx += n
        return out

    def next_u64(self, count: int) -> np.ndarray:
        w = self._words(2 * count).reshape(-1, 2).astype(np.uint64)
        return w[:, 0] | (w[:, 1] << np.uint64(32))

    def unit_f64(self, count: int) -> np.ndarray:
        bits = (self.next_u64(count) >> np.uint64(12)) | np.uint64(1023 << 52)
        return bits.view(np.float64) - 1.0


def thin_reference(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, density: float,
                   rng: StdRng):
    """The reference's ``thin()`` on a symmetric COO: one unit draw per
    entry with r <= c in (row, col) order, kept where below ``density``; a
    kept entry brings its mirror.  Returns (rows, cols, vals)."""
    order = np.lexsort((cols, rows))
    r, c, v = rows[order], cols[order], vals[order]
    upper = r <= c
    keep = rng.unit_f64(int(upper.sum())) < density
    ru, cu, vu = r[upper][keep], c[upper][keep], v[upper][keep]
    nd = ru != cu
    return (np.concatenate([ru, cu[nd]]), np.concatenate([cu, ru[nd]]),
            np.concatenate([vu, vu[nd]]))


def relabel(coo, perm: np.ndarray):
    """The same graph with node i renamed perm[i]: the same entry count,
    products and values, in another order."""
    rows, cols, vals, n = coo
    perm = np.asarray(perm, np.int64)
    return perm[rows].astype(np.int32), perm[cols].astype(np.int32), vals, n
