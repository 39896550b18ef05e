"""Pure-Python exact saturating-semiring oracle for differential tests: a
copy of ``sparsetpu/utils/oracle.py`` (numpy and scipy only).

Plays the role of the reference's cross-implementation agreement tests
(src/graph_magnus.rs:859-881): every device kernel is checked against this
slow-but-obviously-correct implementation on small inputs.  Python ints are
arbitrary precision, so saturation is applied explicitly and exactly.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

U32_MAX = 0xFFFFFFFF
U64_MAX = 0xFFFFFFFFFFFFFFFF

_SAT_MAX = {"u32": U32_MAX, "u64": U64_MAX, "f32": None}

CooDict = Dict[Tuple[int, int], int]


def coo_to_dict(coo) -> CooDict:
    rows, cols, vals, n = coo
    return {(int(r), int(c)): int(v) for r, c, v in zip(rows, cols, vals)}


def sat_add(a, b, sr: str = "u64"):
    m = _SAT_MAX[sr]
    if m is None:
        return np.float32(a) + np.float32(b)
    return min(a + b, m)


def sat_mul(a, b, sr: str = "u64"):
    m = _SAT_MAX[sr]
    if m is None:
        return np.float32(a) * np.float32(b)
    return min(a * b, m)


def matmul(a: CooDict, b: CooDict, sr: str = "u64") -> CooDict:
    """Gustavson row-map matmul with saturating semiring
    (reference matmul_maps, src/graph.rs:178-206)."""
    b_rows: Dict[int, list] = {}
    for (r, c), v in b.items():
        b_rows.setdefault(r, []).append((c, v))
    out: CooDict = {}
    for (i, k), a_ik in a.items():
        for j, b_kj in b_rows.get(k, []):
            prod = sat_mul(a_ik, b_kj, sr)
            key = (i, j)
            out[key] = sat_add(out.get(key, 0), prod, sr)
    return {k: v for k, v in out.items() if v != 0}


def add(a: CooDict, b: CooDict, sr: str = "u64") -> CooDict:
    out = dict(a)
    for k, v in b.items():
        out[k] = sat_add(out.get(k, 0), v, sr)
    return {k: v for k, v in out.items() if v != 0}


def to_dense(d: CooDict, n: int, m=None) -> np.ndarray:
    m = n if m is None else m
    out = np.zeros((n, m), np.uint64)
    for (r, c), v in d.items():
        out[r, c] = v
    return out


def nnz(d: CooDict) -> int:
    return len(d)


def scipy_matmul_int(coo_a, coo_b):
    """Fast non-saturating int64 oracle via scipy for larger graphs where
    values stay far below 2^63 (the torus A^k chain).  Returns a CooDict."""
    from scipy import sparse

    ra, ca, va, n = coo_a
    rb, cb, vb, n2 = coo_b
    A = sparse.csr_matrix((va.astype(np.int64), (ra, ca)), shape=(n, coo_a[3]))
    B = sparse.csr_matrix((vb.astype(np.int64), (rb, cb)), shape=(n2, n2))
    C = (A @ B).tocoo()
    return {(int(r), int(c)): int(v) for r, c, v in zip(C.row, C.col, C.data)}
