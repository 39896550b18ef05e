"""Graph algorithms built on repeated sparse products: the counterpart of
``sparsetpu/graphs/algos.py``.

Reachability (the sum of powers), power-until-stable, components by closure
and by min-label propagation, bandwidth statistics, reverse Cuthill-McKee,
permutations and the diameter by squaring.  Host loops around device
products (``spgemm_auto``, ``spadd``, ``spmul``); the pattern-mode
algorithms take the dense int8 engine (``graphs.patterns``) when the frame
fits the card, as the JAX package takes it when the frame fits its TPU.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import List, Tuple

import numpy as np
import torch

from ..csr import SparseCSR
from ..ops.elementwise import patterns_equal, spmul
from ..ops.spgemm import spadd, spgemm_auto
from . import patterns
from .patterns import ConvergenceError

INT32_MAX = (1 << 31) - 1  # the empty segment's minimum, as jax.ops.segment_min's


def _pow2(x: int) -> int:
    return 1 << (max(x, 1) - 1).bit_length()


def _pattern(c: SparseCSR) -> SparseCSR:
    """Every stored value clamped to one: the boolean-reachability view.
    Path counts on dense closures pass every exact range (a 2.7k power-law
    closure squared exceeds 2^24 an entry), but reachability and the
    diameter read only the pattern.  Padding slots keep value zero."""
    valid = torch.arange(c.capacity, device=c.device) < c.nnz
    ones = c.sr.ones((c.capacity,), device=c.device)
    return dataclasses.replace(c, values=tuple(torch.where(valid, o, 0) for o in ones))


def matmul(a: SparseCSR, b: SparseCSR) -> SparseCSR:
    return spgemm_auto(a, b)


def add(a: SparseCSR, b: SparseCSR) -> SparseCSR:
    return spadd(a, b, out_cap=_pow2(a.capacity + b.capacity))


def _route_dense(n: int, dense: str) -> bool:
    if dense == "never":
        return False
    if dense == "always":
        if not patterns.fits(n):
            raise ValueError(f"a pattern frame of {n} nodes exceeds "
                             f"MAX_PATTERN_N = {patterns.MAX_PATTERN_N}")
        return True
    if dense != "auto":
        raise ValueError(f"dense must be 'auto', 'always' or 'never', not {dense!r}")
    return patterns.fits(n)


def reachability_sum(a: SparseCSR, max_iters: int = 64, pattern: bool = False,
                     dense: str = "auto") -> Tuple[SparseCSR, int]:
    """S = A + A^2 + ... until the nnz pattern stabilises; returns (S, k).

    ``pattern=True`` clamps each power's values to one (``_pattern``): the
    same nnz trajectory, values within the dense accumulator's exact range.
    Pattern mode takes the dense int8 engine when the frame fits
    (``dense="auto"``; "never" forces the sparse route, "always" requires
    the frame to fit)."""
    if pattern and _route_dense(a.n_rows, dense):
        return patterns.reachability_sum(a, max_iters=max_iters)
    power = total = a
    k = 1
    for _ in range(max_iters):
        power = spgemm_auto(power, a)
        if pattern:
            power = _pattern(power)
        k += 1
        new_total = add(total, power)
        if pattern:
            new_total = _pattern(new_total)
        if int(new_total.nnz) == int(total.nnz):
            return new_total, k
        total = new_total
    raise ConvergenceError("reachability did not converge")


def reachability_nnz(a: SparseCSR, max_iters: int = 64, dense: str = "auto") -> Tuple[int, int]:
    """(nnz, k) of ``reachability_sum(a, pattern=True)``.  The dense route
    counts its frame and builds no CSR, so a reachability set past a
    SparseCSR's int32 offsets (nell's 4.3e9 entries) is still counted."""
    if _route_dense(a.n_rows, dense):
        return patterns.reachability_nnz(a, max_iters=max_iters)
    total, k = reachability_sum(a, max_iters=max_iters, pattern=True, dense="never")
    return int(total.nnz), k


def power_until_stable(a: SparseCSR, max_iters: int = 64, pattern: bool = False,
                       dense: str = "auto") -> Tuple[SparseCSR, int]:
    """Repeated squaring until the sparsity pattern is a fixed point.
    Pattern mode takes the dense int8 engine when the frame fits."""
    if pattern and _route_dense(a.n_rows, dense):
        return patterns.power_until_stable(a, max_iters=max_iters)
    current = _pattern(a) if pattern else a
    for k in range(1, max_iters + 1):
        nxt = spgemm_auto(current, current)
        if pattern:
            nxt = _pattern(nxt)
        if bool(patterns_equal(nxt, current)):
            return nxt, k
        current = nxt
    raise ConvergenceError("power_until_stable did not converge")


def connected_components_closure(a: SparseCSR, dense: str = "auto") -> np.ndarray:
    """Components by transitive closure: add the identity, square to the
    fixed point, mutual reachability = the same component.  Labels are
    sequential by first appearance (ascending least node id).  The dense
    int8 route applies whenever the frame fits."""
    if _route_dense(a.n_rows, dense):
        return patterns.connected_components_closure(a)
    n = a.n_rows
    with_id = add(a, SparseCSR.identity(n, sr=a.sr, device=a.device))
    closure, _ = power_until_stable(with_id)
    tc = closure.transpose(capacity=closure.capacity)
    mutual = spmul(closure, tc, out_cap=closure.capacity)
    # the least column of each row of `mutual` is its component's representative
    valid = torch.arange(mutual.capacity, device=a.device) < mutual.nnz
    cols = torch.where(valid, mutual.col_idx.long(), n)
    rep = torch.full((n + 1,), INT32_MAX, dtype=torch.int64, device=a.device)
    rep.scatter_reduce_(0, mutual.row_of_slot(), cols, "amin")
    return _renumber(rep[:n].cpu().numpy())


def connected_components(a: SparseCSR, max_iters: int = 64) -> np.ndarray:
    """Min-label propagation with pointer jumping on the undirected view:
    O(log n) rounds of a gather and a segment minimum (``scatter_reduce``
    "amin").  Stops after ``max_iters`` rounds without raising, as the JAX
    package does."""
    n = a.n_rows
    valid = torch.arange(a.capacity, device=a.device) < a.nnz
    rows = a.row_of_slot()[valid]
    cols = a.col_idx.long()[valid]
    er = torch.cat([rows, cols])
    ec = torch.cat([cols, rows])
    labels = torch.arange(n, device=a.device)
    for _ in range(max_iters):
        cand = torch.full((n,), INT32_MAX, dtype=torch.int64, device=a.device)
        cand.scatter_reduce_(0, er, labels[ec], "amin")
        new = torch.minimum(labels, cand)
        # pointer jumping
        new = torch.minimum(new, new[new])
        new = torch.minimum(new, new[new])
        if torch.equal(new, labels):
            break
        labels = new
    return _renumber(labels.cpu().numpy())


def num_components(a: SparseCSR) -> int:
    return int(connected_components(a).max()) + 1 if a.n_rows else 0


def _renumber(rep: np.ndarray) -> np.ndarray:
    """Map representatives to sequential ids by first appearance."""
    _, inv = np.unique(rep, return_inverse=True)
    return inv.astype(np.int64)


def bandwidth_stats(a: SparseCSR) -> Tuple[int, float]:
    """(max |r - c|, mean |r - c|) over the nonzeros, in host int64."""
    rp, ci, _ = a.to_numpy()
    if len(ci) == 0:
        return 0, 0.0
    r = np.repeat(np.arange(a.n_rows, dtype=np.int64), np.diff(rp))
    d = np.abs(r - ci.astype(np.int64))
    return int(d.max()), float(d.mean())


def permute(a: SparseCSR, perm: np.ndarray) -> SparseCSR:
    """Reorder rows and columns by a permutation with perm[new] = old; the
    same perm in ``unpermute`` undoes it."""
    n = a.n_rows
    perm = np.asarray(perm)
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n, dtype=np.int64)
    inv_t = torch.from_numpy(inv).to(a.device)
    valid = torch.arange(a.capacity, device=a.device) < a.nnz
    r = torch.where(valid, inv_t[a.row_of_slot().clamp(0, n - 1)], n)
    c = torch.where(valid, inv_t[a.col_idx.long().clamp(0, n - 1)], 0)
    return SparseCSR.from_coo_device(r, c, a.values, n, a.n_cols, a.sr, a.capacity,
                                     valid=valid)


def unpermute(a: SparseCSR, perm: np.ndarray) -> SparseCSR:
    perm = np.asarray(perm)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return permute(a, inv)


def rcm(a: SparseCSR) -> Tuple[SparseCSR, np.ndarray]:
    """Reverse Cuthill-McKee (host BFS): (the permuted matrix, perm) with
    perm[new] = old, the JAX package's permutation bit for bit.  The
    adjacency is walked as Python lists, not numpy scalars."""
    n = a.n_rows
    row_ptr, col_idx, _ = a.to_numpy()
    rp = row_ptr.tolist()
    ci = col_idx.tolist()
    deg = np.diff(row_ptr).tolist()
    visited = bytearray(n)
    order: List[int] = []
    seed = 0
    while len(order) < n:
        # the smallest unvisited node seeds the next BFS; a directed BFS from
        # the peripheral start may not cover the seed itself, hence a loop
        while seed < n and visited[seed]:
            seed += 1
        if seed >= n:
            break
        # BFS from the seed; the last dequeued node not yet ordered
        # approximates a peripheral node (a weakly connected directed graph
        # cannot restart from an ordered node)
        start = seed
        q = deque([seed])
        vis2 = bytearray(n)
        vis2[seed] = 1
        while q:
            u = q.popleft()
            if not visited[u]:
                start = u
            for v in ci[rp[u]:rp[u + 1]]:
                if not vis2[v]:
                    vis2[v] = 1
                    q.append(v)
        # the main BFS from start, neighbours by ascending degree (stable)
        q = deque([start])
        visited[start] = 1
        while q:
            u = q.popleft()
            order.append(u)
            nbrs = [v for v in ci[rp[u]:rp[u + 1]] if not visited[v]]
            nbrs.sort(key=lambda v: deg[v])
            for v in nbrs:
                if not visited[v]:
                    visited[v] = 1
                    q.append(v)
    order.reverse()
    perm = np.asarray(order, np.int64)
    return permute(a, perm), perm


def diameter(a: SparseCSR, max_iters: int = 64, dense: str = "auto") -> int:
    """Graph diameter: square (A + I) to the fixed point, then refine
    linearly from the last non-full power.  Assumes a connected graph.
    Takes the dense int8 engine when the frame fits."""
    if _route_dense(a.n_rows, dense):
        return patterns.diameter(a, max_iters=max_iters)
    n = a.n_rows
    # pattern mode throughout: the diameter reads only nnz stability, and
    # path counts on dense closures pass every exact range
    base = _pattern(add(a, SparseCSR.identity(n, sr=a.sr, device=a.device)))
    powers, steps = [base], [1]
    current, length = base, 1
    for _ in range(max_iters):
        nxt = _pattern(spgemm_auto(current, current))
        length *= 2
        if bool(patterns_equal(nxt, current)):
            break
        powers.append(nxt)
        steps.append(length)
        current = nxt
    target_nnz = int(current.nnz)
    # linear refinement from the last non-full power
    reach, d = powers[-1], steps[-1]
    if int(reach.nnz) == target_nnz and len(powers) > 1:
        reach, d = powers[-2], steps[-2]
    while int(reach.nnz) != target_nnz:
        reach = _pattern(spgemm_auto(reach, base))
        d += 1
    return d
