"""Flat-array K-ary search tree: the port of ``sparsetpu/utils/dense_btree.py``.

A cache-friendly drop-in for binary search over sorted u32 keys, packing the
implicit K = 16-ary tree level by level in flat arrays.  ``DenseBTree``,
``DenseBTreeList`` and ``overhead_sweep`` are numpy copies of the JAX
package's host structures, bit-identical; ``build_device_btree`` and
``btree_lookup_device`` are the device lookup in torch, with the JAX
package's flat level layout and (pos, hit) contract.

Keys ride int64 tensors (torch's uint32 has thin operator coverage) with
the 0xFFFFFFFF sentinel as padding; queries must be below 0xFFFFFFFF.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..csr import DEFAULT_DEVICE, resolve_device

K = 16  # keys per node
SENTINEL = 0xFFFFFFFF  # the padding key of the device layout


@dataclasses.dataclass
class DenseBTree:
    """Search index over a sorted key array.

    Level with stride s holds the block maxima ``keys[s-1::s]``; levels are
    stored root (largest stride) first.  A lookup narrows the window by a
    factor of K per level, touching one small contiguous slice each time.
    """

    keys: np.ndarray            # sorted leaf keys
    levels: List[np.ndarray]    # root-first separator arrays
    strides: List[int]

    @staticmethod
    def from_sorted(keys) -> "DenseBTree":
        keys = np.ascontiguousarray(keys, np.uint32)
        levels: List[np.ndarray] = []
        strides: List[int] = []
        s = K
        while len(keys) // s > 0 and len(keys) > K:
            lvl = keys[s - 1::s]
            if len(lvl) == 0:
                break
            levels.append(lvl)
            strides.append(s)
            if len(lvl) <= K:
                break
            s *= K
        levels.reverse()
        strides.reverse()
        return DenseBTree(keys, levels, strides)

    def index(self, key) -> Optional[int]:
        """Position of ``key`` in the sorted array, or None."""
        lo, hi = 0, len(self.keys)
        for lvl, s in zip(self.levels, self.strides):
            s0 = lo // s
            s1 = min(len(lvl), -(-hi // s))
            pos = s0 + int(np.searchsorted(lvl[s0:s1], key, side="left"))
            lo = max(lo, pos * s)
            hi = min(hi, (pos + 1) * s)
            if lo >= hi:
                break
        i = lo + int(np.searchsorted(self.keys[lo:hi], key, side="left"))
        if i < len(self.keys) and self.keys[i] == key:
            return i
        return None

    def overhead(self) -> float:
        """Extra storage as a fraction of the leaf array."""
        extra = sum(len(l) for l in self.levels)
        return extra / max(len(self.keys), 1)


@dataclasses.dataclass
class DenseBTreeList:
    """Many per-row indexes packed with cumulative offsets."""

    trees: List[DenseBTree]
    data_start: np.ndarray

    @staticmethod
    def from_rows(rows: Sequence[np.ndarray]) -> "DenseBTreeList":
        starts = np.zeros(len(rows) + 1, np.int64)
        trees = []
        for i, r in enumerate(rows):
            trees.append(DenseBTree.from_sorted(r))
            starts[i + 1] = starts[i] + len(r)
        return DenseBTreeList(trees, starts)

    def index(self, row: int, key) -> Optional[int]:
        local = self.trees[row].index(key)
        if local is None:
            return None
        return int(self.data_start[row]) + local


def build_device_btree(keys, device=None):
    """Pack sorted uint32 keys (numpy, or an integer tensor) into the flat
    K-ary level layout on ``device`` (by default a tensor's own device,
    else the card): the keys padded with the sentinel to a power of K, so
    that a node's K separators are one contiguous (Q, K) gather a level.
    Returns (levels root-first, padded keys), int64."""
    if not isinstance(keys, torch.Tensor):
        keys = torch.from_numpy(np.ascontiguousarray(keys, np.uint32).astype(np.int64))
        device = DEFAULT_DEVICE if device is None else device
    if device is not None:
        keys = keys.to(resolve_device(device))
    keys = keys.long()
    n = max(keys.numel(), 1)
    depth = 1
    while K ** depth < n:
        depth += 1
    padded = torch.full((K ** depth,), SENTINEL, dtype=torch.int64, device=keys.device)
    padded[:keys.numel()] = keys
    levels = []
    s = K
    while s < padded.numel():
        levels.append(padded[s - 1::s].contiguous())
        s *= K
    levels.reverse()  # root (K separators) first
    return levels, padded


def _gather_node(arr: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """(Q, K) separators of the nodes at ``base``; indices past the array
    are clamped to its end, as the JAX package's gathers clamp them."""
    idx = base[:, None] + torch.arange(K, device=base.device)[None, :]
    return arr[idx.clamp(max=arr.numel() - 1)]


def btree_lookup_device(levels, keys: torch.Tensor, q: torch.Tensor):
    """Vectorised K-ary descent: per level one (Q, K) contiguous gather and
    a compare-and-count.  Returns (pos, hit) like searchsorted (left) plus
    equality.  As in the JAX package, a query above every key of an
    unpadded array with levels (n a power of K above K) gets a pos past n
    (and hit False)."""
    q = q.long()
    node = torch.zeros(q.shape, dtype=torch.int64, device=q.device)
    for lvl in levels:
        base = node * K
        node = base + (_gather_node(lvl, base) < q[:, None]).sum(dim=1)
    base = node * K
    pos = base + (_gather_node(keys, base) < q[:, None]).sum(dim=1)
    hit = keys[pos.clamp(0, keys.numel() - 1)] == q
    return pos, hit


def overhead_sweep(max_n: int = 10000, step: int = 117) -> str:
    """CSV of storage overhead against n (``reports/btree_overhead.csv``)."""
    lines = ["n,overhead"]
    for n in range(1, max_n, step):
        t = DenseBTree.from_sorted(np.arange(n, dtype=np.uint32))
        lines.append(f"{n},{t.overhead():.6f}")
    return "\n".join(lines) + "\n"
