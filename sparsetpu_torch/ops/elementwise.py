"""Elementwise (Hadamard) sparse ops: the counterpart of ``sparsetpu/ops/elementwise.py``.

``spmul`` multiplies the entries present in both matrices (the lattice
meet) by a merge of the two sorted entry streams: a key present in both
appears exactly twice after the concatenated sort, so the product lives at
every non-head position.  ``patterns_equal`` compares two sparsity patterns.
Plain torch on ``ops.segments``, as the JAX package's is plain XLA.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..csr import SparseCSR
from .segments import INT32_SENTINEL, compact, segment_heads, sort_by_keys


def spmul(a: SparseCSR, b: SparseCSR, out_cap: Optional[int] = None) -> SparseCSR:
    """C[i, j] = A[i, j] (x) B[i, j] where both are nonzero (the semiring's
    saturating multiply); products of zero are dropped.  ``out_cap``
    defaults to the smaller capacity; as in the JAX package, entries past
    it are dropped and nnz is clamped to it (not poisoned)."""
    if a.shape != b.shape or a.sr_name != b.sr_name:
        raise ValueError(f"spmul needs equal shapes and semirings, got "
                         f"{a.shape} {a.sr_name} and {b.shape} {b.sr_name}")
    out_cap = out_cap or min(a.capacity, b.capacity)
    sr = a.sr
    device = a.device
    valid = torch.cat([torch.arange(a.capacity, device=device) < a.nnz,
                       torch.arange(b.capacity, device=device) < b.nnz])
    rows = torch.cat([a.row_of_slot(), b.row_of_slot()])
    cols = torch.cat([a.col_idx, b.col_idx]).long()
    vals = tuple(torch.cat([x, y]) for x, y in zip(a.values, b.values))
    r = torch.where(valid, rows, a.n_rows)
    c = torch.where(valid, cols, INT32_SENTINEL)
    keys, payload = sort_by_keys([r, c], list(vals))
    heads = segment_heads(keys)
    # the value at a non-head position times its predecessor's
    prev = tuple(torch.cat([l[:1], l[:-1]]) for l in payload)
    prod = sr.mul(tuple(payload), prev)
    keep = (~heads) & (keys[0] < a.n_rows) & ~sr.is_zero(prod)
    fills = [a.n_rows, INT32_SENTINEL] + [0] * len(prod)
    outs, count = compact(keep, [keys[0], keys[1], *prod], fills, out_cap)
    row_ptr = torch.searchsorted(outs[0], torch.arange(a.n_rows + 1, device=device),
                                 side="left").int()
    in_range = torch.arange(out_cap, device=device) < count
    return SparseCSR(row_ptr=row_ptr,
                     col_idx=torch.where(in_range, outs[1], INT32_SENTINEL).int(),
                     values=tuple(outs[2:]), nnz=torch.clamp(count, max=out_cap),
                     n_rows=a.n_rows, n_cols=a.n_cols, sr_name=a.sr_name)


def patterns_equal(a: SparseCSR, b: SparseCSR) -> torch.Tensor:
    """Device bool: the sparsity patterns (nnz, row_ptr and the valid
    columns) are equal."""
    if a.shape != b.shape:
        return torch.zeros((), dtype=torch.bool, device=a.device)
    cap = max(a.capacity, b.capacity)
    av, bv = a.with_capacity(cap), b.with_capacity(cap)
    mask = torch.arange(cap, device=a.device) < a.nnz
    cols = torch.where(mask, av.col_idx == bv.col_idx, True).all()
    return (a.nnz == b.nnz) & (a.row_ptr == b.row_ptr).all() & cols
