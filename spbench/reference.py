"""The plain reference: exact integer graph products in plain PyTorch, and
the comparison that judges the program's products against them.

It imports nothing of the program.  It builds A again from the COO arrays
the program was given and multiplies row block by row block: every partial
product of a block expanded, sorted by (row, col) and summed.  Values are
int64; a guard raises before a product whose entries could reach 2^63, so
below it the sums are the u64 semiring's exactly (nothing saturates).

The comparison counts wrong entries: entries of the reference missing from
the program's product or holding another value, and entries of the
program's product that the reference does not have.  Exact products have
the limit 0.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, Optional

import numpy as np
import torch

BLOCK_PRODUCTS = 1 << 25  # partial products expanded at once (~2 GiB of temporaries)


@dataclasses.dataclass
class CSR:
    """n_rows x n_cols CSR: int64 row offsets, columns and values, sorted by
    (row, col), no zeros."""

    row_ptr: torch.Tensor
    col: torch.Tensor
    val: torch.Tensor
    n_rows: int
    n_cols: int

    @property
    def nnz(self) -> int:
        return int(self.col.numel())

    def rows(self) -> torch.Tensor:
        return torch.repeat_interleave(torch.arange(self.n_rows, device=self.col.device),
                                       torch.diff(self.row_ptr), output_size=self.nnz)

    def max_value(self) -> int:
        return int(self.val.max()) if self.nnz else 0


def _from_sorted_keys(key: torch.Tensor, val: torch.Tensor, n_rows: int, n_cols: int,
                      rounding: Optional[Callable] = None) -> CSR:
    """Sorted (row * n_cols + col) keys with their values -> CSR, duplicates
    summed and zeros dropped."""
    uk, inv = torch.unique_consecutive(key, return_inverse=True)
    sums = torch.zeros(uk.numel(), dtype=torch.int64, device=key.device).index_add_(0, inv, val)
    if rounding is not None:
        sums = rounding(sums)
    keep = sums != 0
    uk, sums = uk[keep], sums[keep]
    rows = uk // n_cols
    row_ptr = torch.searchsorted(rows, torch.arange(n_rows + 1, device=key.device))
    return CSR(row_ptr, uk % n_cols, sums, n_rows, n_cols)


def from_coo(rows, cols, vals, n: int, device) -> CSR:
    """The n x n matrix of a COO stream (numpy), duplicates summed."""
    vals = np.asarray(vals, np.uint64)
    if vals.size and int(vals.max()) >= 1 << 63:
        raise OverflowError("the reference carries values below 2^63")
    r = torch.as_tensor(np.asarray(rows, np.int64), device=device)
    c = torch.as_tensor(np.asarray(cols, np.int64), device=device)
    v = torch.as_tensor(vals.astype(np.int64), device=device)
    key, order = torch.sort(r * n + c)
    return _from_sorted_keys(key, v[order], n, n)


def _row_blocks(row_products: np.ndarray, budget: int) -> Iterator[tuple]:
    """Consecutive row ranges of at most ``budget`` partial products each
    (a single row may exceed it)."""
    cum = np.cumsum(row_products)
    n, r0, done = len(row_products), 0, 0
    while r0 < n:
        r1 = int(np.searchsorted(cum, done + budget, side="right"))
        r1 = min(max(r1, r0 + 1), n)
        yield r0, r1
        done = int(cum[r1 - 1])
        r0 = r1


def matmul(left: CSR, right: CSR, rounding: Optional[Callable] = None,
           budget: int = BLOCK_PRODUCTS) -> CSR:
    """left x right, exact; ``rounding``, when given, is applied to every
    summed entry (the control's lower precision)."""
    if left.n_cols != right.n_rows:
        raise ValueError(f"{left.n_rows}x{left.n_cols} x {right.n_rows}x{right.n_cols}")
    device = left.col.device
    lrows = left.rows()
    # every entry of the product is at most (largest row sum of left) x (largest of right)
    row_sums = torch.zeros(left.n_rows, dtype=torch.int64, device=device).index_add_(
        0, lrows, left.val)
    if left.nnz and int(row_sums.max()) * right.max_value() >= 1 << 63:
        raise OverflowError("a product entry could reach 2^63; the reference is int64")
    counts = (right.row_ptr[left.col + 1] - right.row_ptr[left.col])
    row_products = torch.zeros(left.n_rows, dtype=torch.int64, device=device).index_add_(
        0, lrows, counts)
    row_ptr_host = left.row_ptr.cpu().numpy()
    parts, row_ptrs, base = [], [torch.zeros(1, dtype=torch.int64, device=device)], 0
    for r0, r1 in _row_blocks(row_products.cpu().numpy(), budget):
        e0, e1 = int(row_ptr_host[r0]), int(row_ptr_host[r1])
        cnt = counts[e0:e1]
        total = int(cnt.sum())
        if total == 0:
            row_ptrs.append(torch.full((r1 - r0,), base, dtype=torch.int64, device=device))
            continue
        src = torch.repeat_interleave(torch.arange(e1 - e0, device=device), cnt,
                                      output_size=total)
        start = torch.cumsum(cnt, 0) - cnt
        pos = (torch.arange(total, device=device) - start[src]
               + right.row_ptr[left.col[e0:e1]][src])
        key = (lrows[e0:e1][src] - r0) * right.n_cols + right.col[pos]
        val = left.val[e0:e1][src] * right.val[pos]
        del src, start
        key, order = torch.sort(key)
        block = _from_sorted_keys(key, val[order], r1 - r0, right.n_cols, rounding)
        del key, val, order, pos
        parts.append((block.col, block.val))
        row_ptrs.append(block.row_ptr[1:] + base)
        base += block.nnz
    col = torch.cat([p[0] for p in parts]) if parts else torch.zeros(0, dtype=torch.int64,
                                                                    device=device)
    val = torch.cat([p[1] for p in parts]) if parts else torch.zeros_like(col)
    return CSR(torch.cat(row_ptrs), col, val, left.n_rows, right.n_cols)


def round_bf16(v: torch.Tensor) -> torch.Tensor:
    """Integers carried through bfloat16 (8 significant bits): the control."""
    return v.to(torch.float32).to(torch.bfloat16).to(torch.float32).round().to(torch.int64)


# -- judging the program's products -------------------------------------------

class ProgramCSR:
    """A CSR product of the program, read from its tensors only: int32 row
    offsets and columns, uint32 value limbs (low first) in int64 tensors,
    and its entry count (-1 when poisoned)."""

    def __init__(self, row_ptr, col_idx, limbs, nnz, n_rows: int, n_cols: int):
        self.nnz = int(nnz)
        self.n_rows, self.n_cols = n_rows, n_cols
        self.row_ptr = row_ptr.long()
        self.col = col_idx.long()
        self.limbs = limbs
        rp = self.row_ptr.cpu().numpy()
        self.valid = (self.nnz >= 0 and len(rp) == n_rows + 1 and rp[0] == 0
                      and rp[-1] == self.nnz and bool(np.all(np.diff(rp) >= 0))
                      and self.nnz <= self.col.numel())
        self.rp = rp

    def wrong(self, block: CSR, r0: int) -> int:
        """Wrong entries in rows [r0, r0 + block.n_rows)."""
        r1 = r0 + block.n_rows
        e0, e1 = int(self.rp[r0]), int(self.rp[r1])
        col = self.col[e0:e1]
        val = sum(l[e0:e1].long() << (32 * k) for k, l in enumerate(self.limbs))
        rows = torch.repeat_interleave(torch.arange(block.n_rows, device=col.device),
                                       torch.from_numpy(np.diff(self.rp[r0:r1 + 1])).to(col.device),
                                       output_size=e1 - e0)
        good = (col >= 0) & (col < self.n_cols)
        bad = int((~good).sum())
        return bad + _wrong_sorted(block, rows[good] * self.n_cols + col[good], val[good])


class ProgramDense:
    """A dense (n_rows, n_cols) float32 product of the program."""

    def __init__(self, dense: torch.Tensor):
        self.dense = dense
        self.n_rows, self.n_cols = dense.shape
        self.valid = True

    def wrong(self, block: CSR, r0: int) -> int:
        d = self.dense[r0:r0 + block.n_rows]
        got = d[block.rows(), block.col].double()
        matched = int((got == block.val.double()).sum())
        extra = int(torch.count_nonzero(d)) - int(torch.count_nonzero(got))
        return (block.nnz - matched) + extra


def _wrong_sorted(block: CSR, keys: torch.Tensor, vals: torch.Tensor) -> int:
    keys, order = torch.sort(keys)
    vals = vals[order]
    want = block.rows() * block.n_cols + block.col
    if keys.numel() == 0:
        return block.nnz
    pos = torch.searchsorted(keys, want).clamp(max=keys.numel() - 1)
    matched = int(((keys[pos] == want) & (vals[pos] == block.val)).sum())
    return (block.nnz - matched) + (keys.numel() - matched)


def _slice(ref: CSR, r0: int, r1: int) -> CSR:
    e0, e1 = int(ref.row_ptr[r0]), int(ref.row_ptr[r1])
    return CSR(ref.row_ptr[r0:r1 + 1] - e0, ref.col[e0:e1], ref.val[e0:e1], r1 - r0, ref.n_cols)


def wrong_entries(ref: CSR, prog, budget: int = BLOCK_PRODUCTS) -> int:
    """Entries in which the program's product ``prog`` (``ProgramCSR``,
    ``ProgramDense`` or a reference ``CSR``) differs from ``ref``."""
    if isinstance(prog, CSR):
        prog = ProgramCSR(prog.row_ptr, prog.col, (prog.val,), prog.nnz, prog.n_rows, prog.n_cols)
    if (prog.n_rows, prog.n_cols) != (ref.n_rows, ref.n_cols) or not prog.valid:
        return ref.nnz + max(getattr(prog, "nnz", 0), 0) + 1
    rp = ref.row_ptr.cpu().numpy()
    wrong = 0
    for r0, r1 in _row_blocks(np.diff(rp), budget):
        wrong += prog.wrong(_slice(ref, r0, r1), r0)
    return wrong
