"""CSR matrices for the port: the counterpart of ``sparsetpu/csr.py``.

Two forms:

- ``HostCSR``: unpadded numpy CSR for the chain kernels.  ``from_coo`` merges
  duplicates (saturating u64/u32) and drops zeros, and ``to_device`` hands
  the arrays to the GPU kernels in their f32-carrier form.
- ``SparseCSR``: the device CSR of the exact semirings, as in the JAX
  package: ``row_ptr``/``col_idx`` and a tuple of value limbs (see
  ``semiring.py``) in tensors of a fixed ``capacity >= nnz``.  Entries
  [0, nnz) are valid and sorted by (row, col); the padded tail holds column
  ``INT32_SENTINEL`` and value 0.  ``nnz`` stays on the device; an operation
  whose result overflows its capacity poisons it to -1, and ``check()``
  raises.  Its COO -> CSR build sorts by one int64 (row, col) key at every
  shape: the JAX package's fused int32 key exists only below
  (n_rows + 1) * n_cols < 2^31, and attention's score matrix at GPT-2 117M
  has 98,304^2 = 9.7e9 entries.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .ops import segments
from .ops.segments import INT32_SENTINEL, KEY_SENTINEL
from .semiring import U64, Semiring, Value, by_name

SEMIRINGS = ("u64", "u32", "f32")
F32_EXACT_LIMIT = float(1 << 24)  # integers carried in f32 are exact below this
_SATURATE = {"u64": (1 << 64) - 1, "u32": (1 << 32) - 1}
DEFAULT_DEVICE = "cuda"  # where the entry points build unless asked for another


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``.  The entry points default to the
    card; where no card is present, a CUDA device raises rather than fall
    back to the CPU, which a caller must ask for (``device="cpu"``)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA card is present for device {device}; pass "
                           "device='cpu' to build on the CPU")
    return device


def _merge_coo(rows, cols, vals, n_cols: int, sr_name: str):
    """Sort a COO stream by (row, col), merge duplicates with the semiring's
    add and drop zero totals.  The sums are exact: float64 in entry order
    for f32, python ints saturated for u32/u64.  Returns (rows int64, cols
    int64, totals float32 or uint64)."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals)
    if not rows.size:
        return rows, cols, np.zeros(0, np.float32 if sr_name == "f32" else np.uint64)
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    key = rows * n_cols + cols
    head = np.ones(len(key), bool)
    head[1:] = key[1:] != key[:-1]
    seg = np.cumsum(head) - 1
    if sr_name == "f32":
        totals = np.bincount(seg, weights=vals.astype(np.float64)).astype(np.float32)
    else:
        totals = np.zeros(seg[-1] + 1, dtype=object)
        np.add.at(totals, seg, vals.astype(np.uint64).astype(object))
        totals = np.minimum(totals, _SATURATE[sr_name]).astype(np.uint64)
    keep = totals != 0
    return rows[head][keep], cols[head][keep], totals[keep]


def _row_ptr(rows: np.ndarray, n_rows: int) -> np.ndarray:
    """int64[n_rows + 1] row offsets of sorted entry rows."""
    counts = np.bincount(rows, minlength=n_rows)
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class HostCSR:
    """n_rows x n_cols CSR in numpy; entries sorted by (row, col), no zeros."""

    row_ptr: np.ndarray  # int64[n_rows + 1]
    col_idx: np.ndarray  # int32[nnz]
    vals: np.ndarray     # uint64[nnz] (u64, u32) or float32[nnz] (f32)
    n_rows: int
    n_cols: int
    sr_name: str

    @property
    def nnz(self) -> int:
        return int(self.row_ptr[-1])

    def rows(self) -> np.ndarray:
        """int64[nnz]: the row of every entry."""
        return np.repeat(np.arange(self.n_rows, dtype=np.int64),
                         np.diff(self.row_ptr))

    @staticmethod
    def from_coo(rows, cols, vals, n_rows: int, n_cols: Optional[int] = None,
                 sr_name: str = "u64") -> "HostCSR":
        """COO -> CSR: duplicates merge with the semiring's (saturating) add
        and zero entries are dropped."""
        if sr_name not in SEMIRINGS:
            raise ValueError(f"unknown semiring {sr_name!r}; have {SEMIRINGS}")
        n_cols = n_rows if n_cols is None else n_cols
        rows, cols, totals = _merge_coo(rows, cols, vals, n_cols, sr_name)
        return HostCSR(_row_ptr(rows, n_rows), cols.astype(np.int32), totals,
                       n_rows, n_cols, sr_name)

    def to_device(self, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(row_ptr int32, col_idx int32, vals float32) tensors on ``device``.

        Integer semirings ride an f32 carrier, exact only below 2^24, so a
        larger value raises ValueError (the f32 semiring has no such bound)."""
        if (self.sr_name != "f32" and self.nnz
                and float(self.vals.max()) >= F32_EXACT_LIMIT):
            raise ValueError("the f32 carrier requires integer values < 2^24")
        if self.nnz >= 2**31:
            raise ValueError(f"nnz {self.nnz} does not fit int32 row offsets")
        return (
            torch.from_numpy(self.row_ptr.astype(np.int32)).to(device),
            torch.from_numpy(self.col_idx.astype(np.int32)).to(device),
            torch.from_numpy(self.vals.astype(np.float32)).to(device),
        )


@dataclasses.dataclass(frozen=True)
class SparseCSR:
    """n_rows x n_cols semiring-valued CSR on a device, padded to a capacity."""

    row_ptr: torch.Tensor  # int32[n_rows + 1]
    col_idx: torch.Tensor  # int32[capacity], padded tail = INT32_SENTINEL
    values: Value          # sr.nlimbs tensors [capacity]
    nnz: torch.Tensor      # int64 scalar on the device; -1 when poisoned
    n_rows: int
    n_cols: int
    sr_name: str

    # -- static views --------------------------------------------------------
    @property
    def sr(self) -> Semiring:
        return by_name(self.sr_name)

    @property
    def capacity(self) -> int:
        return self.col_idx.shape[0]

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_rows, self.n_cols)

    @property
    def device(self) -> torch.device:
        return self.col_idx.device

    def _slots(self) -> torch.Tensor:
        return torch.arange(self.capacity, device=self.device)

    def row_of_slot(self) -> torch.Tensor:
        """int64[capacity]: the row of each slot (n_rows for padding)."""
        starts = self.row_ptr[:-1].long()
        # rows starting past the last entry drop out of the repeat
        starts = torch.where(starts < self.nnz, starts, self.capacity)
        rows = segments.repeat_index(
            starts, torch.arange(self.n_rows, device=self.device), self.capacity)
        return torch.where(self._slots() < self.nnz, rows, self.n_rows)

    def row_nnz(self) -> torch.Tensor:
        return self.row_ptr[1:] - self.row_ptr[:-1]

    # -- conversion ----------------------------------------------------------
    def to_dense(self) -> Tuple[torch.Tensor, ...]:
        """Dense (n_rows, n_cols) limb tensors; padded slots dropped."""
        valid = self._slots() < self.nnz
        size = self.n_rows * self.n_cols
        flat = torch.where(valid, self.row_of_slot() * self.n_cols + self.col_idx.long(),
                           size)
        outs = []
        for limb in self.values:
            d = torch.zeros(size + 1, dtype=limb.dtype, device=self.device)
            d[flat] = limb  # valid slots are distinct; the rest land in the dump slot
            outs.append(d[:size].view(self.n_rows, self.n_cols))
        return tuple(outs)

    def to_numpy(self):
        """Host (row_ptr, col_idx, values): values uint64 (u32, u64) or float32."""
        nnz = int(self.nnz)
        row_ptr = self.row_ptr.cpu().numpy()
        col_idx = self.col_idx[:nnz].cpu().numpy()
        vals = self.sr.to_numpy(tuple(l[:nnz] for l in self.values))
        return row_ptr, col_idx, vals

    def to_dense_numpy(self) -> np.ndarray:
        row_ptr, col_idx, vals = self.to_numpy()
        out = np.zeros((self.n_rows, self.n_cols), dtype=vals.dtype)
        out[np.repeat(np.arange(self.n_rows), np.diff(row_ptr)), col_idx] = vals
        return out

    # -- construction --------------------------------------------------------
    @staticmethod
    def empty(n_rows: int, n_cols: int, capacity: int, sr: Semiring,
              device=DEFAULT_DEVICE) -> "SparseCSR":
        device = resolve_device(device)
        return SparseCSR(
            row_ptr=torch.zeros(n_rows + 1, dtype=torch.int32, device=device),
            col_idx=torch.full((capacity,), INT32_SENTINEL, dtype=torch.int32,
                               device=device),
            values=sr.zeros((capacity,), device=device),
            nnz=torch.zeros((), dtype=torch.int64, device=device),
            n_rows=n_rows, n_cols=n_cols, sr_name=sr.name)

    @staticmethod
    def identity(n: int, capacity: Optional[int] = None, sr: Semiring = U64,
                 device=DEFAULT_DEVICE) -> "SparseCSR":
        """The n x n identity (the semiring's one on the diagonal)."""
        device = resolve_device(device)
        cap = capacity or n
        if cap < n:
            raise ValueError(f"capacity {cap} < n {n}")
        idx = torch.arange(n, device=device)
        out = SparseCSR.empty(n, n, cap, sr, device)
        out.col_idx[:n] = idx.int()
        for limb, one in zip(out.values, sr.ones((n,), device=device)):
            limb[:n] = one
        return dataclasses.replace(
            out, row_ptr=torch.arange(n + 1, dtype=torch.int32, device=device),
            nnz=torch.tensor(n, dtype=torch.int64, device=device))

    @staticmethod
    def from_coo_device(rows: torch.Tensor, cols: torch.Tensor, values: Value,
                        n_rows: int, n_cols: int, sr: Semiring, capacity: int,
                        valid: Optional[torch.Tensor] = None) -> "SparseCSR":
        """COO -> CSR on the device: sort by (row, col), merge duplicates with
        the semiring's add, drop zeros, no host synchronisation.  ``values``
        may carry fewer limbs than the semiring (u64 carried narrow in one
        limb, ``ops/spgemm.expand_products``); the output is always full."""
        if (n_rows + 1) * n_cols >= KEY_SENTINEL:
            raise ValueError(f"({n_rows}, {n_cols}) does not fit an int64 (row, col) key")
        device = rows.device
        if valid is None:
            valid = torch.ones(rows.shape, dtype=torch.bool, device=device)
        key = torch.where(valid, rows.long() * n_cols + cols.long(), KEY_SENTINEL)
        key, perm = torch.sort(key, stable=True)
        payload = tuple(torch.where(valid, l, 0)[perm] for l in values)
        (fused,), out_vals, nnz = segments.reduce_sorted_coo(
            sr, [key], payload, key != KEY_SENTINEL, capacity, key_fills=[KEY_SENTINEL])
        in_range = torch.arange(capacity, device=device) < nnz
        out_rows = torch.where(in_range, fused // n_cols, n_rows)
        col_idx = torch.where(in_range, fused % n_cols, INT32_SENTINEL).int()
        row_ptr = torch.searchsorted(
            out_rows, torch.arange(n_rows + 1, device=device), side="left").int()
        # capacity overflow poisons nnz to -1: the host guard check() raises
        # rather than let a truncated matrix pass
        return SparseCSR(row_ptr=row_ptr, col_idx=col_idx, values=tuple(out_vals),
                         nnz=torch.where(nnz <= capacity, nnz, -1),
                         n_rows=n_rows, n_cols=n_cols, sr_name=sr.name)

    @staticmethod
    def from_coo(rows, cols, vals, n_rows: int, n_cols: Optional[int] = None,
                 sr: Semiring = U64, capacity: Optional[int] = None,
                 device=DEFAULT_DEVICE) -> "SparseCSR":
        """COO -> CSR from numpy arrays or lists, built on ``device``."""
        device = resolve_device(device)
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        n_cols = n_rows if n_cols is None else n_cols
        vals_v = sr.from_numpy(np.asarray(vals), device=device)
        cap = capacity or max(int(rows.shape[0]), 1)
        if rows.shape[0] == 0:
            return SparseCSR.empty(n_rows, n_cols, cap, sr, device)
        return SparseCSR.from_coo_device(
            torch.from_numpy(rows).to(device), torch.from_numpy(cols).to(device),
            vals_v, n_rows, n_cols, sr, cap)

    @staticmethod
    def host_csr_arrays(rows, cols, vals, n_rows: int, n_cols: Optional[int] = None,
                        sr: Semiring = U64, capacity: Optional[int] = None):
        """COO -> CSR merge in numpy.  Returns ``(row_ptr int32[n+1], col_idx
        int32[cap], limbs (list of numpy arrays [cap]), nnz)``."""
        n_cols = n_rows if n_cols is None else n_cols
        rows, cols, totals = _merge_coo(rows, cols, vals, n_cols, sr.name)
        nnz = len(rows)
        cap = capacity or max(nnz, 1)
        if cap < nnz:
            raise ValueError(f"capacity {cap} < nnz {nnz}")
        col_idx = np.full(cap, INT32_SENTINEL, np.int32)
        col_idx[:nnz] = cols
        row_ptr = _row_ptr(rows, n_rows).astype(np.int32)
        limbs = [np.concatenate([l, np.zeros(cap - nnz, l.dtype)])
                 for l in sr.to_host_limbs(totals)]
        return row_ptr, col_idx, limbs, nnz

    @staticmethod
    def from_host_arrays(row_ptr, col_idx, limbs, nnz: int, n_rows: int, n_cols: int,
                         sr: Semiring, device=DEFAULT_DEVICE) -> "SparseCSR":
        """CSR arrays (``host_csr_arrays``' output, or a JAX ``SparseCSR``'s
        fields with uint32 limbs) copied to ``device`` in the port's types."""
        device = resolve_device(device)
        return SparseCSR(
            row_ptr=torch.tensor(np.asarray(row_ptr, np.int32), device=device),
            col_idx=torch.tensor(np.asarray(col_idx, np.int32), device=device),
            values=tuple(torch.tensor(np.asarray(l), dtype=sr.dtype, device=device)
                         for l in limbs),
            nnz=torch.tensor(int(nnz), dtype=torch.int64, device=device),
            n_rows=n_rows, n_cols=n_cols, sr_name=sr.name)

    @staticmethod
    def from_coo_host(rows, cols, vals, n_rows: int, n_cols: Optional[int] = None,
                      sr: Semiring = U64, capacity: Optional[int] = None,
                      device=DEFAULT_DEVICE) -> "SparseCSR":
        """COO -> CSR merged in numpy, then one copy to ``device``; the same
        result as ``from_coo``."""
        device = resolve_device(device)
        n_cols = n_rows if n_cols is None else n_cols
        row_ptr, col_idx, limbs, nnz = SparseCSR.host_csr_arrays(
            rows, cols, vals, n_rows, n_cols, sr, capacity)
        return SparseCSR.from_host_arrays(row_ptr, col_idx, limbs, nnz, n_rows, n_cols,
                                          sr, device)

    def memory_bytes(self) -> int:
        """Device storage at the current capacity: row_ptr, col_idx and the
        value limbs (8 bytes a limb for the integer semirings, whose uint32
        limbs ride int64; the JAX package stores them in 4)."""
        limb_bytes = sum(l.element_size() for l in self.values)
        return int(self.row_ptr.numel() * 4 + self.capacity * (4 + limb_bytes))

    def check(self) -> "SparseCSR":
        """Host guard: raise if a capacity overflow poisoned this matrix."""
        if int(self.nnz) < 0:
            raise ValueError(
                "SparseCSR capacity overflow: an operation produced more "
                "entries than its capacity (nnz poisoned to -1); "
                "re-run with a larger capacity / expand_cap")
        return self

    def with_capacity(self, capacity: int) -> "SparseCSR":
        """Pad or (validly) shrink the slot tensors to a new capacity."""
        pad = capacity - self.capacity
        if pad == 0:
            return self
        if pad > 0:
            col = torch.cat([self.col_idx, self.col_idx.new_full((pad,), INT32_SENTINEL)])
            vals = tuple(torch.cat([l, l.new_zeros(pad)]) for l in self.values)
        else:
            col = self.col_idx[:capacity]
            vals = tuple(l[:capacity] for l in self.values)
        return dataclasses.replace(self, col_idx=col, values=vals)
