"""Semirings for the port: the counterpart of ``sparsetpu/semiring.py``.

A value is a tuple of limb tensors of one shape, as in the JAX package:

  - ``U32Sat``: one limb, saturating add/mul (Rust ``Saturating<u32>``);
  - ``U64Sat``: two limbs (lo, hi), saturating add, and mul saturating
    whenever the true 128-bit product reaches 2^64 (``Saturating<u64>``);
  - ``F32``: one float32 limb, ordinary IEEE add/mul.

The integer limbs are uint32 values carried in **int64** tensors.  PyTorch's
``uint32``/``uint64`` types have thin operator coverage (no sort, no cumsum on
CUDA), whereas int64 has every operator on every device, and a 32-bit limb
in int64 leaves room for a carry: a sum of two limbs never wraps.  Products
of two limbs (up to 2^64) would wrap, so they are taken in 16-bit halves
(``_umull32``), exactly as the JAX package takes them in uint32.  Every
result is bit-exact against the JAX semirings.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

Value = Tuple[torch.Tensor, ...]

MASK32 = 0xFFFFFFFF
_MASK16 = 0xFFFF


def _umull32(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full 32 x 32 -> 64-bit product of limbs (int64 holding [0, 2^32)), as
    (lo, hi) limbs.  Every partial stays below 2^34, so nothing wraps."""
    a0, a1 = a & _MASK16, a >> 16
    b0, b1 = b & _MASK16, b >> 16
    ll = a0 * b0
    t = a1 * b0 + (ll >> 16)
    t2 = a0 * b1 + (t & _MASK16)
    hi = a1 * b1 + (t >> 16) + (t2 >> 16)
    lo = ((t2 & _MASK16) << 16) | (ll & _MASK16)
    return lo, hi


class Semiring:
    """A commutative semiring with saturating add/mul on limbed values."""

    name: str = "abstract"
    nlimbs: int = 0
    dtype = torch.int64

    # -- construction -------------------------------------------------------
    def zeros(self, shape, device=None) -> Value:
        return tuple(torch.zeros(shape, dtype=self.dtype, device=device)
                     for _ in range(self.nlimbs))

    def ones(self, shape, device=None) -> Value:
        raise NotImplementedError

    def full(self, shape, scalar, device=None) -> Value:
        limbs = self.to_host_limbs(np.asarray([scalar]))
        return tuple(torch.full(shape, l[0].item(), dtype=self.dtype, device=device)
                     for l in limbs)

    # -- conversion ---------------------------------------------------------
    def to_host_limbs(self, x) -> list:
        """numpy value array -> list of numpy limb arrays (int64 limbs for the
        integer semirings, float32 for f32)."""
        raise NotImplementedError

    def from_numpy(self, x, device=None) -> Value:
        return tuple(torch.from_numpy(l).to(device) for l in self.to_host_limbs(x))

    def to_numpy(self, v: Value) -> np.ndarray:
        raise NotImplementedError

    # -- arithmetic ---------------------------------------------------------
    def add(self, x: Value, y: Value) -> Value:
        raise NotImplementedError

    def mul(self, x: Value, y: Value) -> Value:
        raise NotImplementedError

    # -- structure ----------------------------------------------------------
    def is_zero(self, v: Value) -> torch.Tensor:
        out = v[0] == 0
        for l in v[1:]:
            out = out & (l == 0)
        return out

    def equal(self, x: Value, y: Value) -> torch.Tensor:
        out = x[0] == y[0]
        for a, b in zip(x[1:], y[1:]):
            out = out & (a == b)
        return out

    def where(self, mask, x: Value, y: Value) -> Value:
        return tuple(torch.where(mask, a, b) for a, b in zip(x, y))

    def gather(self, v: Value, idx) -> Value:
        return tuple(l[idx] for l in v)

    def __repr__(self):
        return f"Semiring({self.name})"


def _u64_numpy(x) -> np.ndarray:
    return np.asarray(x, dtype=np.uint64)


class U32Sat(Semiring):
    """Saturating u32: one limb."""

    name = "u32"
    nlimbs = 1
    dtype = torch.int64

    def ones(self, shape, device=None) -> Value:
        return (torch.ones(shape, dtype=torch.int64, device=device),)

    def to_host_limbs(self, x) -> list:
        x = _u64_numpy(x)
        if np.any(x > MASK32):
            raise ValueError("value out of u32 range")
        return [x.astype(np.int64)]

    def to_numpy(self, v: Value) -> np.ndarray:
        return v[0].cpu().numpy().astype(np.uint64)

    def add(self, x: Value, y: Value) -> Value:
        return (torch.clamp(x[0] + y[0], max=MASK32),)

    def mul(self, x: Value, y: Value) -> Value:
        lo, hi = _umull32(x[0], y[0])
        return (torch.where(hi > 0, MASK32, lo),)


class U64Sat(Semiring):
    """Saturating u64 as two limbs (lo, hi)."""

    name = "u64"
    nlimbs = 2
    dtype = torch.int64

    def ones(self, shape, device=None) -> Value:
        return (torch.ones(shape, dtype=torch.int64, device=device),
                torch.zeros(shape, dtype=torch.int64, device=device))

    def to_host_limbs(self, x) -> list:
        x = _u64_numpy(x)
        lo = (x & np.uint64(MASK32)).astype(np.int64)
        hi = (x >> np.uint64(32)).astype(np.int64)
        return [lo, hi]

    def to_numpy(self, v: Value) -> np.ndarray:
        lo = v[0].cpu().numpy().astype(np.uint64)
        hi = v[1].cpu().numpy().astype(np.uint64)
        return lo | (hi << np.uint64(32))

    def add(self, x: Value, y: Value) -> Value:
        lo = x[0] + y[0]
        hi = x[1] + y[1] + (lo >> 32)
        ovf = hi > MASK32
        return (torch.where(ovf, MASK32, lo & MASK32), torch.where(ovf, MASK32, hi))

    def mul(self, x: Value, y: Value) -> Value:
        alo, ahi = x
        blo, bhi = y
        l00, h00 = _umull32(alo, blo)
        l01, h01 = _umull32(alo, bhi)
        l10, h10 = _umull32(ahi, blo)
        s = h00 + l01 + l10  # < 3 * 2^32: the hi limb plus its carry-out
        ovf = (h01 != 0) | (h10 != 0) | ((ahi != 0) & (bhi != 0)) | (s > MASK32)
        return (torch.where(ovf, MASK32, l00), torch.where(ovf, MASK32, s))


class F32(Semiring):
    """Plain float32."""

    name = "f32"
    nlimbs = 1
    dtype = torch.float32

    def ones(self, shape, device=None) -> Value:
        return (torch.ones(shape, dtype=torch.float32, device=device),)

    def to_host_limbs(self, x) -> list:
        return [np.asarray(x, dtype=np.float32)]

    def to_numpy(self, v: Value) -> np.ndarray:
        return v[0].cpu().numpy().astype(np.float32)

    def add(self, x: Value, y: Value) -> Value:
        return (x[0] + y[0],)

    def mul(self, x: Value, y: Value) -> Value:
        return (x[0] * y[0],)


U32 = U32Sat()
U64 = U64Sat()
F32SR = F32()

_BY_NAME = {"u32": U32, "u64": U64, "f32": F32SR}


def by_name(name: str) -> Semiring:
    if name not in _BY_NAME:
        raise ValueError(f"unknown semiring {name!r}; have {sorted(_BY_NAME)}")
    return _BY_NAME[name]
