"""Dense boolean-pattern engine: the counterpart of ``sparsetpu/graphs/patterns.py``.

Reachability, transitive closure, components and the diameter consume only
the nonzero PATTERN of each power, so a graph whose n x n int8 frame fits
the device iterates as dense frames, one product a step:

    next = (x @ x > 0)        # int8 x int8 -> int32, clamped back to int8

exact whatever the graph (a row sum is at most n < 2^31).  The product is
``torch._int_mm``, the int8 tensor-core GEMM, as the JAX package's is one
``jax.lax.dot``: a plain product, not a hand-written kernel.

Where the port differs from the JAX package, and why:

- **Frames are padded to a multiple of 128** (``frame_side``), which meets
  ``_int_mm``'s shape rules (more than 16 rows; inner and column sizes
  multiples of 8), not to JAX's power-of-two ``bucket``, which exists to
  share XLA compiles.  At nell (65,755 nodes) the bucket would be a
  131,072^2 frame, 17.2 GB of int8; 65,792^2 is 4.33 GB.
- **Frames are square on max(n_rows, n_cols)**; JAX pads from n_rows only
  and asserts on a wider matrix.
- **The product runs in row panels** (``matmul``) whose int32 accumulator
  stays within ``PANEL_ACC_BYTES``: a full n x n int32 product would be 17.3
  GB at nell.
- **The fixed-point loops are host loops** with one synchronisation a step
  (an equality or a count), negligible beside a 65k int8 product.  Equality
  and counts run panel by panel, so no frame-sized mask is allocated.
- **``MAX_PATTERN_N`` is sized for the card**: see below.  JAX's value,
  sized for a 16 GB TPU, stays as ``JAX_MAX_PATTERN_N``.
- ``reachability_nnz`` counts the reachability set without building its
  CSR: at nell it holds 65,755^2 = 4.3e9 entries, past the int32 offsets of
  a ``SparseCSR`` (and ~86 GB in the port's entry format).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..csr import SparseCSR
from ..semiring import Semiring

FRAME_QUANTUM = 128            # a frame's side is a multiple of this
PANEL_ACC_BYTES = 1 << 31      # one row panel's int32 accumulator, at most
JAX_MAX_PATTERN_N = 32768      # JAX's cap, sized for a 16 GB TPU
# The card's cap.  The loops hold at most six frames of n^2 int8 bytes at
# once: the diameter's closure_while holds its base (kept for the
# refinement), prev2, prev, cur, cur's column-major copy for ``matmul`` and
# the product nxt (reachability_while holds five: x0, its column-major copy,
# the running total, the power and the next power); beside them one
# panel's int32 accumulator (PANEL_ACC_BYTES).  Six frames within 64 GB of
# an 80 GB H100 leave room for the accumulator, the CUDA context and the
# allocator's slack: n <= sqrt(64e9 / 6) = 103,279, rounded down to the
# frame quantum.  nell (65,755: six frames of 4.33 GB) fits; ogbn-arxiv
# (169,343: one frame is 28.7 GB, six are 172 GB) does not, and takes the
# sparse route.
PATTERN_BUDGET_BYTES = 64e9
FRAMES_HELD = 6
MAX_PATTERN_N = (math.isqrt(int(PATTERN_BUDGET_BYTES // FRAMES_HELD))
                 // FRAME_QUANTUM * FRAME_QUANTUM)
PRODUCT_OPS = 0  # int8 operations (2 n k m a product) issued by matmul


class ConvergenceError(RuntimeError):
    """A fixed-point loop reached its iteration cap (JAX raises
    RuntimeError there; this is one)."""


def fits(n: int, max_n: int = MAX_PATTERN_N) -> bool:
    """True when the dense pattern route may run at this node count."""
    return n <= max_n


def frame_side(n_rows: int, n_cols: Optional[int] = None) -> int:
    """The side of a square frame holding an (n_rows, n_cols) pattern:
    max(n_rows, n_cols) rounded up to a multiple of 128.  Pad rows and
    columns are structurally zero; the closure loops put self-loops on
    them, which offsets every count by a constant and touches no real
    entry."""
    n = max(n_rows, n_rows if n_cols is None else n_cols, 1)
    return -(-n // FRAME_QUANTUM) * FRAME_QUANTUM


def from_csr(a: SparseCSR, pad_to: Optional[int] = None) -> torch.Tensor:
    """CSR -> dense int8 pattern frame (1 where an entry is stored), on the
    CSR's device.  ``pad_to``: a (pad_to, pad_to) frame with the pattern in
    its top-left corner; it must cover max(n_rows, n_cols)."""
    n, m = a.shape
    np_, mp_ = (pad_to, pad_to) if pad_to else (n, m)
    if np_ < n or mp_ < m:
        raise ValueError(f"pad_to {pad_to} does not cover the shape {a.shape}")
    valid = torch.arange(a.capacity, device=a.device) < a.nnz
    r = a.row_of_slot().clamp(0, n - 1)
    c = a.col_idx.long().clamp(0, m - 1)
    size = np_ * mp_
    flat = torch.where(valid, r * mp_ + c, size)
    frame = torch.zeros(size + 1, dtype=torch.int8, device=a.device)
    frame[flat] = 1  # invalid slots land in the dump slot past the frame
    return frame[:size].view(np_, mp_)


def to_csr(x: torch.Tensor, sr: Semiring, capacity: Optional[int] = None) -> SparseCSR:
    """Pattern frame -> SparseCSR with every stored value the semiring's one."""
    mask = x != 0
    ones = tuple(torch.where(mask, o, 0) for o in sr.ones(x.shape, device=x.device))
    return SparseCSR.from_dense_device(ones, sr, capacity=capacity)


def _panel_rows(n_cols: int) -> int:
    """Rows of a product panel: its int32 accumulator within
    PANEL_ACC_BYTES, a multiple of the frame quantum."""
    rows = PANEL_ACC_BYTES // (4 * max(n_cols, 1)) // FRAME_QUANTUM * FRAME_QUANTUM
    return max(rows, FRAME_QUANTUM)


def col_major(y: torch.Tensor) -> torch.Tensor:
    """y laid out column-major (a view of its contiguous transpose); y
    itself when it is so already."""
    if y.dim() == 2 and y.stride() == (1, y.shape[0]):
        return y
    return y.t().contiguous().t()


def matmul(x: torch.Tensor, y: torch.Tensor, panel_rows: Optional[int] = None) -> torch.Tensor:
    """Boolean pattern product: ``torch._int_mm`` (int8 x int8, int32 sums,
    exact: row sums <= n < 2^31) one row panel of x at a time, each panel
    clamped back to {0, 1} int8.  x panels are row-major and y is passed
    column-major (``col_major``: one transient frame unless y is so): on
    the H100 cuBLAS runs that layout ~8x faster than a row-major y
    (``chip_smoke.py`` times both).  On the card every panel needs more
    than 16 rows and the inner and column sizes multiples of 8, which the
    frames meet."""
    global PRODUCT_OPS
    n, k = x.shape
    m = y.shape[1]
    if y.shape[0] != k:
        raise ValueError(f"{tuple(x.shape)} x {tuple(y.shape)} do not chain")
    PRODUCT_OPS += 2 * n * k * m
    rows = panel_rows or _panel_rows(m)
    y_cm = col_major(y)
    out = torch.empty((n, m), dtype=torch.int8, device=x.device)
    for r0 in range(0, n, rows):
        acc = torch._int_mm(x[r0:r0 + rows].contiguous(), y_cm)
        out[r0:r0 + rows] = acc.clamp_(max=1)
        del acc
    return out


def _panels(x: torch.Tensor):
    """Row ranges of x's product-sized panels."""
    n, rows = x.shape[0], _panel_rows(x.shape[1])
    return [(r0, min(r0 + rows, n)) for r0 in range(0, n, rows)]


def frames_equal(x: torch.Tensor, y: torch.Tensor) -> bool:
    """x == y everywhere, compared panel by panel (no frame-sized mask);
    one synchronisation."""
    differ = torch.zeros((), dtype=torch.bool, device=x.device)
    for r0, r1 in _panels(x):
        differ |= (x[r0:r1] != y[r0:r1]).any()
    return not bool(differ)


def add_identity(x: torch.Tensor) -> torch.Tensor:
    """x | I on a square frame."""
    out = x.clone()
    out.diagonal().fill_(1)
    return out


def nnz(x: torch.Tensor) -> torch.Tensor:
    """The number of ones of a frame, an int64 device scalar (JAX's int32
    sum wraps past 2^31, which a nell closure passes).  Summed a row panel
    at a time in int32 (a panel holds under 2^31 ones): a reduction casts
    its input to the accumulator's type first, and a whole nell frame cast
    to int64 would be a 34.6 GB transient."""
    total = torch.zeros((), dtype=torch.int64, device=x.device)
    for r0, r1 in _panels(x):
        total += x[r0:r1].sum(dtype=torch.int32)
    return total


def closure_while(x0: torch.Tensor, max_iters: int = 64):
    """Squaring fixed point: returns (closure, start, k, start_len).

    ``start`` is the power two squarings behind the stable point, at reach
    length ``start_len``: stability shows one squaring AFTER the closure is
    first reached, so the power one behind is already full, and two behind
    is the last provably refinable point (the diameter refinement's
    start)."""
    prev2 = prev = cur = x0
    k, p2len, stable = 0, 1, False
    while not stable and k < max_iters:
        nxt = matmul(cur, cur)
        stable = frames_equal(nxt, cur)
        # reach lengths after step i = k + 1: cur 2^i, prev 2^(i-1), prev2
        # 2^(i-2) clamped at 1 (prev2 only starts moving at the 3rd step)
        p2len = p2len * 2 if k >= 2 else 1
        prev2, prev, cur = prev, cur, nxt
        k += 1
    return cur, prev2, k, p2len


def _or_into(total: torch.Tensor, power: torch.Tensor) -> bool:
    """total |= power in place, panel by panel; True when power added a one
    (new_total != total in JAX's loop)."""
    grew = torch.zeros((), dtype=torch.bool, device=total.device)
    for r0, r1 in _panels(total):
        t, p = total[r0:r1], power[r0:r1]
        grew |= (p > t).any()
        t |= p
    return bool(grew)


def reachability_while(x0: torch.Tensor, max_iters: int = 64):
    """S = A | A^2 | ... until S stabilises; returns (S, k), k the number of
    powers folded in (A once plus each added power)."""
    power, total, k, stable = x0, x0.clone(), 1, False
    x0_cm = col_major(x0)
    while not stable and k < max_iters:
        power = matmul(power, x0_cm)
        stable = not _or_into(total, power)
        k += 1
    return total, k


def refine_while(reach: torch.Tensor, base: torch.Tensor, target_nnz: int, d0: int,
                 max_steps: int = 4096) -> int:
    """Linear refinement: multiply by base until the pattern count reaches
    ``target_nnz``; returns the step count d (the diameter)."""
    cur, d, steps = reach, d0, 0
    base_cm = col_major(base)
    while int(nnz(cur)) != target_nnz and steps < max_steps:
        cur = matmul(cur, base_cm)
        d += 1
        steps += 1
    return d


def _diameter_while(base: torch.Tensor, max_iters: int = 64, max_steps: int = 4096) -> int:
    """Squaring fixed point, then the linear refinement from the last
    provably non-full power; on a complete graph start is base and d stays
    1."""
    closure, start, _, start_len = closure_while(base, max_iters=max_iters)
    target = int(nnz(closure))
    del closure
    return refine_while(start, base, target, start_len, max_steps=max_steps)


def diameter(a: SparseCSR, max_iters: int = 64) -> int:
    """Diameter by dense-pattern squaring and linear refinement: the dense
    route of ``algos.diameter`` (the same answer)."""
    base = add_identity(from_csr(a, pad_to=frame_side(*a.shape)))
    return _diameter_while(base, max_iters=max_iters)


def _capacity(x: torch.Tensor) -> int:
    return 1 << (max(int(nnz(x)), 1) - 1).bit_length()


def power_until_stable(a: SparseCSR, max_iters: int = 64) -> Tuple[SparseCSR, int]:
    """Dense-pattern analog of ``algos.power_until_stable(pattern=True)``:
    the same (fixed-point matrix, squaring count), every value one."""
    n, m = a.shape
    closure, _, k, _ = closure_while(from_csr(a, pad_to=frame_side(n, m)),
                                     max_iters=max_iters)
    if k >= max_iters:
        raise ConvergenceError("power_until_stable did not converge")
    closure = closure[:n, :m]
    return to_csr(closure, a.sr, capacity=_capacity(closure)), k


def _reach_frame(a: SparseCSR, max_iters: int):
    n, m = a.shape
    total, k = reachability_while(from_csr(a, pad_to=frame_side(n, m)),
                                  max_iters=max_iters)
    if k >= max_iters:
        raise ConvergenceError("reachability did not converge")
    return total[:n, :m], k


def reachability_sum(a: SparseCSR, max_iters: int = 64) -> Tuple[SparseCSR, int]:
    """Dense-pattern analog of ``algos.reachability_sum(pattern=True)``."""
    total, k = _reach_frame(a, max_iters)
    return to_csr(total, a.sr, capacity=_capacity(total)), k


def reachability_nnz(a: SparseCSR, max_iters: int = 64) -> Tuple[int, int]:
    """(nnz of ``reachability_sum``'s result, k) without building its CSR."""
    total, k = _reach_frame(a, max_iters)
    return int(nnz(total)), k


def _mutual_reps(closure: torch.Tensor) -> torch.Tensor:
    """Each node's component representative: the first j reachable both
    ways (closure & closure^T is symmetric and reflexive, so a row's argmax
    is its smallest mutually reachable node), one row panel at a time."""
    reps = torch.empty(closure.shape[0], dtype=torch.int64, device=closure.device)
    for r0, r1 in _panels(closure):
        mutual = closure[r0:r1] & closure[:, r0:r1].t()
        reps[r0:r1] = torch.argmax(mutual, dim=1)
    return reps


def connected_components_closure(a: SparseCSR) -> np.ndarray:
    """Components by dense transitive closure: (A | I) squared to its fixed
    point, mutual reachability = the same component, labels sequential by
    first appearance.  Pad rows carry only their self-loop and are cut."""
    base = add_identity(from_csr(a, pad_to=frame_side(*a.shape)))
    closure, _, _, _ = closure_while(base)
    rep = _mutual_reps(closure)[:a.n_rows].cpu().numpy()
    _, inv = np.unique(rep, return_inverse=True)
    return inv.astype(np.int64)
