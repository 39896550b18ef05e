"""The A^2..A^7 chain benchmark on the port: counterpart of ``sparsetpu/bench/chain.py``.

The headline workload: the 30^3 Moore torus thinned to ~3 edges per node
(n = 27,000, nnz(A) = 80,882) on the u64 semiring, and the chain
C_k = A x C_{k-1} (or C_(k-1) x A) for k = 2..7, in ``bench.py``'s nine
``--algo`` forms:

- ``auto``: the router's route (``ops/hybrid.choose_strategy``):
  "dense-acc" runs ``pallas``, "band" runs ``band``, "esc" runs ``rowcat``,
  as ``bench.py`` maps them;
- ``pallas``: full-width steps through the dense-accumulator SpMM
  (kernels/spmm.py), or through the group-dot SpMM (kernels/groupdot.py)
  with ``--kernel group-dot``;
- ``dense``: the same product through the plain-torch gather/segment-sum
  SpMM (ops/spmm.py), in row chunks;
- ``band``: the block-band product (kernels/bandmm.py) on the cyclic band,
  folded once it is wider than the matrix;
- ``esc``, ``escb``, ``rowcat``: C_k = C_(k-1) x A in CSR through the ESC
  (ops/spgemm.py), blocked ESC (ops/escb.py) and row-categorized
  (ops/rowcat.py, with the sort-merge kernel) SpGEMMs;
- ``mixed``: the sparse early steps through the slab ESC SpGEMM
  (ops/slab.py, with the coalesce kernel), then A^(switch-1) densified and
  the late steps through the dense-accumulator SpMM;
- ``foldband``: the torus folded into a pure band and every step through
  the band SpMM (kernels/bandplanes.py), on windows of the band's width.

Every step's nnz and max are checked against the C++ oracle; the CSR
chains' (esc, escb, rowcat, the mixed chain's slab steps) whole CSR at every
step, and the final product's values on its leading rows for the dense
forms (pallas, dense, band, foldband after unfolding, mixed).  The JAX
driver checks neither for dense or band; the port checks every form.

Run: ``python -m sparsetpu_torch.bench.chain [--quick] [--steps 7] [--iters 3]
[--algo auto|pallas|dense|band|esc|rowcat|escb|mixed|foldband]
[--switch-step 5] [--kernel dense-acc|group-dot] [--csv PATH] [--no-verify]
[--device cuda]``.  It prints one line per step and then one JSON line with
the A^7 output rate, as ``bench.py`` does.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import os
import sys
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import native
from ..csr import F32_EXACT_LIMIT, HostCSR, SparseCSR
from ..graphs import generate
from ..kernels import bandmm, bandplanes, groupdot, spmm
from ..ops import escb, rowcat, slab
from ..ops import spmm as ops_spmm
from ..ops.hybrid import choose_strategy
from ..ops.spgemm import max_value, pow2, spgemm, symbolic_flops_exact
from ..semiring import by_name
from .spgemm_bench import check_against_oracle

BASELINE_NNZ_PER_S = 289e6  # reference CPU CSR-par at A^7 (BASELINE.md)
KERNELS = ("dense-acc", "group-dot")  # bench.py --pallas-kernel vpu, mxu
ALGOS = ("auto", "pallas", "dense", "band", "esc", "rowcat", "escb", "mixed", "foldband")
ROUTE_ALGO = {"dense-acc": "pallas", "band": "band", "esc": "rowcat"}  # bench.py's map
BAND_BLOCKS = {1728: 108, 27000: 125}  # bench.py's block of the band chain, by n


@dataclass
class ChainStep:
    step: int
    nnz: int
    flops: int
    seconds: float
    nnz_per_s: float
    gflops: float
    max_value: float = 0.0
    gb_per_s: float = 0.0  # the step's byte model over its time


def step_bytes(a_nnz: int, n_rows: int, m: int) -> int:
    """Bytes a full-width step must move: one P row (m f32) read per entry of
    A, and the (n_rows, m) f32 C written once."""
    return (a_nnz + n_rows) * m * 4


def build_torus_host(dims: Sequence[int] = (30, 30, 30),
                     density: float = 3.0 / 26.0, seed: int = 42,
                     sr_name: str = "u64") -> HostCSR:
    coo = generate.lattice(list(dims), torus=True)
    if density < 1.0:
        coo = generate.thin(coo, density, seed=seed)
    rows, cols, vals, n = coo
    return HostCSR.from_coo(rows, cols, vals, n, n, sr_name)


def native_chain_stats_host(row_ptr, col_idx, vals, n: int, max_step: int = 7,
                            keep: Optional[list] = None):
    """A^2..A^max on the C++ oracle (exact saturating u64).  Returns per-step
    (step, nnz, max_value, expansion_flops) and the final (row_ptr, col, val);
    ``keep`` (a list), if given, receives every step's product in order."""
    base = native.as_host_csr(row_ptr, col_idx, vals)
    rnz_a = np.diff(base[0])
    stats = []
    prev = base
    for step in range(2, max_step + 1):
        # flops of the product giving A^step: every entry (i, k) of the
        # current power expands to row_nnz_A[k] partial products
        flops = int(rnz_a[prev[1].astype(np.int64)].sum())
        prev = native.spgemm(prev, base, n)
        if keep is not None:
            keep.append(prev)
        crp, cc, cv = prev
        stats.append((step, int(crp[-1]), int(cv.max()) if len(cv) else 0, flops))
    return stats, prev


def _check_chain_args(max_step: int, iters: int, native_stats: Optional[list]) -> None:
    if max_step < 2 or iters < 1:
        raise ValueError(f"need max_step >= 2 and iters >= 1, got {max_step}, {iters}")
    if native_stats is not None:
        if [s[0] for s in native_stats] != list(range(2, max_step + 1)):
            raise ValueError("native_stats must hold steps 2..max_step")
        if max(s[2] for s in native_stats) >= F32_EXACT_LIMIT - 8:
            raise OverflowError("the chain would exceed the f32 exact range")


@dataclass
class _Step:
    """One product of a chain: ``launch(p, out)`` returns C = A x P, written
    into ``out`` where the launch takes a buffer (None where it allocates)."""

    launch: Callable[[torch.Tensor, Optional[torch.Tensor]], torch.Tensor]
    out: Optional[torch.Tensor]
    bytes: int  # the step's byte model
    label: str


def _time_chain(steps: List[_Step], p0: torch.Tensor, a_op: spmm.SparseOperand,
                iters: int, native_stats: Optional[list], verbose: bool,
                first_step: int = 2) -> Tuple[List[ChainStep], torch.Tensor]:
    """Run ``steps`` from P0 ``iters`` times and keep each step's minimum
    time: CUDA events around the one launch on a GPU, ``time.perf_counter``
    on the CPU.  During the first repetition, outside the timed windows,
    every step's nnz and max are read back and checked against
    ``native_stats`` (the records of steps ``first_step``, ``first_step`` +
    1, ...) when given; the first disagreement raises.  Returns the per-step
    records and the final product (the last step's result)."""
    device = p0.device
    on_gpu = device.type == "cuda"
    k = len(steps)
    # exact flops of C = A x P: entry (i, k) of A meets row k of P
    col_count_a = torch.bincount(a_op.col_idx.long(), minlength=a_op.n_cols)
    best = [math.inf] * k
    checked = []  # (nnz, max, flops) per step, from the first repetition
    events = []  # (step index, start, stop) CUDA events
    row_nnz = torch.count_nonzero(p0, dim=1)
    for it in range(iters):
        p = p0
        for idx, st in enumerate(steps):
            if on_gpu:
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                out = st.launch(p, st.out)
                stop.record()
                events.append((idx, start, stop))
            else:
                t0 = time.perf_counter()
                out = st.launch(p, st.out)
                best[idx] = min(best[idx], time.perf_counter() - t0)
            if it == 0:
                flops = int((col_count_a * row_nnz).sum())
                row_nnz = torch.count_nonzero(out, dim=1)
                nnz = int(row_nnz.sum())
                vmax = float(out.max())
                step = idx + first_step
                if vmax >= F32_EXACT_LIMIT - 8:
                    raise OverflowError(f"A^{step} reached the f32 exact range ({vmax})")
                if native_stats is not None:
                    _, want_nnz, want_max, _ = native_stats[idx]
                    if (nnz, vmax) != (want_nnz, float(want_max)):
                        raise RuntimeError(
                            f"A^{step}: (nnz, max) = ({nnz}, {vmax:.0f}) but the "
                            f"oracle has ({want_nnz}, {want_max})")
                checked.append((nnz, vmax, flops))
            p = out
    if on_gpu:
        # one synchronise after every repetition is queued: a sync between
        # repetitions would leave the device idle while the host launches
        # the next A^2, and that gap would land in A^2's window
        torch.cuda.synchronize(device)
        for idx, start, stop in events:
            best[idx] = min(best[idx], start.elapsed_time(stop) / 1e3)

    results = []
    for idx, ((nnz, vmax, flops), dt, st) in enumerate(zip(checked, best, steps)):
        rec = ChainStep(step=idx + first_step, nnz=nnz, flops=flops, seconds=dt,
                        nnz_per_s=nnz / dt, gflops=2.0 * flops / dt / 1e9,
                        max_value=vmax, gb_per_s=st.bytes / dt / 1e9)
        results.append(rec)
        if verbose:
            print(f"A^{rec.step} [{st.label}]: nnz={nnz} flops={flops} "
                  f"time={dt * 1e3:.4f}ms nnz/s={rec.nnz_per_s / 1e6:.1f}M "
                  f"gflops={rec.gflops:.2f} GB/s={rec.gb_per_s:.1f} "
                  f"max={vmax:.0f}", flush=True)
    return results, p


def run_chain_dense_acc(
    a: HostCSR,
    device,
    max_step: int = 7,
    iters: int = 3,
    native_stats: Optional[list] = None,
    verbose: bool = True,
    kernel: str = "dense-acc",
) -> Tuple[List[ChainStep], torch.Tensor]:
    """C_k = A x C_{k-1} for k = 2..max_step at full width.

    ``kernel`` picks the SpMM: "dense-acc" (``spmm_dense_acc``, the default)
    or "group-dot" (``groupdot.spmm_group_dot`` at R = 40, G = 32: the
    counterpart of ``run_chain_pallas(kernel="mxu")``).  P0 = A is densified
    once on ``device`` and the steps ping-pong two preallocated (n, n) f32
    buffers; timing and checks as ``_time_chain`` says (each of ``iters``
    repetitions reruns the chain from P0; ``native_stats`` is the oracle's
    per-step (step, nnz, max, flops)).  Returns the per-step records and the
    final product A^max (one of the two buffers)."""
    device = torch.device(device)
    _check_chain_args(max_step, iters, native_stats)
    op = spmm.prepare_sparse_operand(a, device)
    if kernel == "dense-acc":
        launch = functools.partial(spmm.spmm_dense_acc, op)
    elif kernel == "group-dot":
        launch = functools.partial(groupdot.spmm_group_dot,
                                   groupdot.prepare_group_operand(a, device))
    else:
        raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")
    p0 = spmm.densify(op)
    bufs = (torch.empty_like(p0), torch.empty_like(p0))
    steps = [_Step(launch, bufs[idx % 2], step_bytes(a.nnz, a.n_rows, a.n_cols),
                   f"{kernel} {device.type}") for idx in range(max_step - 1)]
    return _time_chain(steps, p0, op, iters, native_stats, verbose)


def sparse_operand(a: HostCSR, device) -> SparseCSR:
    """The host CSR as the device ``SparseCSR`` of the slab SpGEMM."""
    sr = by_name(a.sr_name)
    return SparseCSR.from_host_arrays(a.row_ptr.astype(np.int32), a.col_idx,
                                      sr.to_host_limbs(a.vals), a.nnz, a.n_rows, a.n_cols,
                                      sr, device)


def tuple_to_f32_dense(c: SparseCSR) -> torch.Tensor:
    """Dense (n_rows, n_cols) f32 of a CSR whose values are small integers,
    scattered on its device (the caller guards values below 2^24)."""
    size = c.n_rows * c.n_cols
    slots = torch.arange(c.capacity, device=c.device)
    flat = torch.where(slots < c.nnz, c.row_of_slot() * c.n_cols + c.col_idx.long(),
                       size + slots)  # a dump slot of its own per padded slot
    vals = c.values[0].float()
    if len(c.values) > 1:
        vals = vals + c.values[1].float() * float(1 << 32)
    out = torch.zeros(size + c.capacity, dtype=torch.float32, device=c.device)
    out[flat] = vals
    return out[:size].view(c.n_rows, c.n_cols)


def _timed_calls(fn: Callable[[], object], iters: int, device: torch.device):
    """Call ``fn`` ``iters`` times; returns (its last result, the least
    seconds of one call): CUDA events around each call on a GPU, with one
    synchronise after all of them, ``time.perf_counter`` on the CPU."""
    out, best, events = None, math.inf, []
    for _ in range(iters):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            stop.record()
            events.append((start, stop))
        else:
            t0 = time.perf_counter()
            out = fn()
            best = min(best, time.perf_counter() - t0)
    if events:
        torch.cuda.synchronize(device)
        best = min(start.elapsed_time(stop) for start, stop in events) / 1e3
    return out, best


def run_chain_mixed(
    a: HostCSR,
    device,
    max_step: int = 7,
    switch_step: int = 5,
    iters: int = 3,
    native_stats: Optional[list] = None,
    verbose: bool = True,
    keep: Optional[dict] = None,
) -> Tuple[List[ChainStep], torch.Tensor, float]:
    """The mixed chain (the counterpart of ``run_chain_mixed`` in the JAX
    package): slab ESC for the sparse early steps, the dense-accumulator
    SpMM for the dense late steps.

    Steps 2..switch_step-1 run ``slab.slab_numeric`` on a plan fixed before
    the timed calls (the whole ``spgemm_slab`` call, plan included, is timed
    and printed too); A^(switch_step-1) is then densified into the (n, n)
    f32 P (timed, guarded below 2^24), and steps switch_step..max_step run
    ``spmm_dense_acc`` through ``_time_chain``.  Each step's time is its
    least over ``iters`` calls.  With ``native_stats`` every step's nnz and
    max are checked against the oracle, and each slab step's whole CSR
    against the oracle's product, outside the timed windows.  With
    switch_step = max_step + 1 there are no dense steps and the densify is
    not timed.  ``keep`` (a dict), if given, receives each slab step's CSR
    by step.  Returns (per-step records, final dense product, densify
    seconds); the chain total, as the JAX package reports it, is the steps'
    sum plus the densify."""
    device = torch.device(device)
    _check_chain_args(max_step, iters, native_stats)
    if not 2 < switch_step <= max_step + 1:
        raise ValueError(f"switch_step must lie in (2, {max_step + 1}], got {switch_step}")
    n = a.n_rows
    a_sp = sparse_operand(a, device)
    base = native.as_host_csr(a.row_ptr, a.col_idx, a.vals)
    prev = base
    results: List[ChainStep] = []
    cur = a_sp
    for step in range(2, switch_step):
        t0 = time.perf_counter()
        slab.spgemm_slab(cur, a_sp).check()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t_call = time.perf_counter() - t0
        plan = slab.slab_config(cur, a_sp)
        c, dt = _timed_calls(lambda: slab.slab_numeric(cur, a_sp, plan), iters, device)
        nnz = int(c.check().nnz)
        vmax = max_value(c)
        flops = symbolic_flops_exact(cur, a_sp)
        if native_stats is not None:
            _, want_nnz, want_max, _ = native_stats[step - 2]
            if (nnz, vmax) != (want_nnz, want_max):
                raise RuntimeError(f"A^{step}: (nnz, max) = ({nnz}, {vmax}) but the oracle "
                                   f"has ({want_nnz}, {want_max})")
            prev = native.spgemm(prev, base, n)
            check_against_oracle(c, prev, f"A^{step}")
        rec = ChainStep(step=step, nnz=nnz, flops=flops, seconds=dt, nnz_per_s=nnz / dt,
                        gflops=2.0 * flops / dt / 1e9, max_value=float(vmax))
        results.append(rec)
        if keep is not None:
            keep[step] = c
        if verbose:
            print(f"A^{step} [slab call, plan included]: time={t_call * 1e3:.4f}ms",
                  flush=True)
            print(f"A^{step} [slab {device.type}]: nnz={nnz} flops={flops} "
                  f"time={dt * 1e3:.4f}ms nnz/s={rec.nnz_per_s / 1e6:.1f}M "
                  f"gflops={rec.gflops:.2f} max={vmax}", flush=True)
        cur = c

    if max_value(cur) >= F32_EXACT_LIMIT - 8:
        raise OverflowError(f"A^{switch_step - 1} exceeds the f32 exact range")
    if switch_step > max_step:
        return results, tuple_to_f32_dense(cur), 0.0
    p0, t_dens = _timed_calls(lambda: tuple_to_f32_dense(cur), iters, device)
    if verbose:
        print(f"densify A^{switch_step - 1} [transition]: time={t_dens * 1e3:.4f}ms",
              flush=True)
    op = spmm.prepare_sparse_operand(a, device)
    bufs = (torch.empty_like(p0), torch.empty_like(p0))
    steps = [_Step(functools.partial(spmm.spmm_dense_acc, op), bufs[idx % 2],
                   step_bytes(a.nnz, n, a.n_cols), f"dense-acc {device.type}")
             for idx in range(max_step - switch_step + 1)]
    late, p = _time_chain(steps, p0, op, iters,
                          None if native_stats is None else native_stats[switch_step - 2:],
                          verbose, first_step=switch_step)
    return results + late, p, t_dens


def _run_csr_chain(a: HostCSR, device, product: Callable[[SparseCSR, SparseCSR], SparseCSR],
                   label: str, max_step: int, iters: int, native_stats: Optional[list],
                   verbose: bool, oracle: Optional[list] = None
                   ) -> Tuple[List[ChainStep], SparseCSR]:
    """C_k = C_(k-1) x A for k = 2..max_step, the product staying a CSR:
    ``product(cur, a)`` is one whole SpGEMM call, host plan included.  Each
    step's time is the least of ``iters`` calls by the host clock around a
    call that ends in a synchronise, as the JAX package times its CSR
    chains.  With ``native_stats`` every step's nnz and max are checked
    against the oracle's and its whole CSR against the oracle's product
    (``oracle``: the products A^2.. as ``native_chain_stats_host(keep=)``
    gives them, computed here when None), outside the timed calls; the
    first disagreement raises."""
    device = torch.device(device)
    _check_chain_args(max_step, iters, native_stats)
    a_sp = sparse_operand(a, device)
    base = native.as_host_csr(a.row_ptr, a.col_idx, a.vals)
    prev = base
    results: List[ChainStep] = []
    cur = a_sp
    for step in range(2, max_step + 1):
        flops = symbolic_flops_exact(cur, a_sp)
        c = product(cur, a_sp).check()
        best = math.inf
        for _ in range(iters):
            t0 = time.perf_counter()
            product(cur, a_sp)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            best = min(best, time.perf_counter() - t0)
        nnz = int(c.nnz)
        vmax = max_value(c)
        if native_stats is not None:
            _, want_nnz, want_max, _ = native_stats[step - 2]
            if (nnz, vmax) != (want_nnz, want_max):
                raise RuntimeError(f"A^{step}: (nnz, max) = ({nnz}, {vmax}) but the oracle "
                                   f"has ({want_nnz}, {want_max})")
            prev = oracle[step - 2] if oracle else native.spgemm(prev, base, a.n_rows)
            check_against_oracle(c, prev, f"A^{step}")
        rec = ChainStep(step=step, nnz=nnz, flops=flops, seconds=best, nnz_per_s=nnz / best,
                        gflops=2.0 * flops / best / 1e9, max_value=float(vmax))
        results.append(rec)
        if verbose:
            print(f"A^{step} [{label} {device.type}]: nnz={nnz} flops={flops} "
                  f"time={best * 1e3:.4f}ms nnz/s={rec.nnz_per_s / 1e6:.1f}M "
                  f"gflops={rec.gflops:.2f} max={vmax}", flush=True)
        cur = c
    return results, cur


def run_chain_rowcat(a: HostCSR, device, max_step: int = 7, iters: int = 3,
                     native_stats: Optional[list] = None, verbose: bool = True,
                     oracle: Optional[list] = None) -> Tuple[List[ChainStep], SparseCSR]:
    """The row-categorized chain (``run_chain_rowcat`` in the JAX package,
    the route ``bench.py`` takes for the router's "esc"): every step through
    ``rowcat.spgemm_rowcat``, whose slab categories ride the sort-merge
    kernel on CUDA; timing and checks as ``_run_csr_chain``.  Returns the
    per-step records and the final product A^max."""
    return _run_csr_chain(a, device, rowcat.spgemm_rowcat, "rowcat", max_step, iters,
                          native_stats, verbose, oracle)


def _esc_product(cur: SparseCSR, a: SparseCSR) -> SparseCSR:
    """One ESC call with its host half: the exact flop count and the
    power-of-two expansion capacity (``run_chain`` in the JAX package)."""
    return spgemm(cur, a, pow2(symbolic_flops_exact(cur, a)))


def run_chain(a: HostCSR, device, max_step: int = 7, iters: int = 3,
              native_stats: Optional[list] = None, verbose: bool = True,
              oracle: Optional[list] = None) -> Tuple[List[ChainStep], SparseCSR]:
    """The ESC chain (``run_chain`` in the JAX package, ``bench.py --algo
    esc``): every step through ``ops.spgemm.spgemm`` at the power-of-two
    capacity of its exact flop count; timing and checks as
    ``_run_csr_chain``."""
    return _run_csr_chain(a, device, _esc_product, "esc", max_step, iters, native_stats,
                          verbose, oracle)


def run_chain_escb(a: HostCSR, device, max_step: int = 7, iters: int = 3,
                   native_stats: Optional[list] = None, verbose: bool = True,
                   oracle: Optional[list] = None) -> Tuple[List[ChainStep], SparseCSR]:
    """The blocked-ESC chain (``run_chain_escb`` in the JAX package): every
    step through ``escb.spgemm_blocked``, its row packing included; timing
    and checks as ``_run_csr_chain``."""
    return _run_csr_chain(a, device, escb.spgemm_blocked, "escb", max_step, iters,
                          native_stats, verbose, oracle)


def run_chain_dense(a: HostCSR, device, max_step: int = 7, iters: int = 3,
                    n_chunks: int = 8, native_stats: Optional[list] = None,
                    verbose: bool = True) -> Tuple[List[ChainStep], torch.Tensor]:
    """The plain-torch dense chain (``run_chain_dense`` in the JAX package,
    ``bench.py --algo dense``): C_k = A x C_(k-1) with C dense f32, every
    step the gather/segment-sum SpMM of ``ops/spmm.py`` over ``n_chunks``
    row chunks of A.  Timing (CUDA events) and checks as ``_time_chain``.
    Returns the per-step records and the final dense product."""
    device = torch.device(device)
    _check_chain_args(max_step, iters, native_stats)
    a_sp = sparse_operand(a, device)
    cols, vals, lrow, rpc = ops_spmm.prepare_spmm_operand(a_sp, n_chunks=n_chunks)
    p0 = tuple_to_f32_dense(a_sp)

    def launch(p, _):
        return ops_spmm.spmm_dense(cols, vals, lrow, p, rows_per_chunk=rpc)

    steps = [_Step(launch, None, step_bytes(a.nnz, a.n_rows, a.n_cols), f"dense {device.type}")
             for _ in range(max_step - 1)]
    return _time_chain(steps, p0, spmm.prepare_sparse_operand(a, device), iters,
                       native_stats, verbose)


def run_chain_band(a: HostCSR, device, half_width: int, block: int = 125, max_step: int = 7,
                   iters: int = 3, native_stats: Optional[list] = None,
                   verbose: bool = True) -> Tuple[List[ChainStep], bandmm.BandMatrix]:
    """The block-band chain (``run_chain_band`` in the JAX package,
    ``bench.py --algo band``): C_k = C_(k-1) x A with both operands cyclic
    block bands of block size ``block`` (the torus has no outliers), each
    step ``bandmm.band_matmul``, folded once the product band is wider than
    the matrix.  Values are guarded below 2^24.  Each step's time is the
    least of ``iters`` calls (CUDA events on a GPU).  With ``native_stats``
    every step's nnz and max are checked against the oracle (the JAX driver
    checks neither).  Returns the per-step records and the final band."""
    device = torch.device(device)
    _check_chain_args(max_step, iters, native_stats)
    band_a, outliers = bandmm.csr_band_split(sparse_operand(a, device), half_width,
                                             block=block, cyclic=True)
    if int(outliers.nnz):
        raise ValueError(f"the band chain needs a cyclic band: {int(outliers.nnz)} "
                         f"entries lie outside half-width {half_width}")
    results: List[ChainStep] = []
    prev = band_a
    for step in range(2, max_step + 1):
        # JAX's driver passes limb counts here; they change only its cost
        c, dt = _timed_calls(lambda: bandmm.band_matmul(prev, band_a), iters, device)
        vmax = float(c.max_value())
        if vmax >= F32_EXACT_LIMIT - 8:
            raise OverflowError(f"A^{step} reached the f32 exact range ({vmax})")
        nnz = int(c.nnz())
        if native_stats is not None:
            _, want_nnz, want_max, _ = native_stats[step - 2]
            if (nnz, vmax) != (want_nnz, float(want_max)):
                raise RuntimeError(f"A^{step}: (nnz, max) = ({nnz}, {vmax:.0f}) but the "
                                   f"oracle has ({want_nnz}, {want_max})")
        rec = ChainStep(step=step, nnz=nnz, flops=0, seconds=dt, nnz_per_s=nnz / dt,
                        gflops=0.0, max_value=vmax)
        results.append(rec)
        if verbose:
            print(f"A^{step} [band {device.type}, K={c.k_blocks}]: nnz={nnz} "
                  f"time={dt * 1e3:.4f}ms nnz/s={rec.nnz_per_s / 1e6:.1f}M max={vmax:.0f}",
                  flush=True)
        prev = c
    return results, prev


def fold(a: HostCSR, perm: np.ndarray) -> Tuple[HostCSR, int]:
    """A relabelled by ``perm`` (entry (i, j) moves to (perm[i], perm[j]))
    and its linear band half-width."""
    if len(perm) != a.n_rows or a.n_rows != a.n_cols:
        raise ValueError(f"a {len(perm)}-node fold of a ({a.n_rows}, {a.n_cols}) matrix")
    rows, cols = perm[a.rows()], perm[a.col_idx.astype(np.int64)]
    return (HostCSR.from_coo(rows, cols, a.vals, a.n_rows, a.n_cols, a.sr_name),
            bandplanes.band_halfwidth(rows, cols))


def run_chain_foldband(
    a: HostCSR,
    device,
    dims: Sequence[int],
    max_step: int = 7,
    iters: int = 3,
    native_stats: Optional[list] = None,
    verbose: bool = True,
) -> Tuple[List[ChainStep], torch.Tensor, np.ndarray, np.ndarray]:
    """The fold-band chain (the counterpart of ``run_chain_foldband`` in the
    JAX package): relabel the ``dims`` torus once by ``fold_perm`` so that A
    is a pure band of half-width h, then run C_k = A x C_{k-1} through
    ``spmm_band``, step k writing only the windows of half-width k*h.

    The layouts of every step are computed on the host before the timed
    steps, with ``bandplanes.QUANTUM``-column window starts and no chaining
    slack (see ``kernels/bandplanes.py``); the
    steps ping-pong two preallocated buffers sized for the widest step.
    nnz, max and flops are permutation-invariant, so ``native_stats`` from
    the unfolded oracle applies unchanged; timing and checks as
    ``_time_chain`` says.  Returns (records, final band product, its window
    starts, perm); ``unfold_band`` turns the last three into A^max."""
    device = torch.device(device)
    _check_chain_args(max_step, iters, native_stats)
    perm = bandplanes.fold_perm(dims)
    a_f, h_a = fold(a, perm)
    n = a.n_rows
    q = bandplanes.QUANTUM
    total = -(-n // q) * q
    layouts = [bandplanes.band_layout(n, k * h_a, total, q)
               for k in range(1, max_step + 1)]
    op = spmm.prepare_sparse_operand(a_f, device)
    p0 = bandplanes.csr_to_band(op, *layouts[0])
    w_max = max(w for _, w in layouts[1:])
    flat = [torch.empty(n * w_max, dtype=torch.float32, device=device) for _ in range(2)]
    steps = []
    for idx in range(max_step - 1):
        (b_in, w_in), (b_out, w_out) = layouts[idx], layouts[idx + 1]
        bop = bandplanes.prepare_band_operand(op, b_in, w_in, b_out, w_out,
                                              h_in=(idx + 1) * h_a)
        steps.append(_Step(functools.partial(bandplanes.spmm_band, bop),
                           flat[idx % 2][:n * w_out].view(n, w_out),
                           (a.nnz * w_in + n * w_out) * 4,
                           f"foldband w_in={w_in} w_out={w_out} {device.type}"))
    results, p = _time_chain(steps, p0, op, iters, native_stats, verbose)
    return results, p, layouts[-1][0], perm


def unfold_band(p: torch.Tensor, base: np.ndarray, perm: np.ndarray) -> torch.Tensor:
    """A folded band product back in the original labels: dense (n, n) with
    entry (i, j) = folded (perm[i], perm[j])."""
    dense = bandplanes.band_to_dense(p, base, len(perm))
    idx = torch.from_numpy(perm).to(p.device)
    return dense[idx][:, idx]


def verify_final_values(p: torch.Tensor, native_final, sample_rows: int = 128) -> None:
    """Exact check of the chain's final dense product against the oracle's
    CSR: global nnz and max, and every value of the ``sample_rows`` leading
    rows.  Raises RuntimeError on a disagreement."""
    crp, cc, cv = native_final
    n_rows, n_cols = p.shape
    got_nnz = int(torch.count_nonzero(p))
    got_max = float(p.max()) if p.numel() else 0.0
    want_nnz = int(crp[-1])
    want_max = int(cv.max()) if len(cv) else 0
    if (got_nnz, got_max) != (want_nnz, float(want_max)):
        raise RuntimeError(f"final (nnz, max) = ({got_nnz}, {got_max:.0f}) but the "
                           f"oracle has ({want_nnz}, {want_max})")
    m = min(sample_rows, n_rows)
    got = p[:m].cpu().numpy().astype(np.float64)
    want = np.zeros((m, n_cols), np.float64)
    e = int(crp[m])
    rows = np.repeat(np.arange(m), np.diff(crp[: m + 1]))
    want[rows, cc[:e]] = cv[:e].astype(np.float64)
    if not np.array_equal(got, want):
        bad = int((got != want).sum())
        raise RuntimeError(f"final values disagree with the oracle in {bad} "
                           f"places of the {m} leading rows")


def chain_csv(results: List[ChainStep]) -> str:
    lines = ["step,nnz,flops,seconds,nnz_per_s,gflops"]
    for r in results:
        lines.append(
            f"{r.step},{r.nnz},{r.flops},{r.seconds:.6f},{r.nnz_per_s:.1f},{r.gflops:.3f}"
        )
    return "\n".join(lines) + "\n"


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    parser = argparse.ArgumentParser(
        prog="python -m sparsetpu_torch.bench.chain",
        description="A^2..A^7 chain on the thinned Moore torus")
    parser.add_argument("--quick", action="store_true",
                        help="12^3 torus instead of 30^3")
    parser.add_argument("--steps", type=int, default=7)
    parser.add_argument("--iters", type=int, default=3)
    parser.add_argument("--csv", type=str, default=None, help="write per-step CSV here")
    parser.add_argument("--no-verify", action="store_true",
                        help="skip the C++ oracle and its checks")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu, which runs the plain version")
    parser.add_argument("--algo", choices=ALGOS, default="auto",
                        help="auto: the router's route (pallas, band, or rowcat for its "
                             "'esc'); pallas: the dense-accumulator SpMM (--kernel); dense: "
                             "the plain-torch gather/segment-sum SpMM; band: the block-band "
                             "product; esc, escb, rowcat: the ESC, blocked-ESC and "
                             "row-categorized SpGEMMs; mixed: slab ESC, then dense-acc from "
                             "--switch-step; foldband: the fold-band chain (bench.py's "
                             "--algo values)")
    parser.add_argument("--switch-step", type=int, default=5,
                        help="mixed chain: the first step on the dense-accumulator "
                             "SpMM (earlier steps ride slab ESC)")
    parser.add_argument("--kernel", choices=KERNELS, default="dense-acc",
                        help="SpMM of the dense-acc route: dense-acc or group-dot, "
                             "which are bench.py --pallas-kernel vpu|mxu")
    args = parser.parse_args(argv)
    if args.algo not in ("auto", "pallas") and args.kernel != "dense-acc":
        parser.error(f"--kernel selects the dense-acc route's SpMM; --algo {args.algo} "
                     "runs its own")

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; only an explicit --device cpu "
                           "runs the chain on the CPU, with the plain version")
    dims = (12, 12, 12) if args.quick else (30, 30, 30)

    t0 = time.perf_counter()
    h = build_torus_host(dims)
    _log(f"host build: n={h.n_rows} nnz={h.nnz} ({time.perf_counter() - t0:.1f}s)")
    native_stats = native_final = None
    if not args.no_verify:
        t0 = time.perf_counter()
        native_stats, native_final = native_chain_stats_host(
            h.row_ptr, h.col_idx, h.vals, h.n_rows, args.steps)
        _log(f"native oracle chain: A^{args.steps} nnz={native_stats[-1][1]} "
             f"max={native_stats[-1][2]} ({time.perf_counter() - t0:.1f}s)")

    extra = {}
    algo = args.algo
    if algo == "auto":
        strategy = choose_strategy(h, steps=args.steps - 1)
        algo = ROUTE_ALGO[strategy]
        _log(f"choose_strategy -> {strategy} (algo={algo})")
        if algo != "pallas" and args.kernel != "dense-acc":
            raise ValueError(f"--kernel {args.kernel} selects the dense-acc route's SpMM; "
                             f"the router chose {strategy!r}, the {algo} chain")
    run_kw = dict(max_step=args.steps, iters=args.iters, native_stats=native_stats)
    p = None  # the final dense product, for the value check (CSR chains check every step)
    if algo == "foldband":
        kernel = "band"
        results, p_band, base, perm = run_chain_foldband(h, device, dims, **run_kw)
        p = unfold_band(p_band, base, perm) if native_final is not None else None
    elif algo == "mixed":
        kernel = "slab+dense-acc"
        switch = min(args.switch_step, args.steps + 1)
        results, p, t_dens = run_chain_mixed(h, device, switch_step=switch, **run_kw)
        extra = {"switch_step": switch, "densify_ms": t_dens * 1e3}
    elif algo in ("esc", "escb", "rowcat"):
        kernel = algo
        run = {"esc": run_chain, "escb": run_chain_escb, "rowcat": run_chain_rowcat}[algo]
        results, _ = run(h, device, **run_kw)
    elif algo == "dense":
        kernel = "dense"
        results, p = run_chain_dense(h, device, **run_kw)
    elif algo == "band":
        kernel = "band-matmul"
        half_width = bandmm.cyclic_bandwidth(h)
        block = BAND_BLOCKS.get(h.n_rows, 125)
        _log(f"cyclic bandwidth: {half_width}, block {block}")
        results, band = run_chain_band(h, device, half_width, block=block, **run_kw)
        p = bandmm.band_to_dense(band) if native_final is not None else None
    else:
        kernel = args.kernel
        results, p = run_chain_dense_acc(h, device, kernel=kernel, **run_kw)
    total = sum(r.seconds for r in results) + extra.get("densify_ms", 0.0) / 1e3
    print(f"chain total (A^2..A^{args.steps}{', incl. densify' if extra else ''}): "
          f"{total * 1e3:.4f}ms on {device_name(device)}  [reference CSR-par total "
          f"~102 ms]", flush=True)
    if native_final is not None:
        if p is not None:
            verify_final_values(p, native_final)
        _log("per-step (nnz, max) and final values agree with the native oracle")

    last = results[-1]
    record = {
        "metric": f"spgemm_chain_A{last.step}_nnz_per_s",
        "value": last.nnz_per_s,
        "unit": "nnz/s",
        "vs_baseline": last.nnz_per_s / BASELINE_NNZ_PER_S,
        "chain_ms": total * 1e3,
        "device": device_name(device),
        "verified": native_final is not None,
        "algo": args.algo,
        "kernel": kernel,
        **extra,
    }
    print(json.dumps(record), flush=True)
    if args.csv:
        os.makedirs(os.path.dirname(args.csv) or ".", exist_ok=True)
        with open(args.csv, "w") as f:
            f.write(chain_csv(results))
    return record


if __name__ == "__main__":
    main()
