"""The A^2..A^7 chain benchmark on the port: counterpart of ``sparsetpu/bench/chain.py``.

The headline workload: the 30^3 Moore torus thinned to ~3 edges per node
(n = 27,000, nnz(A) = 80,882) on the u64 semiring, carried in f32, and the
chain C_k = A x C_{k-1} for k = 2..7.  Three forms, as in ``bench.py``:

- the router's route, "dense-acc": full-width steps through the
  dense-accumulator SpMM (kernels/spmm.py), or through the group-dot SpMM
  (kernels/groupdot.py) with ``--kernel group-dot``;
- ``--algo foldband``: the torus folded into a pure band and every step
  through the band SpMM (kernels/bandplanes.py), on windows of the band's
  width only.

Every step's nnz and max are checked against the C++ oracle, and the final
product's values on its leading rows (for fold-band, after unfolding).

Run: ``python -m sparsetpu_torch.bench.chain [--quick] [--steps 7] [--iters 3]
[--algo auto|foldband] [--kernel dense-acc|group-dot] [--csv PATH]
[--no-verify] [--device cuda]``.  It prints one line per step and then one
JSON line with the A^7 output rate, as ``bench.py`` does.
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
from ..csr import F32_EXACT_LIMIT, HostCSR
from ..graphs import generate
from ..kernels import bandplanes, groupdot, spmm
from ..ops.hybrid import choose_strategy

BASELINE_NNZ_PER_S = 289e6  # reference CPU CSR-par at A^7 (BASELINE.md)
KERNELS = ("dense-acc", "group-dot")  # bench.py --pallas-kernel vpu, mxu

# routes of choose_strategy the port does not have yet, and where they stand
NOT_PORTED = {
    "band": "the 'band' route (block-band product, sparsetpu/kernels/bandmm.py) "
            "is not ported yet: ROADMAP.md queue 1, item 13",
    "esc": "the 'esc' route (general SpGEMM) is not ported yet: "
           "ROADMAP.md queue 1, items 10-13",
}


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
    A (per slot, padding included, for group-dot), and the (n_rows, m) f32 C
    written once."""
    return (a_nnz + n_rows) * m * 4


def build_torus_host(dims: Sequence[int] = (30, 30, 30),
                     density: float = 3.0 / 26.0, seed: int = 42,
                     sr_name: str = "u64") -> HostCSR:
    coo = generate.lattice(list(dims), torus=True)
    if density < 1.0:
        coo = generate.thin(coo, density, seed=seed)
    rows, cols, vals, n = coo
    return HostCSR.from_coo(rows, cols, vals, n, n, sr_name)


def native_chain_stats_host(row_ptr, col_idx, vals, n: int, max_step: int = 7):
    """A^2..A^max on the C++ oracle (exact saturating u64).  Returns per-step
    (step, nnz, max_value, expansion_flops) and the final (row_ptr, col, val)."""
    base = native.as_host_csr(row_ptr, col_idx, vals)
    rnz_a = np.diff(base[0])
    stats = []
    prev = base
    for step in range(2, max_step + 1):
        # flops of the product giving A^step: every entry (i, k) of the
        # current power expands to row_nnz_A[k] partial products
        flops = int(rnz_a[prev[1].astype(np.int64)].sum())
        prev = native.spgemm(prev, base, n)
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
    """One product of a chain: ``launch(p, out)`` writes C = A x P into out."""

    launch: Callable[[torch.Tensor, torch.Tensor], object]
    out: torch.Tensor
    bytes: int  # the step's byte model
    label: str


def _time_chain(steps: List[_Step], p0: torch.Tensor, a_op: spmm.SparseOperand,
                iters: int, native_stats: Optional[list],
                verbose: bool) -> Tuple[List[ChainStep], torch.Tensor]:
    """Run ``steps`` from P0 ``iters`` times and keep each step's minimum
    time: CUDA events around the one launch on a GPU, ``time.perf_counter``
    on the CPU.  During the first repetition, outside the timed windows,
    every step's nnz and max are read back and checked against
    ``native_stats`` when given; the first disagreement raises.  Returns the
    per-step records and the final product (the last step's ``out``)."""
    device = p0.device
    on_gpu = device.type == "cuda"
    k = len(steps)
    # exact flops of C = A x P: entry (i, k) of A meets row k of P
    col_count_a = torch.bincount(a_op.col_idx.long(), minlength=a_op.n_cols)
    best = [math.inf] * k
    checked = []  # (nnz, max, flops) per step, from the first repetition
    events = []  # (step index, start, stop) CUDA events
    row_nnz = torch.diff(a_op.row_ptr).long()  # row nnz of P0 = A
    for it in range(iters):
        p = p0
        for idx, st in enumerate(steps):
            if on_gpu:
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                st.launch(p, st.out)
                stop.record()
                events.append((idx, start, stop))
            else:
                t0 = time.perf_counter()
                st.launch(p, st.out)
                best[idx] = min(best[idx], time.perf_counter() - t0)
            if it == 0:
                flops = int((col_count_a * row_nnz).sum())
                row_nnz = torch.count_nonzero(st.out, dim=1)
                nnz = int(row_nnz.sum())
                vmax = float(st.out.max())
                step = idx + 2
                if vmax >= F32_EXACT_LIMIT - 8:
                    raise OverflowError(f"A^{step} reached the f32 exact range ({vmax})")
                if native_stats is not None:
                    _, want_nnz, want_max, _ = native_stats[idx]
                    if (nnz, vmax) != (want_nnz, float(want_max)):
                        raise RuntimeError(
                            f"A^{step}: (nnz, max) = ({nnz}, {vmax:.0f}) but the "
                            f"oracle has ({want_nnz}, {want_max})")
                checked.append((nnz, vmax, flops))
            p = st.out
    if on_gpu:
        # one synchronise after every repetition is queued: a sync between
        # repetitions would leave the device idle while the host launches
        # the next A^2, and that gap would land in A^2's window
        torch.cuda.synchronize(device)
        for idx, start, stop in events:
            best[idx] = min(best[idx], start.elapsed_time(stop) / 1e3)

    results = []
    for idx, ((nnz, vmax, flops), dt, st) in enumerate(zip(checked, best, steps)):
        rec = ChainStep(step=idx + 2, nnz=nnz, flops=flops, seconds=dt,
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
        launch, entries = functools.partial(spmm.spmm_dense_acc, op), a.nnz
    elif kernel == "group-dot":
        gop = groupdot.prepare_group_operand(a, device)
        # padded slots read P rows too
        launch = functools.partial(groupdot.spmm_group_dot, gop)
        entries = gop.n_groups * gop.g
    else:
        raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")
    p0 = spmm.densify(op)
    bufs = (torch.empty_like(p0), torch.empty_like(p0))
    steps = [_Step(launch, bufs[idx % 2], step_bytes(entries, a.n_rows, a.n_cols),
                   f"{kernel} {device.type}") for idx in range(max_step - 1)]
    return _time_chain(steps, p0, op, iters, native_stats, verbose)


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
    parser.add_argument("--algo", choices=("auto", "foldband"), default="auto",
                        help="auto: the router's route (dense-acc); foldband: the "
                             "fold-band chain, as bench.py --algo foldband")
    parser.add_argument("--kernel", choices=KERNELS, default="dense-acc",
                        help="SpMM of the dense-acc route: dense-acc or group-dot, "
                             "which are bench.py --pallas-kernel vpu|mxu")
    args = parser.parse_args(argv)
    if args.algo == "foldband" and args.kernel != "dense-acc":
        parser.error("--kernel selects the dense-acc route's SpMM; --algo "
                     "foldband runs the band SpMM")

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

    if args.algo == "foldband":
        kernel = "band"
        results, p_band, base, perm = run_chain_foldband(
            h, device, dims, max_step=args.steps, iters=args.iters,
            native_stats=native_stats)
        p = unfold_band(p_band, base, perm) if native_final is not None else None
    else:
        strategy = choose_strategy(h, steps=args.steps - 1)
        _log(f"choose_strategy -> {strategy}")
        if strategy != "dense-acc":
            raise NotImplementedError(NOT_PORTED[strategy])
        kernel = args.kernel
        results, p = run_chain_dense_acc(h, device, max_step=args.steps,
                                         iters=args.iters, native_stats=native_stats,
                                         kernel=kernel)
    total = sum(r.seconds for r in results)
    print(f"chain total (A^2..A^{args.steps}): {total * 1e3:.4f}ms on "
          f"{device_name(device)}  [reference CSR-par total ~102 ms]", flush=True)
    if native_final is not None:
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
    }
    print(json.dumps(record), flush=True)
    if args.csv:
        os.makedirs(os.path.dirname(args.csv) or ".", exist_ok=True)
        with open(args.csv, "w") as f:
            f.write(chain_csv(results))
    return record


if __name__ == "__main__":
    main()
