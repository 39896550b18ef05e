"""Einsum engine-overhead benchmark on the port: the counterpart of
``sparsetpu/bench/engine_bench.py``.

Every engine tier against the direct call it lowers to:

  - dense tier:  engine ``ab,bc->ac`` against one fp32 ``torch.einsum``
                 (TF32 off);
  - sparse tier: engine CSR x CSR (``out_format="sparse"``) against
                 ``spgemm_auto``;
  - SpMM tier:   engine f32 CSR x dense against ``ops/spmm.spmm_csr_dense``;
  - chain tier:  engine ``ab,bc,cd->ad`` against the manual pairwise
                 ``spgemm_auto`` (the planner's (AB)C);
  - planning:    the host's parse and validation of one call.

It writes the JAX package's CSV, ``case,impl,seconds,slowdown_vs_direct``,
with its case and impl names.

Differences from the JAX package:

- The ``*_fused`` rows were timed by the TPU's fused-loop timer
  (``bench/timing.py``, not ported).  Here they are the direct call's
  device time: CUDA events around ``reps`` back-to-back calls, divided by
  ``reps``, the least of ``iters`` such runs.  The per-call, engine,
  ``direct_esc`` and ``manual_pairwise`` rows are whole calls by the host
  clock after a synchronisation, the least of ``iters`` after one warm
  call, as JAX times them.  On the CPU every row is a host-clock time.
- Each engine result is held against its direct call before a number is
  written: the dense tier bit for bit, the sparse and chain tiers the whole
  CSR, the SpMM tier within rtol 1e-5, atol 1e-4 (``index_add_``'s atomics
  vary the f32 sum order on the card).  A disagreement raises.
- The dense operands are drawn on the device from seeded torch generators
  (three 27,000^2 draws in numpy would take tens of seconds of set-up); the
  sparse ones with numpy, as in JAX.

Run: ``python -m sparsetpu_torch.bench.engine_bench [--n N] [--nnz-per-row K]
[--out PATH] [--device cuda|cpu]``.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from ..csr import DEFAULT_DEVICE, SparseCSR, resolve_device
from ..einsum.engine import einsum
from ..einsum.parser import parse_spec, validate_dims
from ..ops.spgemm import auto_route, spgemm_auto, symbolic_flops_exact
from ..ops.spmm import spmm_csr_dense
from ..semiring import F32SR, U64

HEADER = "case,impl,seconds,slowdown_vs_direct"
SPMM_RTOL, SPMM_ATOL = 1e-5, 1e-4


def _rand_csr(n, m, nnz, seed, sr=U64, device=DEFAULT_DEVICE) -> SparseCSR:
    """JAX's random CSR: ``nnz`` COO draws (duplicates merge), values 1..4."""
    rng = np.random.default_rng(seed)
    return SparseCSR.from_coo(rng.integers(0, n, nnz), rng.integers(0, m, nnz),
                              rng.integers(1, 5, nnz).astype(np.uint64), n, m, sr=sr,
                              device=device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def percall(fn: Callable[[], object], iters: int, device: torch.device) -> float:
    """Least seconds of one whole call of fn by the host clock, the device
    synchronised before and after."""
    best = float("inf")
    for _ in range(iters):
        _sync(device)
        t0 = time.perf_counter()
        fn()
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return best


def device_time(fn: Callable[[], object], reps: int, iters: int, device: torch.device) -> float:
    """Seconds of one call of fn on the device: CUDA events around ``reps``
    back-to-back calls, divided by ``reps``, the least of ``iters`` runs,
    after one warm call (the host clock on the CPU)."""
    fn()
    _sync(device)
    if device.type != "cuda":
        return min(percall(lambda: [fn() for _ in range(reps)], 1, device)
                   for _ in range(iters)) / reps
    best = float("inf")
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize(device)
        best = min(best, start.elapsed_time(stop) / 1e3 / reps)
    return best


def same_csr(got: SparseCSR, want: SparseCSR, what: str) -> None:
    """Raise unless the two CSRs are equal: nnz, row offsets, and every
    valid column and value limb."""
    nnz = int(want.nnz)
    ok = (int(got.nnz) == nnz and got.shape == want.shape
          and torch.equal(got.row_ptr, want.row_ptr)
          and torch.equal(got.col_idx[:nnz], want.col_idx[:nnz])
          and all(torch.equal(g[:nnz], w[:nnz]) for g, w in zip(got.values, want.values)))
    if not ok:
        raise RuntimeError(f"engine_bench: {what}: the engine's CSR != the direct call's")


def run(n: int = 1024, nnz_per_row: int = 8, reps: int = 16, iters: int = 3,
        verbose: bool = True, device=DEFAULT_DEVICE, details: Optional[dict] = None) -> str:
    """The benchmark's CSV.  ``details`` (a dict, if given) receives each
    sparse product's route and product count and the SpMM tier's max
    |error| against its direct call."""
    device = resolve_device(device)
    rows: List[str] = []
    details = {} if details is None else details

    def emit(case, impl, secs, direct_secs):
        line = f"{case},{impl},{secs:.6f},{secs / max(direct_secs, 1e-12):.3f}"
        rows.append(line)
        if verbose:
            print(line, flush=True)

    rows.append(HEADER)
    if verbose:
        print(HEADER, flush=True)

    # --- dense tier -------------------------------------------------------
    gen = torch.Generator(device).manual_seed(0)
    x = torch.randn(n, n, generator=gen, device=device)
    y = torch.randn(n, n, generator=gen, device=device)

    def direct_mm():
        return torch.einsum("ab,bc->ac", x, y)

    t_fused = device_time(direct_mm, reps, iters, device)
    t_call = percall(direct_mm, iters, device)
    (got,) = einsum("ab,bc->ac", [x, y], sr=F32SR)  # warm
    if not torch.equal(got, direct_mm()):
        raise RuntimeError("engine_bench: dense tier: the engine's product != torch.einsum's")
    del got
    t_eng = percall(lambda: einsum("ab,bc->ac", [x, y], sr=F32SR), iters, device)
    emit(f"dense_matmul_{n}", "direct_mxu_fused", t_fused, t_fused)
    emit(f"dense_matmul_{n}", "direct_mxu_percall", t_call, t_call)
    emit(f"dense_matmul_{n}", "engine", t_eng, t_call)
    del x, y
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # --- sparse tier ------------------------------------------------------
    a = _rand_csr(n, n, n * nnz_per_row, 1, device=device)
    b = _rand_csr(n, n, n * nnz_per_row, 2, device=device)
    flops_ab = symbolic_flops_exact(a, b)
    details["spgemm"] = dict(flops=flops_ab, route=auto_route(a, b, flops_ab)[1])
    c_direct = spgemm_auto(a, b)  # warm
    (c_eng,) = einsum("ab,bc->ac", [a, b], sr=U64, out_format="sparse")
    same_csr(c_eng, c_direct, "sparse tier")
    details["spgemm"]["nnz"] = int(c_direct.nnz)
    del c_eng, c_direct
    t_d = percall(lambda: spgemm_auto(a, b), iters, device)
    t_e = percall(lambda: einsum("ab,bc->ac", [a, b], sr=U64, out_format="sparse"), iters,
                  device)
    emit(f"spgemm_{n}x{nnz_per_row}", "direct_esc", t_d, t_d)
    emit(f"spgemm_{n}x{nnz_per_row}", "engine", t_e, t_d)

    # --- sparse x dense tier (SpMM) ---------------------------------------
    af = _rand_csr(n, n, n * nnz_per_row, 4, sr=F32SR, device=device)
    d = torch.randn(n, n, generator=gen, device=device)
    t_spmm = device_time(lambda: spmm_csr_dense(af, d), reps, iters, device)
    want = spmm_csr_dense(af, d)
    (got,) = einsum("ab,bc->ac", [af, d], sr=F32SR)
    if not torch.allclose(got, want, rtol=SPMM_RTOL, atol=SPMM_ATOL):
        raise RuntimeError("engine_bench: SpMM tier: the engine's product != spmm_csr_dense's "
                           f"(rtol {SPMM_RTOL}, atol {SPMM_ATOL})")
    details["spmm_max_abs_err"] = float((got - want).abs().max())
    del got, want
    t_spmm_call = percall(lambda: spmm_csr_dense(af, d), iters, device)
    t_s = percall(lambda: einsum("ab,bc->ac", [af, d], sr=F32SR), iters, device)
    emit(f"spmm_{n}x{nnz_per_row}", "direct_spmm_fused", t_spmm, t_spmm)
    emit(f"spmm_{n}x{nnz_per_row}", "direct_spmm_percall", t_spmm_call, t_spmm_call)
    emit(f"spmm_{n}x{nnz_per_row}", "engine", t_s, t_spmm_call)
    del af, d
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # --- chain tier -------------------------------------------------------
    c3 = _rand_csr(n, n, n * nnz_per_row, 3, device=device)

    def manual_chain():
        return spgemm_auto(spgemm_auto(a, b), c3)

    ab = spgemm_auto(a, b)
    flops_abc = symbolic_flops_exact(ab, c3)
    details["chain"] = dict(flops=[flops_ab, flops_abc],
                            route=[details["spgemm"]["route"], auto_route(ab, c3, flops_abc)[1]])
    del ab
    want = manual_chain()  # warm
    (got,) = einsum("ab,bc,cd->ad", [a, b, c3], sr=U64, out_format="sparse")
    same_csr(got, want, "chain tier")
    details["chain"]["nnz"] = int(want.nnz)
    del got, want
    t_m = percall(manual_chain, iters, device)
    t_c = percall(lambda: einsum("ab,bc,cd->ad", [a, b, c3], sr=U64, out_format="sparse"),
                  iters, device)
    emit(f"chain3_{n}x{nnz_per_row}", "manual_pairwise", t_m, t_m)
    emit(f"chain3_{n}x{nnz_per_row}", "engine", t_c, t_m)

    # --- planning cost (host-only) ---------------------------------------
    t0 = time.perf_counter()
    n_plan = 1000
    for _ in range(n_plan):
        p = parse_spec("ab,bc,cd->ad")
        validate_dims(p, [(n, n), (n, n), (n, n)])
    plan_s = (time.perf_counter() - t0) / n_plan
    emit("plan_parse_validate", "host", plan_s, plan_s)
    return "\n".join(rows) + "\n"


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m sparsetpu_torch.bench.engine_bench",
                                 description="Einsum engine overhead: each tier against "
                                             "the direct call it lowers to")
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--nnz-per-row", type=int, default=8)
    ap.add_argument("--out", default="bench_out/engine_bench.csv")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, which runs the plain versions")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        # the dense tier's fp32 products must not round through TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        head = f"# {card_line()}; device times by CUDA events, whole calls by the host clock"
    else:
        head = "# cpu: every row by the host clock (not a device time)"
    print(head, flush=True)
    csv = run(n=args.n, nnz_per_row=args.nnz_per_row, device=device)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(head + "\n" + csv)


if __name__ == "__main__":
    main()
