#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (sparsetpu_torch) on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``.  It needs one CUDA
card, nvcc and g++, builds every kernel and the C++ oracle from the sources
in the checkout, and runs in phases; any failure raises and exits non-zero:

1. card identity (nvidia-smi name and power limit, torch's device name);
2. build of the CUDA kernel library and the oracle, with nvcc's report;
3. each kernel against its plain PyTorch version, for exact equality
   (integer values below 2^24 carried in f32: every summation order is
   exact, so the tolerance is 0), at four shapes;
4. the port's main path at full scale: the 30^3 thinned-torus chain
   A^2..A^7 through the router and ``run_chain_dense_acc``, every step's
   (nnz, max) against the oracle and the published table, the final values
   on 128 leading rows, and the kernel launch count of that run;
5. a JSON line per kernel, the card line, and the contract line
   ``{"ok": true, "device": {...}}`` last.
"""

import json
import subprocess
import sys
import time

import torch

EXPECTED = [  # (step, nnz, max) of the 30^3 chain, exact on any device
    (2, 248_957, 10), (3, 645_695, 20), (4, 1_544_375, 149),
    (5, 3_310_002, 383), (6, 6_448_685, 2_572), (7, 11_493_935, 7_383),
]
STEPS = 7
SLICE_ROWS = 256


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean ms of fn() over reps launches, by CUDA events, after one warm-up."""
    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this "
                         "smoke test needs a CUDA card")
    from sparsetpu_torch import native
    from sparsetpu_torch.bench.chain import (
        build_torus_host, native_chain_stats_host, run_chain_dense_acc,
        verify_final_values)
    from sparsetpu_torch.csr import HostCSR
    from sparsetpu_torch.graphs.generate import random_graph
    from sparsetpu_torch.kernels import _build, spmm
    from sparsetpu_torch.ops.hybrid import choose_strategy

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = card_line()

    # ---- phase 1: card identity
    print(f"[1] card: {card} | torch: {kind} | count={torch.cuda.device_count()} "
          f"| torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # ---- phase 2: build
    t0 = time.perf_counter()
    report = _build.build()
    _build.load()
    t_kernels = time.perf_counter() - t0
    t0 = time.perf_counter()
    native.lib()
    t_oracle = time.perf_counter() - t0
    for line in report.splitlines():
        if "registers" in line or "spill" in line:
            print(f"    nvcc: {line.strip()}")
    print(f"[2] built kernels in {t_kernels:.2f}s, oracle in {t_oracle:.2f}s", flush=True)

    # ---- phase 3: kernel against plain version
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand_p(n_rows, n_cols):
        return torch.randint(0, 5, (n_rows, n_cols), generator=gen, device=dev,
                             dtype=torch.float32)

    rg_rows, rg_cols, rg_vals, rg_n = random_graph(300, 900, seed=1)
    cases = [
        ("torus 12^3", build_torus_host((12, 12, 12))),
        ("torus 5x5x3 (n=75)", build_torus_host((5, 5, 3))),
        ("random_graph(300, 900), non-symmetric",
         HostCSR.from_coo(rg_rows, rg_cols, rg_vals, rg_n)),
    ]
    max_err = 0.0
    for name, h in cases:
        op = spmm.prepare_sparse_operand(h, dev)
        p = rand_p(h.n_cols, h.n_cols)
        got = spmm.spmm_dense_acc(op, p)
        want = spmm.spmm_dense_acc_reference(op, p)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        max_err = max(max_err, err)
        check(torch.equal(got, want), f"{name}: kernel != plain (max |err| {err})")
        print(f"[3] {name}: n={h.n_rows} nnz={h.nnz} kernel == plain (exact)", flush=True)

    h30 = build_torus_host((30, 30, 30))
    op = spmm.prepare_sparse_operand(h30, dev)
    op_slice = spmm.row_slice(op, 0, SLICE_ROWS)
    p = rand_p(h30.n_cols, h30.n_cols)
    full = spmm.spmm_dense_acc(op, p)
    sliced = spmm.spmm_dense_acc(op_slice, p)
    want = spmm.spmm_dense_acc_reference(op_slice, p)
    torch.cuda.synchronize()
    err = max(float((full[:SLICE_ROWS] - want).abs().max()),
              float((sliced - want).abs().max()))
    max_err = max(max_err, err)
    check(torch.equal(full[:SLICE_ROWS], want) and torch.equal(sliced, want),
          f"30^3 operand, rows 0..{SLICE_ROWS}: kernel != plain (max |err| {err})")
    kernel_ms = time_ms(lambda: spmm.spmm_dense_acc(op_slice, p, out=sliced), 50)
    plain_ms = time_ms(lambda: spmm.spmm_dense_acc_reference(op_slice, p), 10)
    full_ms = time_ms(lambda: spmm.spmm_dense_acc(op, p, out=full), 5)
    print(f"[3] 30^3 operand (n={h30.n_rows} nnz={h30.nnz}) x random P, rows "
          f"0..{SLICE_ROWS}: kernel == plain (exact); {SLICE_ROWS}-row slice: "
          f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms; full operand "
          f"kernel {full_ms:.4f} ms", flush=True)
    del full, sliced, want, p, op, op_slice
    torch.cuda.empty_cache()

    # ---- phase 4: the main path at full scale
    t0 = time.perf_counter()
    stats, final = native_chain_stats_host(h30.row_ptr, h30.col_idx, h30.vals,
                                           h30.n_rows, STEPS)
    print(f"[4] oracle chain A^2..A^{STEPS}: {time.perf_counter() - t0:.1f}s", flush=True)
    check([tuple(s[:3]) for s in stats] == EXPECTED,
          f"oracle stats {[s[:3] for s in stats]} != published {EXPECTED}")
    strategy = choose_strategy(h30, steps=STEPS - 1)
    print(f"[4] choose_strategy -> {strategy}", flush=True)
    check(strategy == "dense-acc", f"route is {strategy!r}, not 'dense-acc'")

    spmm.LAUNCHES = 0
    results, p_final = run_chain_dense_acc(h30, dev, max_step=STEPS, iters=3,
                                           native_stats=stats)
    torch.cuda.synchronize()
    launches = spmm.LAUNCHES
    got = [(r.step, r.nnz, int(r.max_value)) for r in results]
    check(got == EXPECTED, f"chain (step, nnz, max) {got} != {EXPECTED}")
    verify_final_values(p_final, final, sample_rows=128)
    print(f"[4] per-step (nnz, max) == oracle == published table; final values == "
          f"oracle on 128 leading rows", flush=True)
    check(launches >= STEPS - 1, f"main path made {launches} kernel launches")
    print(f"[4] spmm_dense_acc launches in the main path: {launches}", flush=True)
    for r in results:
        print(f"[4] A^{r.step} step: {r.seconds * 1e3:.4f} ms  "
              f"({r.gb_per_s:.1f} GB/s of the byte model)", flush=True)
    total_ms = sum(r.seconds for r in results) * 1e3
    print(f"[4] chain total A^2..A^{STEPS}: {total_ms:.4f} ms", flush=True)
    print(f"[4] A^{STEPS} nnz/s: {results[-1].nnz_per_s:.1f}", flush=True)
    del p_final
    torch.cuda.empty_cache()

    # ---- phase 5: results
    print(json.dumps({"kernels": [{
        "name": "spmm_dense_acc",
        "route": "cuda",
        "source": "sparsetpu_torch/csrc/spmm_dense_acc.cu",
        "replaces": "sparsetpu/kernels/spmm_pallas.py:109",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "timed_on": f"30^3 operand rows 0..{SLICE_ROWS} x P ({h30.n_rows}, {h30.n_cols})",
        "full_step_ms": full_ms,
        "chain_ms": total_ms,
    }]}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)
