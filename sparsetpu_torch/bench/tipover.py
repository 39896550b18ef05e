"""Sparse-vs-dense attention tipover sweep on the port: counterpart of
``sparsetpu/bench/tipover.py``.

For one GPT shape it times the dense scores, then sweeps the density of Q
and K over 17 log steps from 1e-4 to 1 (4 a decade) and times, at each, the
element-sparse scores (grouped ESC SpGEMM, plain PyTorch) and the
block-sparse scores (the SDD kernel, ``kernels/blocksparse.py``).  It writes
the JAX package's CSV: a dense line ``ref_time=..`` and the rows
``impl,density,q_nz,k_nz,v_nz,mem_k,mem_q,mem_v,attn_time,gen_time,attn_dry``
(times in us), and reports the crossover density, the last density at which
ESC is no slower than the dense scores.

Differences from the JAX package:

- Each time is the minimum over ``--iters`` calls after 50 ms of warm-up
  calls, by CUDA events around the call (``time.perf_counter`` with
  ``--device cpu``).  The fused repetition loops, input perturbations and
  compile cache of the JAX package's sweep existed for the TPU rig's
  20-50 ms host round trips and are gone.
- The SDD row times the T real block pairs.  JAX pads the pair list to a
  power of two with copies of pair 0, to bound its recompiles; so here
  ``mem_v`` of an SDD row is T * 128 * 128 * 4 bytes, where JAX's is the
  padded count's.
- ESC runs where JAX's rule admits it (``flops <= --max-flops`` and the
  power-of-two expansion capacity <= 2^24), so the two sweeps' rows align.
- Every product is held against the dense scores of the same Q and K
  (rtol 1e-4, atol 1e-5, the reference's 1e-4 relative agreement), outside
  the timed calls; a disagreement raises.

Run: ``python -m sparsetpu_torch.bench.tipover --configs 1 [--iters 2]
[--fine] [--out-dir bench_out] [--device cuda|cpu]``.
"""

from __future__ import annotations

import argparse
import math
import os
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..attention import scores
from ..csr import SparseCSR
from ..kernels import blocksparse
from ..ops.spgemm import pow2, spgemm, symbolic_flops

# (batch_size, sequence_length, n_heads, embedding_dim), as in the JAX package
GPT_CONFIGS: List[Tuple[int, int, int, int]] = [
    (32, 512, 12, 384),   # shakespeare-char
    (8, 1024, 12, 768),   # GPT-2 117M
    (8, 1024, 16, 1024),  # GPT-2 345M
    (8, 1024, 20, 1280),  # GPT-2 762M
    (8, 1024, 25, 1600),  # GPT-2 1542M XL
]
HEADER = "esc,density,q_nz,k_nz,v_nz,mem_k,mem_q,mem_v,attn_time,gen_time,attn_dry"
ESC_CAP_LIMIT = 1 << 24  # JAX's budget on the expansion capacity, kept
RTOL, ATOL = 1e-4, 1e-5
WARMUP_S = 0.05  # seconds of repeated calls before a timing


def config_shape(cfg) -> Tuple[int, int, int, int]:
    b, s, h, e = cfg
    return (b, s, h, e // h)


def _csr_mem_bytes(c: SparseCSR) -> int:
    """The JAX package's memory model of a CSR: row_ptr, and 4 bytes of
    column and of each limb per entry."""
    return 4 * (c.n_rows + 1) + int(c.nnz) * 4 * (1 + len(c.values))


def time_call(fn: Callable[[], object], iters: int, device: torch.device) -> float:
    """Seconds of fn(): the minimum over ``iters`` calls after a warm-up of
    at least WARMUP_S of repeated calls (an idle card first runs at low
    clocks: a cold dense baseline measured 147 us, a warm one 99 us).  On a
    GPU, CUDA events around each call and one synchronisation at the end
    (fn must not synchronise); on the CPU, the host clock."""
    t0 = time.perf_counter()
    while True:
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        if time.perf_counter() - t0 >= WARMUP_S:
            break
    if device.type == "cuda":
        events = []
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            events.append((start, stop))
        torch.cuda.synchronize(device)
        return min(a.elapsed_time(b) for a, b in events) / 1e3
    best = math.inf
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def dense_baseline(shape, iters: int = 3, device="cuda") -> float:
    """Seconds of the dense scores on random normal Q, K (seed 0)."""
    device = torch.device(device)
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)
    k = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)
    return time_call(lambda: scores.attention_scores_dense(q, k), iters, device)


def check_scores(got: np.ndarray, want: np.ndarray, what: str) -> float:
    """Raise unless got agrees with the dense scores (rtol 1e-4, atol 1e-5);
    returns the max |error|."""
    err = float(np.abs(got - want).max()) if want.size else 0.0
    if got.shape != want.shape or not np.allclose(got, want, rtol=RTOL, atol=ATOL):
        raise RuntimeError(f"{what}: scores disagree with the dense scores "
                           f"(max |err| {err})")
    return err


def sweep_config(cfg, iters: int = 2, n_density_steps: int = 17,
                 max_flops: int = 1 << 27, per_decade: int = 4,
                 verbose: bool = True, out_path: Optional[str] = None,
                 densities=None, with_sdd: bool = True, device="cuda") -> str:
    """One GPT config: the dense baseline and the density sweep, every
    product checked against the dense scores; returns the CSV text (written
    to ``out_path`` after every row when given).

    ``densities`` overrides the log grid; ``with_sdd=False`` skips the SDD
    race (``--fine``)."""
    device = torch.device(device)
    shape = config_shape(cfg)
    n_weights = int(np.prod(shape))
    dense_t = dense_baseline(shape, iters=iters, device=device)
    out = []

    def emit(row: str) -> None:
        out.append(row)
        if out_path:  # after every row: a killed sweep keeps what it measured
            with open(out_path, "w") as f:
                f.write("\n".join(out) + "\n")
        if verbose:
            print(row, flush=True)

    emit(f"ref_time={dense_t*1e6:.0f} µs blas_time={dense_t*1e6:.0f} µs "
         f"n_weights={n_weights} total_mem={3*n_weights*4}")
    emit(HEADER)
    if densities is None:
        densities = [1e-4 * 10 ** (ii / float(per_decade))
                     for ii in range(n_density_steps)]
    for ii, density in enumerate(densities):
        if density > 1.0:
            break
        t0 = time.perf_counter()
        q = scores.random_sparse_tensor(shape, density, seed=2 * ii)
        k = scores.random_sparse_tensor(shape, density, seed=2 * ii + 1)
        q_csr = scores.tensor_to_grouped_csr(q, device=device)
        kt_csr = scores.tensor_to_grouped_csr(k, transpose_last=True, device=device)
        gen_time = time.perf_counter() - t0
        q_nz, k_nz = int(q_csr.nnz), int(kt_csr.nnz)
        want = scores.attention_scores_dense(
            torch.from_numpy(q).to(device), torch.from_numpy(k).to(device)).cpu().numpy()

        flops = int(symbolic_flops(q_csr, kt_csr))
        cap = pow2(flops)
        if flops > max_flops or cap > ESC_CAP_LIMIT:
            if verbose:
                print(f"# density {density:.4f}: esc skipped (flops {flops} > budget)",
                      flush=True)
        else:
            dry = time_call(lambda: symbolic_flops(q_csr, kt_csr), iters, device)
            attn = time_call(lambda: spgemm(q_csr, kt_csr, cap), iters, device)
            c = spgemm(q_csr, kt_csr, cap).check()
            err = check_scores(scores.sparse_scores_to_dense(c, shape), want,
                               f"esc at density {density:.4f}")
            if verbose:
                print(f"# density {density:.4f}: esc == dense (max |err| {err:.3g})",
                      flush=True)
            emit(f"esc,{density:.4f},{q_nz},{k_nz},{int(c.nnz)},"
                 f"{_csr_mem_bytes(kt_csr)},{_csr_mem_bytes(q_csr)},{_csr_mem_bytes(c)},"
                 f"{attn*1e6:.0f},{gen_time*1e6:.0f},{dry*1e6:.0f}")

        if not with_sdd:
            continue
        t0 = time.perf_counter()
        qf, kf, qi, ki, meta = blocksparse.attention_block_operands(q, k, device=device)
        sdd_gen = time.perf_counter() - t0
        nblocks = int(qi.numel())
        sdd_t = time_call(lambda: blocksparse.sdd_block_scores(qf, kf, qi, ki), iters,
                          device)
        blocks = blocksparse.sdd_block_scores(qf, kf, qi, ki)
        err = check_scores(blocksparse.scores_blocks_to_dense(blocks, qi, ki, meta),
                           want, f"sdd at density {density:.4f}")
        if verbose:
            print(f"# density {density:.4f}: sdd == dense (max |err| {err:.3g})",
                  flush=True)
        block = meta["block"]
        emit(f"sdd,{density:.4f},{q_nz},{k_nz},{nblocks},"
             f"{kf.numel() * 4},{qf.numel() * 4},{nblocks * block * block * 4},"
             f"{sdd_t*1e6:.0f},{sdd_gen*1e6:.0f},0")
    return "\n".join(out) + "\n"


def crossover_density(csv_text: str) -> Optional[float]:
    """The last density of the rising ESC rows at which ESC is no slower
    than the dense ``ref_time``, before the first at which it is slower
    (None when ESC is slower from the first row)."""
    lines = csv_text.strip().split("\n")
    ref_us = float(lines[0].split("ref_time=")[1].split(" ")[0])
    last_below = None
    for line in lines[2:]:
        parts = line.split(",")
        if len(parts) < 9 or parts[0] != "esc":
            continue
        density, attn_us = float(parts[1]), float(parts[8])
        if attn_us <= ref_us:
            last_below = density
        else:
            return last_below
    return last_below


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        prog="python -m sparsetpu_torch.bench.tipover",
        description="Attention tipover sweep: dense scores vs grouped ESC vs SDD, "
                    "one tipover_results_{i}.csv per GPT config")
    parser.add_argument("--configs", type=int, nargs="*", default=[0],
                        help="GPT config indices (0..4), default [0]")
    parser.add_argument("--out-dir", default="bench_out")
    parser.add_argument("--iters", type=int, default=2)
    parser.add_argument("--max-flops", type=int, default=1 << 27)
    parser.add_argument("--per-decade", type=int, default=4)
    parser.add_argument("--fine", action="store_true",
                        help="linear density steps 0.05%%..1%% instead of the log "
                             "sweep (tipover_fine_{i}.csv); esc only")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu, which runs the plain versions")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; only an explicit --device cpu "
                           "runs the sweep on the CPU, with the plain versions")
    os.makedirs(args.out_dir, exist_ok=True)
    densities = [ii * 5e-4 for ii in range(1, 21)] if args.fine else None
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    for ci in args.configs:
        cfg = GPT_CONFIGS[ci]
        print(f"# config {ci}: batch={cfg[0]} seq={cfg[1]} heads={cfg[2]} "
              f"emb={cfg[3]} on {name}", flush=True)
        path = os.path.join(args.out_dir, ("tipover_fine_{}.csv" if args.fine
                                           else "tipover_results_{}.csv").format(ci))
        csv = sweep_config(cfg, iters=args.iters, max_flops=args.max_flops,
                           per_decade=args.per_decade, out_path=path,
                           densities=densities, with_sdd=not args.fine,
                           device=device)
        with open(path, "w") as f:
            f.write(csv)
        print(f"# crossover density: {crossover_density(csv)}", flush=True)


if __name__ == "__main__":
    main()
