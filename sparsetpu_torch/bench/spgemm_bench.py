"""General-SpGEMM sweep on the port: the counterpart of
``sparsetpu/bench/spgemm_bench.py`` (BASELINE configs 3-4).

For Erdős–Rényi graphs on a grid of sides x edges per node, and power-law
graphs, it squares A on the saturating u64 semiring with each algorithm and
writes the JAX package's CSV:

    case,n,e_per_n,nnz_a,flops,nnz_c,algo,seconds,mproducts_per_s

Algorithms, JAX's eight: ``esc`` (ops/spgemm.py), ``escb`` (ops/escb.py),
``rowcat`` (the row-categorized SpGEMM in JAX's batched formulation),
``rowcat_pallas`` (the same through the sort-merge kernel,
``kernels/sortmerge.py``; the label is JAX's, so the two sweeps' rows
align), ``denseacc`` (ops/denseacc.py, the dense-accumulator kernel),
``densedense`` and ``densedense_tiled`` (one fp32 matrix product of the
densified operands, whole or in column panels) and ``bcoo`` (the
``torch.sparse`` comparator, utils/bcoo.py).  The graphs come from the same
generators and seeds as JAX's, and so do the DNF rules of the dense routes:
``densedense`` where ``densedense_fits(n, n, n)`` fails, ``densedense_tiled``
where no panel fits.

Differences from the JAX package:

- Every product is held against the C++ oracle (``native.spgemm``): the
  whole CSR, row offsets, columns and values, before any timing.  A
  disagreement, like any failure, becomes a DNF row.
- Times are the minimum over ``--iters`` calls after 50 ms of warm-up
  calls, by CUDA events around each whole call, host launches included
  (``bench/tipover.time_call``).  As in JAX, ``rowcat`` and
  ``rowcat_pallas`` time the numeric phase with a fixed plan
  (``rowcat_numeric``), ``escb`` its device half with a fixed packing
  (``blocked_numeric``, which also covers wide rows, where JAX's timing
  asserted), ``denseacc`` its device half with a fixed operand
  (``dense_acc_numeric``), ``densedense`` ``densedense_numeric`` and
  ``bcoo`` the sparse x sparse product alone, its operands converted
  before; ``esc`` times the whole ``spgemm`` call, and ``densedense_tiled``
  whole calls by the host clock (its sweeps read their counts back).
- The fused repetition loops, the input "bump" and the DNF budgets of
  JAX's sweep were remote-TPU machinery and are gone.  A CUDA
  out-of-memory error becomes a DNF row, its memory released.

Run: ``python -m sparsetpu_torch.bench.spgemm_bench [--sides ...]
[--e-per-n ...] [--power-law-sides ...] [--algos ...] [--no-prelude]
[--iters N] [--out PATH] [--device cuda|cpu]``.
"""

from __future__ import annotations

import argparse
import math
import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import native
from ..csr import SparseCSR
from ..graphs import datasets, generate
from ..ops import denseacc, escb, rowcat
from ..ops.spgemm import pow2, spgemm, symbolic_flops_exact
from ..semiring import U64
from ..utils import bcoo
from .tipover import time_call

HEADER = "case,n,e_per_n,nnz_a,flops,nnz_c,algo,seconds,mproducts_per_s"
ALGOS = ("esc", "escb", "rowcat", "rowcat_pallas", "denseacc", "densedense",
         "densedense_tiled", "bcoo")


def make_cases(sides=(1000, 3375, 8000, 27000), e_per_n=(2, 8, 32),
               power_law_sides=(27000,)) -> List[Tuple[str, int, int, tuple]]:
    """(case, n, e_per_n, coo) of the sweep, from JAX's generators and seeds."""
    cases = [("er", n, epn, generate.random_graph(n, n * epn, seed=n + epn))
             for n in sides for epn in e_per_n]
    cases += [("powerlaw", n, 8, datasets.power_law(n, 8, seed=17)) for n in power_law_sides]
    return cases


def check_against_oracle(c: SparseCSR, want, what: str) -> None:
    """Raise unless c equals the oracle's CSR (row_ptr, col_idx, values)."""
    c.check()
    got = c.to_numpy()
    for name, g, w in zip(("row_ptr", "col_idx", "values"), got, want):
        if g.shape != w.shape or not np.array_equal(g.astype(w.dtype), w):
            raise RuntimeError(f"{what}: {name} disagrees with the oracle")


def case_operand(coo, device) -> SparseCSR:
    """A of one case on ``device``: the u64 CSR of the sweep, its capacity
    the next power of two of its entries (as JAX's)."""
    r, c, v, nn = coo
    return SparseCSR.from_coo_host(r, c, v, nn, sr=U64, capacity=pow2(len(r)), device=device)


def algo_call(a: SparseCSR, algo: str):
    """The call a row times, a function of no arguments returning A x A (for
    ``bcoo`` the ``torch.sparse`` product, which ``bcoo.bcoo_to_csr`` turns
    into a CSR); the host half (the expansion capacity, a plan, the dense
    operand, the library's operands) runs here, once.  A dense route that
    JAX's rule finds too large raises RuntimeError("DNF_error")."""
    n = a.n_rows
    if algo == "esc":
        cap = pow2(symbolic_flops_exact(a, a))
        return lambda: spgemm(a, a, cap)
    if algo == "escb":
        plan = escb.blocked_config(a, a)
        return lambda: escb.blocked_numeric(a, a, plan)
    if algo in ("rowcat", "rowcat_pallas"):
        config = rowcat.rowcat_config(a, a)
        use_kernel = algo == "rowcat_pallas"
        return lambda: rowcat.rowcat_numeric(a, a, *config, use_kernel=use_kernel)
    if algo in ("denseacc", "densedense"):
        cap = pow2(min(symbolic_flops_exact(a, a), n * n))
        if algo == "denseacc":
            op = denseacc.plan_dense_acc(a)
            return lambda: denseacc.dense_acc_numeric(op, a, cap)
        if not denseacc.densedense_fits(n, n, n):
            raise RuntimeError("DNF_error")
        return lambda: denseacc.densedense_numeric(a, a, cap)
    if algo == "densedense_tiled":
        w = denseacc.densedense_tiled_panel_cols(n, n)
        if not w:
            raise RuntimeError("DNF_error")
        return lambda: denseacc.spgemm_dense_dense_tiled(a, a, panel_cols=w)
    if algo == "bcoo":
        am = bcoo.csr_to_bcoo(a)
        return lambda: torch.sparse.mm(am, am)
    raise ValueError(f"unknown algorithm {algo!r}; have {ALGOS}")


def host_clock_time(fn, iters: int, device: torch.device) -> float:
    """Least seconds of ``iters`` whole calls by the host clock, each ending
    in a synchronise (for calls that synchronise inside)."""
    fn()
    best = math.inf
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        best = min(best, time.perf_counter() - t0)
    return best


def run(sides=(1000, 3375, 8000, 27000), e_per_n=(2, 8, 32), power_law_sides=(27000,),
        algos=("esc", "escb", "rowcat"), iters: int = 2, verbose: bool = True,
        out_path: Optional[str] = None, prelude: bool = True, device="cuda") -> str:
    """The sweep; returns the CSV text (written to ``out_path`` after every
    row when given).  ``prelude``: before the rows of each graph, print its
    row categories (L, rows, route of ``rowcat_pallas``) when ``verbose``;
    every row checks its own product against the oracle."""
    for algo in algos:
        if algo not in ALGOS:
            raise ValueError(f"unknown algorithm {algo!r}; have {ALGOS}")
    device = torch.device(device)
    rows: List[str] = [HEADER]

    def emit(line: str, note: str = "") -> None:
        rows.append(line)
        if out_path:  # after every row: a killed sweep keeps what it measured
            with open(out_path, "w") as f:
                f.write("\n".join(rows) + "\n")
        if verbose:
            print(line + note, flush=True)

    if verbose:
        print(HEADER, flush=True)
    for case, n, epn, coo in make_cases(sides, e_per_n, power_law_sides):
        a = case_operand(coo, device)
        flops = symbolic_flops_exact(a, a)
        host = native.as_host_csr(*a.to_numpy())
        want = native.spgemm(host, host, n)
        nnz_c = int(want[0][-1])
        prefix = f"{case},{n},{epn},{int(a.nnz)},{flops},{nnz_c}"
        if prelude and verbose:
            try:
                config = rowcat.rowcat_config(a, a)
                dmax, dmean = datasets.degree_stats(coo)
                mix = " ".join(f"L{L}:{nr}:{route}" for L, nr, route in
                               rowcat.category_routes(a, config[3]))
                over = int((config[1] == rowcat.N_CATS - 1).sum())
                print(f"# catmix {case} n={n} e/n={epn}: {mix}"
                      f"{f' overflow:{over}:esc' if over else ''} "
                      f"(deg max={dmax} mean={dmean:.1f})", flush=True)
            except Exception as e:  # the rowcat rows report their own failure
                print(f"# catmix {case} n={n} e/n={epn} failed: {type(e).__name__}: "
                      f"{str(e)[:160]}", flush=True)
                if isinstance(e, torch.cuda.OutOfMemoryError):
                    torch.cuda.empty_cache()
        for algo in algos:
            try:
                call = algo_call(a, algo)
                out = call()
                check_against_oracle(bcoo.bcoo_to_csr(out) if algo == "bcoo" else out,
                                     want, algo)
                del out
                # the panel sweep reads its counts back inside the call: whole
                # calls by the host clock, as JAX times it
                timer = host_clock_time if algo == "densedense_tiled" else time_call
                t = timer(call, iters, device)
            except Exception as e:  # record the DNF and keep sweeping
                emit(f"{prefix},{algo},DNF_error,0.0",
                     f"  # {type(e).__name__}: {str(e)[:160]}")
                if isinstance(e, torch.cuda.OutOfMemoryError):
                    torch.cuda.empty_cache()
                continue
            emit(f"{prefix},{algo},{t:.6f},{flops / t / 1e6:.1f}")
    return "\n".join(rows) + "\n"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m sparsetpu_torch.bench.spgemm_bench",
        description="General-SpGEMM sweep (BASELINE configs 3-4): ER grid and "
                    "power-law graphs squared by each algorithm, oracle-checked")
    ap.add_argument("--sides", type=int, nargs="*", default=[1000, 3375, 8000, 27000])
    ap.add_argument("--e-per-n", type=int, nargs="*", default=[2, 8, 32])
    ap.add_argument("--algos", nargs="*", default=["esc", "escb", "rowcat"])
    ap.add_argument("--power-law-sides", type=int, nargs="*", default=[27000])
    ap.add_argument("--iters", type=int, default=2, help="timed calls per row (minimum)")
    ap.add_argument("--out", default="bench_out/spgemm_sweep.csv")
    ap.add_argument("--no-prelude", action="store_true",
                    help="skip the category-mix print before each graph "
                         "(every row checks against the oracle either way)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, which runs the plain versions")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; only an explicit --device cpu "
                           "runs the sweep on the CPU, with the plain versions")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"# spgemm sweep on {name}", flush=True)
    csv = run(sides=tuple(args.sides), e_per_n=tuple(args.e_per_n),
              power_law_sides=tuple(args.power_law_sides), algos=tuple(args.algos),
              iters=args.iters, out_path=args.out, prelude=not args.no_prelude,
              device=device)
    with open(args.out, "w") as f:
        f.write(csv)


if __name__ == "__main__":
    main()
