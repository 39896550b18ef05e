"""Where the time of one general-SpGEMM call goes on the GPU.

For one graph of the sweep (``spgemm_bench.make_cases``) and each
algorithm, the call that ``spgemm_bench`` times runs twice to warm up, then
once under ``torch.profiler`` (CPU and CUDA activities), and the script
prints:

- the call's wall time (host clock, ending in a synchronisation);
- the device time, the sum of the kernels' self times on the card (one
  stream, so they do not overlap), and the device's idle share of the wall
  time, which is time the card waited for the host's launches;
- the number of kernels launched, and the kernels that took the most device
  time.

Besides the sweep's algorithms it takes ``slab`` (the device half of
``spgemm_slab`` on a fixed plan, as the mixed chain times it) and
``colchunk`` (the whole ``spgemm_colchunk`` call at ``--slot-budget``), and
``--case torus --step K``: the mixed chain's product A^(K-1) x A of the
30^3 thinned torus, A^(K-1) made by slab first.

Run on a GPU: ``python -m sparsetpu_torch.bench.spgemm_profile --case er
--n 27000 --e-per-n 32 [--algos esc escb rowcat rowcat_pallas slab colchunk]
[--top 6]``.  The last line is one JSON object with the numbers.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..ops import colchunk, slab
from ..ops.spgemm import symbolic_flops_exact
from .chain import build_torus_host, sparse_operand
from .spgemm_bench import ALGOS, algo_call, case_operand, make_cases


def _device_us(event) -> float:
    # the attribute's name differs between PyTorch releases
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


def profile_call(fn, top: int = 6) -> dict:
    """Profile one call of fn() (warmed up twice); returns wall_ms,
    device_ms, idle_share, kernels (launch count) and the top kernels by
    device time as (name, ms, calls)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_name = sorted(((e.key, _device_us(e) / 1e3, e.count) for e in prof.key_averages()
                      if _device_us(e) > 0), key=lambda x: -x[1])
    return dict(wall_ms=wall_ms, device_ms=device_ms,
                idle_share=max(0.0, 1.0 - device_ms / wall_ms), kernels=len(kernels),
                top=[(name[:60], ms, calls) for name, ms, calls in by_name[:top]])


def _call(a, b, algo: str, slot_budget: int):
    """The profiled call: the sweep's, or slab's device half on a fixed plan,
    or a whole colchunk call."""
    if algo == "slab":
        plan = slab.slab_config(a, b)
        return lambda: slab.slab_numeric(a, b, plan)
    if algo == "colchunk":
        return lambda: colchunk.spgemm_colchunk(a, b, slot_budget=slot_budget)
    if a is not b:
        raise ValueError(f"{algo} profiles A x A only")
    return algo_call(a, algo)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m sparsetpu_torch.bench.spgemm_profile",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--case", choices=("er", "powerlaw", "torus"), default="er")
    ap.add_argument("--step", type=int, default=4,
                    help="torus: profile the product A^(step-1) x A")
    ap.add_argument("--slot-budget", type=int, default=colchunk.DEFAULT_SLOT_BUDGET,
                    help="colchunk's slot budget")
    ap.add_argument("--n", type=int, default=27000)
    ap.add_argument("--e-per-n", type=int, default=32, help="ER edges per node")
    ap.add_argument("--algos", nargs="*", default=list(ALGOS))
    ap.add_argument("--top", type=int, default=6)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the profile needs a CUDA card")
    dev = torch.device("cuda")
    if args.case == "torus":
        b = sparse_operand(build_torus_host(), dev)
        a = b
        for _ in range(args.step - 2):
            a = slab.spgemm_slab(a, b).check()
        case, n, epn = f"torus30^3 A^{args.step - 1} x A", b.n_rows, 0
    else:
        er = args.case == "er"
        (case, n, epn, coo), = make_cases(sides=(args.n,) if er else (),
                                          e_per_n=(args.e_per_n,),
                                          power_law_sides=() if er else (args.n,))
        a = b = case_operand(coo, dev)
    flops = symbolic_flops_exact(a, b)
    print(f"# {case} n={n} e/n={epn}: {flops} products on {torch.cuda.get_device_name(dev)}",
          flush=True)
    out = {}
    for algo in args.algos:
        res = profile_call(_call(a, b, algo, args.slot_budget), args.top)
        out[algo] = res
        print(f"{algo}: wall {res['wall_ms']:.3f} ms, device {res['device_ms']:.3f} ms, "
              f"idle {res['idle_share']:.1%}, {res['kernels']} kernels", flush=True)
        for name, ms, calls in res["top"]:
            print(f"    {ms:9.3f} ms  x{calls:<4d} {name}", flush=True)
    print(json.dumps({"case": f"{case},{n},{epn}", "flops": flops, "profile": out}),
          flush=True)


if __name__ == "__main__":
    main()
