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

Run on a GPU: ``python -m sparsetpu_torch.bench.spgemm_profile --case er
--n 27000 --e-per-n 32 [--algos esc escb rowcat rowcat_pallas] [--top 6]``.
The last line is one JSON object with the numbers.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..ops.spgemm import symbolic_flops_exact
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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m sparsetpu_torch.bench.spgemm_profile",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--case", choices=("er", "powerlaw"), default="er")
    ap.add_argument("--n", type=int, default=27000)
    ap.add_argument("--e-per-n", type=int, default=32, help="ER edges per node")
    ap.add_argument("--algos", nargs="*", default=list(ALGOS))
    ap.add_argument("--top", type=int, default=6)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the profile needs a CUDA card")
    dev = torch.device("cuda")
    er = args.case == "er"
    (case, n, epn, coo), = make_cases(sides=(args.n,) if er else (), e_per_n=(args.e_per_n,),
                                      power_law_sides=() if er else (args.n,))
    a = case_operand(coo, dev)
    flops = symbolic_flops_exact(a, a)
    print(f"# {case} n={n} e/n={epn}: {flops} products on {torch.cuda.get_device_name(dev)}",
          flush=True)
    out = {}
    for algo in args.algos:
        res = profile_call(algo_call(a, algo), args.top)
        out[algo] = res
        print(f"{algo}: wall {res['wall_ms']:.3f} ms, device {res['device_ms']:.3f} ms, "
              f"idle {res['idle_share']:.1%}, {res['kernels']} kernels", flush=True)
        for name, ms, calls in res["top"]:
            print(f"    {ms:9.3f} ms  x{calls:<4d} {name}", flush=True)
    print(json.dumps({"case": f"{case},{n},{epn}", "flops": flops, "profile": out}),
          flush=True)


if __name__ == "__main__":
    main()
