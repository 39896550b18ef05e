"""Scaling of the sharded A^k chain over device counts: the counterpart of
``sparsetpu/bench/scaling.py``, the same ``ScalePoint`` and CSV columns.

Each device count is one world of ``dist.multihost.run_local``: the world's
size is fixed when it starts.  ``seconds`` is the least of ``iters`` whole
chains (``steps`` sharded ESC steps, each with its symbolic flop read) by
the host clock, from a barrier after a synchronisation to the chain's end
synchronised, the slowest rank's.  ``work_imbalance`` is max/mean of the
first step's per-shard symbolic flops: it does not depend on the hardware
and equals the JAX package's.

Where the ranks of a world share a card (one H100: NCCL refuses two ranks
on one device, so the port runs them over gloo) or the CPU, ``seconds``,
``nnz_per_s`` and ``efficiency`` measure that sharing, not scaling, and
the CSV's header says so, as ``reports/scaling_virtual8.csv`` does for the
TPU's virtual mesh.

    python -m sparsetpu_torch.bench.scaling [--devices 1 2 4] [--steps 2]
        [--out reports/scaling_h100.csv]
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..csr import SparseCSR
from ..dist import multihost, programs
from . import chain, configs
from .engine_bench import card_line


@dataclass
class ScalePoint:
    devices: int
    seconds: float
    nnz_per_s: float
    efficiency: float      # t(1) / (t(n) * n): 1.0 is perfect scaling
    work_imbalance: float  # max/mean per-shard symbolic flops
    transport: str = ""    # the world's backend: nccl, or gloo (host memory)


def measure_scaling(a: SparseCSR, device_counts=(1, 2, 4, 8), steps: int = 2,
                    iters: int = 2, verbose: bool = True) -> List[ScalePoint]:
    """Time ``steps`` sharded chain steps at each device count, one world a
    count on ``a``'s device type (the card unless ``a`` lies on the CPU).
    Efficiency is t(1) / (t(n) * n), against the first count's time."""
    arrays = programs.csr_arrays(a)
    worlds = [(nd, multihost.run_local(programs.scaling_point, nd, arrays, steps, iters,
                                       device=a.device.type, verbose=verbose)[0])
              for nd in device_counts]
    return scale_points(worlds, verbose=verbose)


def scale_points(worlds: Sequence[Tuple[int, dict]], verbose: bool = True) -> List[ScalePoint]:
    """One ``ScalePoint`` a world from (device count, rank 0's
    ``programs.scaling_point`` result), efficiency against the first."""
    results: List[ScalePoint] = []
    t1 = None
    for nd, r0 in worlds:
        flops = np.asarray(r0["flops"]).astype(np.float64)
        imbalance = float(flops.max() / max(flops.mean(), 1.0))
        dt = min(r0["seconds"])
        if t1 is None:
            t1 = dt
        pt = ScalePoint(devices=nd, seconds=dt, nnz_per_s=r0["nnz"] / dt,
                        efficiency=t1 / (dt * nd), work_imbalance=imbalance,
                        transport=r0["transport"])
        results.append(pt)
        if verbose:
            print(f"devices={nd}: {dt * 1e3:.1f}ms nnz/s={pt.nnz_per_s / 1e6:.2f}M "
                  f"eff={pt.efficiency:.2f} imbalance={imbalance:.3f} "
                  f"transport={pt.transport}", flush=True)
    return results


def scaling_csv(results: List[ScalePoint]) -> str:
    lines = ["devices,seconds,nnz_per_s,efficiency,work_imbalance"]
    for r in results:
        lines.append(
            f"{r.devices},{r.seconds:.6f},{r.nnz_per_s:.1f},"
            f"{r.efficiency:.4f},{r.work_imbalance:.4f}"
        )
    return "\n".join(lines) + "\n"


def shared_devices(results: List[ScalePoint], device_type: str) -> List[int]:
    """The device counts whose ranks shared a device: every count on the
    CPU, and on the card every world with more ranks than cards."""
    if device_type != "cuda":
        return [r.devices for r in results]
    return [r.devices for r in results if r.devices > torch.cuda.device_count()]


def csv_header(results: List[ScalePoint], device: str, what: str) -> str:
    """The CSV's comment lines: where it ran, each world's transport, and
    whether its times are a scaling result."""
    where = (f"{torch.cuda.get_device_name(0)} ({card_line()}), "
             f"{torch.cuda.device_count()} card(s)" if device == "cuda" else "the CPU")
    lines = [f"# python -m sparsetpu_torch.bench.scaling on {where}: {what}",
             "# transports: " + "; ".join(f"{r.devices} rank(s): {r.transport}"
                                          for r in results)]
    shared = shared_devices(results, device)
    if shared:
        lines += [
            f"# hardware_meaningful=NO for seconds/nnz_per_s/efficiency at devices={shared}:",
            "# the ranks of those worlds share one device (time-sliced; gloo moves the",
            "# shards through host memory), so these columns measure the sharing, not",
            "# multi-card scaling.  work_imbalance (per-shard symbolic product-count",
            "# max/mean) does not depend on the hardware."]
    return "\n".join(lines) + "\n"


def main(argv: Optional[Sequence[str]] = None) -> List[ScalePoint]:
    parser = argparse.ArgumentParser(prog="python -m sparsetpu_torch.bench.scaling",
                                     description="sharded A^k chain over device counts")
    parser.add_argument("--config", default="torus30", choices=sorted(configs.CHAIN_CONFIGS))
    parser.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4])
    parser.add_argument("--steps", type=int, default=2)
    parser.add_argument("--iters", type=int, default=2)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu (the ranks over gloo on the host)")
    parser.add_argument("--out", default="reports/scaling_h100.csv")
    args = parser.parse_args(argv)
    cfg = configs.CHAIN_CONFIGS[args.config]
    h = chain.build_torus_host(cfg.dims, cfg.density, cfg.seed)
    a = chain.sparse_operand(h, args.device)
    results = measure_scaling(a, args.devices, steps=args.steps, iters=args.iters)
    write_csv(results, a.device.type, f"{cfg.name} (n={h.n_rows}, nnz={h.nnz}), "
              f"steps={args.steps}, iters={args.iters}", args.out)
    return results


def write_csv(results: List[ScalePoint], device: str, what: str, out: str) -> str:
    """Print and write the CSV with its header; returns its text."""
    text = csv_header(results, device, what) + scaling_csv(results)
    print(text, end="", flush=True)
    with open(out, "w") as f:
        f.write(text)
    print(f"wrote {out}", flush=True)
    return text


if __name__ == "__main__":
    main()
