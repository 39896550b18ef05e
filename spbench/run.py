"""The benchmark of ``sparsetpu_torch`` on the card: one run of one cell.

Run from the root of a checkout:

    python -m spbench.run --workload torus30.chain7_auto --seed 7 --seconds 30 --trace 0

A cell of ``BENCHMARK.json`` names a configuration (``spbench/configs/``:
a graph, built by ``spbench/generators/<generator>.py`` from the run's
seed) and a traffic mix (``spbench/traffic/<traffic>.json``: a unit kind,
``spbench/units/<unit>.py``, with its parameters).  Every metric is a
reader of its own, ``spbench/metrics/<name>.py``.  A cell, a configuration
or a metric is added by adding files and entries; nothing here names one.

A run: set-up (the graph, the program's operands, warm-up units), then a
closed loop of units for ``--seconds``: one caller, each unit started when
the previous one has ended in a synchronisation.  A unit that raises (a
poisoned product's ``check()``, an error of the program) is a failed unit.
The window ends at the end of the last unit that started before the time
ran out.  Then the program's state is freed, the plain reference
(``spbench/reference.py``) computes the products again from the same COO
arrays, and the last unit's products are judged whole.  With ``--trace 1``
the first ``TRACE_SECONDS`` of the window run under ``torch.profiler`` and
the line carries the per-layer metrics and the breakdown instead of the
end-to-end metrics.

The last line of standard output is one JSON object; the numbers compared
for ``correct`` come last on standard error and under ``checks``.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from typing import List, Optional  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "sparsetpu")  # top-level names, compared whole
TRACE_SECONDS = 5.0
WARMUP_UNITS = 2


def forbidden_modules(names=None) -> List[str]:
    """Top-level names of loaded modules that the run may not load."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def load_module(root: str, kind: str, name: str):
    """``<root>/spbench/<kind>/<name>.py``, loaded by its path."""
    path = os.path.join(root, "spbench", kind, name + ".py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind[:-1]} {name!r}: {path} does not exist")
    safe = "".join(c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(f"spbench_{kind}_{safe}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_spec(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_files(root: str, spec: dict, workload: str):
    """A cell's configuration and traffic mix, read from their files."""
    cell = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    config = next(c for c in spec["configs"] if c["name"] == cell["config"])
    with open(os.path.join(root, config["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(root, "spbench", "traffic", cell["traffic"] + ".json")) as f:
        return cfg, json.load(f)


def graph(root: str, cfg: dict, seed: int):
    """The configuration's graph for ``seed``, as COO arrays."""
    return load_module(root, "generators", cfg["generator"]).build(cfg, seed)


def cell_metrics(spec: dict, cell: str, trace: bool) -> List[str]:
    """Names of the metrics this cell reports: every end-to-end metric
    without ``--trace``, with it the per-layer metrics that list the cell."""
    if not trace:
        return [m["name"] for m in spec["end_to_end"]]
    return [m["name"] for m in spec["per_layer"] if cell in m["workloads"]]


@dataclasses.dataclass
class Context:
    """What a unit kind is given: the configuration, the traffic's
    parameters, the graph as COO arrays, the device."""

    root: str
    config: dict
    traffic: dict
    coo: tuple
    device: object

    def load(self, kind: str, name: str):
        return load_module(self.root, kind, name)


@dataclasses.dataclass
class Reading:
    """What the metric readers read."""

    setup_s: float
    unit_seconds: List[float]
    completed: int
    window_s: float
    window_peak_bytes: Optional[int]
    unit_nnz: int
    trace: object = None


def run_cell(root: str, workload: str, seed: int, seconds: float, trace: bool, device,
             t0: float, log=sys.stderr, spec: Optional[dict] = None) -> dict:
    """One run of a cell on ``device`` (the card, or the CPU in tests).
    Returns the result line's object."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from spbench import bounds, reference
    from spbench import trace as trace_mod

    spec = spec or load_spec(root)
    cfg, traffic = cell_files(root, spec, workload)
    device = torch.device(device)
    on_cuda = device.type == "cuda"

    def sync():
        if on_cuda:
            torch.cuda.synchronize(device)

    def say(msg):
        print(f"[{time.perf_counter() - t0:8.2f}s] {msg}", file=log, flush=True)

    say("imports done")
    coo = graph(root, cfg, seed)
    say("graph built")
    ctx = Context(root, cfg, traffic, coo, device)
    unit = load_module(root, "units", traffic["unit"]).setup(ctx)
    say(f"set-up: n={coo[3]} nnz(A)={len(coo[0])} {unit.info}")
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_cuda else [])
    for i in range(WARMUP_UNITS):
        if trace and i == 0:  # a process's first profiler session costs seconds
            with profile(activities=activities):
                unit.run()
                sync()
        else:
            unit.run()
            sync()
    say("warm-up done")
    setup_peak = torch.cuda.max_memory_allocated(device) if on_cuda else None
    if on_cuda:
        torch.cuda.reset_peak_memory_stats(device)

    unit_seconds, failures = [], []
    completed = traced_completed = 0
    prof = profile(activities=activities) if trace else None
    setup_s = time.perf_counter() - t0
    start = time.perf_counter()
    if prof is not None:
        prof.start()
    end = start
    while True:
        u0 = time.perf_counter()
        if u0 - start >= seconds and unit_seconds:
            break
        ok = True
        try:
            with record_function(trace_mod.UNIT_SPAN):
                unit.run()
                sync()
        except Exception as e:  # a failed unit: counted, and the loop goes on
            ok = False
            if len(failures) < 3:
                failures.append(f"{type(e).__name__}: {str(e)[:300]}")
        end = time.perf_counter()
        unit_seconds.append(end - u0)
        completed += ok
        if prof is not None:
            traced_completed += ok
            if end - start >= TRACE_SECONDS:
                prof.stop()
                traced, prof = (prof, traced_completed), None
    if prof is not None:
        prof.stop()
        traced = (prof, traced_completed)
    window_s = end - start
    sync()
    window_peak = torch.cuda.max_memory_allocated(device) if on_cuda else None
    say(f"window: {len(unit_seconds)} units in {window_s:.3f} s, {len(failures)} failures "
        f"shown {failures}")

    judged = unit.outputs()
    expected = list(unit.judged)
    products, info = list(unit.products), dict(unit.info)
    unit.release()
    del unit, ctx
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()

    rows, cols, vals, n = coo
    ref = {1: reference.from_coo(rows, cols, vals, n, device)}
    for l, r in products:
        if l + r not in ref:
            ref[l + r] = reference.matmul(ref[l], ref[r])
    wrong = {f"A^{k}": ref[k].nnz + 1 if judged.get(k) is None
             else reference.wrong_entries(ref[k], judged[k]) for k in expected}
    info["wrong_by_power"] = wrong
    checks = {"wrong_entries": {"value": sum(wrong.values()), "limit": 0},
              "failed_units": {"value": len(unit_seconds) - completed, "limit": 0}}
    nnz = {k: m.nnz for k, m in ref.items()}
    info["max_value"] = {f"A^{k}": m.max_value() for k, m in ref.items() if k > 1}
    del judged, ref
    say("reference done")

    unit_nnz = sum(nnz[l + r] for l, r in products)
    ms = sorted(1e3 * t for t in unit_seconds)
    half = len(unit_seconds) // 2
    info["unit_ms"] = {"min": ms[0], "median": ms[len(ms) // 2], "max": ms[-1],
                       "first_half_mean": 1e3 * sum(unit_seconds[:half]) / max(half, 1),
                       "second_half_mean": 1e3 * sum(unit_seconds[half:]) / max(len(ms) - half, 1)}
    reading = Reading(setup_s, unit_seconds, completed, window_s, window_peak, unit_nnz)
    if trace:
        reading.trace = trace_mod.from_profiler(traced[0], traced[1],
                                                bounds.unit_bytes(products, nnz, n))
    metrics = {}
    for m in cell_metrics(spec, workload, trace):
        value = load_module(root, "metrics", m).read(reading)
        if value is not None:
            unit_of = next(x["unit"] for x in spec["end_to_end"] + spec["per_layer"]
                           if x["name"] == m)
            metrics[m] = {"value": value, "unit": unit_of}
    correct = bool(unit_seconds) and all(c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if on_cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if on_cuda else device.type,
           "count": 1,
           "memory_peak_bytes": int(max(setup_peak, window_peak)) if on_cuda else 0}
    result = {"correct": correct, "attempted": len(unit_seconds),
              "failed": len(unit_seconds) - completed, "metrics": metrics, "device": dev}
    if trace:
        t = reading.trace
        dev["busy_s"] = t.busy_us() / 1e6
        dev["window_s"] = t.span_us() / 1e6
        result["breakdown"] = trace_mod.breakdown(t)
    info.update(seed=seed, pairs=products, judged=expected, n=n,
                nnz={f"A^{k}": v for k, v in nnz.items()}, unit_nnz=unit_nnz,
                unit_bytes=bounds.unit_bytes(products, nnz, n))
    result["info"] = info
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # build and kernel caches at fixed paths inside the checkout
    cache = os.path.join(ROOT, ".spbench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(cache, sub)
    import torch

    spec = load_spec(ROOT)
    cell = next((w for w in spec["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} present",
              file=sys.stderr)
        return 2
    result = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                      "cuda:0", T0, spec=spec)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}: the benchmark may load neither JAX nor the JAX "
              "package", file=sys.stderr)
        return 3
    emit(result, sys.stdout, sys.stderr)
    return 0


def emit(result: dict, out, err) -> None:
    """The run's last lines: its ``info`` (route, counts, largest values) and
    every number compared beside its limit on ``err``, then the result line
    on ``out``, its ``checks`` last."""
    result = dict(result)
    print("info " + json.dumps(result.pop("info")), file=err)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=err, flush=True)
    result["checks"] = result.pop("checks")
    print(json.dumps(result), file=out, flush=True)


if __name__ == "__main__":
    sys.exit(main())
