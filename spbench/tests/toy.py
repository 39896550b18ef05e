"""A copy of the benchmark with toy configurations, for the CPU tests.

``make_root(dest)`` copies ``spbench/`` into ``dest`` and writes a
``BENCHMARK.json`` whose cells are the real cells with their
configurations swapped for small graphs of the same generators, added as
data files only.
"""

from __future__ import annotations

import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
SPBENCH = os.path.dirname(HERE)
REPO = os.path.dirname(SPBENCH)

TOY_CONFIGS = {
    "torus30": ("toy_torus", {"generator": "moore_torus", "dims": [6, 6, 6],
                              "density": 3 / 26, "thin_seed": 42, "semiring": "u64"}),
}


def real_spec() -> dict:
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def make_root(dest: str) -> str:
    """A benchmark root at ``dest`` holding the toy cells; returns it."""
    shutil.copytree(SPBENCH, os.path.join(dest, "spbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = real_spec()
    configs = []
    for c in spec["configs"]:
        name, cfg = TOY_CONFIGS[c["name"]]
        path = f"spbench/configs/{name}.json"
        with open(os.path.join(dest, path), "w") as f:
            json.dump(cfg, f)
        configs.append({**c, "name": name, "file": path})
    spec["configs"] = configs
    for w in spec["workloads"]:
        w["config"] = TOY_CONFIGS[w["config"]][0]
    write_spec(dest, spec)
    return dest


def write_spec(root: str, spec: dict) -> None:
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f, indent=1)
