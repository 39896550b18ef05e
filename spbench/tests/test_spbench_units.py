"""Every cell's unit kind at a toy size on the port's CPU path, judged by
the reference; the result line; a cell, a configuration and a per-layer
metric added as files and entries alone; no JAX."""

import io
import json
import os
import subprocess
import sys
import time

import pytest

from spbench import run
from spbench.tests import toy

CELLS = [w["name"] for w in toy.real_spec()["workloads"]]
CONTRACT_KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return toy.make_root(str(tmp_path_factory.mktemp("toy")))


def _run(root, cell, seed=2**31 + 9, seconds=0.1, trace=False, spec=None):
    return run.run_cell(root, cell, seed, seconds, trace, "cpu", time.perf_counter(),
                        log=io.StringIO(), spec=spec)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_matches_the_reference(root, cell):
    r = _run(root, cell)
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert r["checks"]["wrong_entries"] == {"value": 0, "limit": 0}
    assert set(r["info"]["wrong_by_power"]) == {f"A^{k}" for k in r["info"]["judged"]}
    # peak_mem_gib is the card's: a CPU run leaves it out
    assert set(r["metrics"]) == {"nnz_per_s", "unit_p95_ms", "setup_s"}
    for m in r["metrics"].values():
        assert m["value"] > 0


@pytest.mark.parametrize("trace", [False, True])
def test_last_line_has_the_contracts_keys(root, trace):
    r = _run(root, "torus30.chain7_auto", trace=trace)
    out, err = io.StringIO(), io.StringIO()
    run.emit(r, out, err)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line) == CONTRACT_KEYS[:5] + (["breakdown"] if trace else []) + ["checks"]
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    last = err.getvalue().strip().splitlines()[-2:]
    assert last == ["check wrong_entries 0 limit 0", "check failed_units 0 limit 0"]


def test_a_cell_config_and_metric_added_as_data_alone_run(tmp_path):
    root = toy.make_root(str(tmp_path))
    sp = os.path.join(root, "spbench")
    with open(os.path.join(sp, "configs", "toy_torus8.json"), "w") as f:
        json.dump({"generator": "moore_torus", "dims": [8, 8, 8], "density": 0.2,
                   "thin_seed": 1, "semiring": "u64"}, f)
    with open(os.path.join(sp, "traffic", "a3_esc.json"), "w") as f:
        json.dump({"unit": "spgemm_esc", "products": [[1, 1], [2, 1]]}, f)
    with open(os.path.join(sp, "metrics", "units_traced.py"), "w") as f:
        f.write("def read(r):\n    return float(len(r.trace.units)) if r.trace else None\n")
    spec = json.load(open(os.path.join(root, "BENCHMARK.json")))
    spec["configs"].append({"name": "toy_torus8", "source": "toy", "reduced": [], "why": "toy",
                            "file": "spbench/configs/toy_torus8.json"})
    spec["workloads"].append({"name": "toy_torus8.a3_esc", "config": "toy_torus8",
                              "traffic": "a3_esc", "chips": 1, "why": "toy"})
    spec["per_layer"].append({"name": "units_traced", "unit": "units", "better": "higher",
                              "source": "program_span", "layer": "Device", "moves": "nnz_per_s",
                              "workloads": ["toy_torus8.a3_esc"]})
    toy.write_spec(root, spec)
    plain = _run(root, "toy_torus8.a3_esc", spec=spec)
    assert plain["correct"] and plain["info"]["judged"] == [2, 3]
    traced = _run(root, "toy_torus8.a3_esc", trace=True, spec=spec)
    assert traced["correct"] and traced["metrics"]["units_traced"]["value"] >= 1


def test_forbidden_modules_compares_whole_top_level_names():
    names = ["jax", "jax.numpy", "sparsetpu.ops.spgemm", "sparsetpu_torch", "sparsetpu_torch.csr",
             "jaxlib_extra", "flax.linen", "numpy"]
    assert run.forbidden_modules(names) == ["flax", "jax", "sparsetpu"]
    assert run.forbidden_modules(["sparsetpu_torch", "spbench"]) == []


def test_a_run_loads_neither_jax_nor_the_jax_package(root):
    code = ("import io, json, sys, time\n"
            "from spbench import run\n"
            f"r = run.run_cell({root!r}, 'torus30.chain7_esc', 3, 0.05, True, 'cpu', "
            "time.perf_counter(), log=io.StringIO())\n"
            "print(json.dumps([r['correct'], run.forbidden_modules()]))\n")
    env = {**os.environ, "PYTHONPATH": toy.REPO}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         cwd=toy.REPO, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [True, []]


def test_the_cli_refuses_without_a_card(tmp_path):
    """No card: exit code 2 and no result line."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "-m", "spbench.run", "--workload", CELLS[0], "--seed",
                          "1", "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                         cwd=toy.REPO, timeout=300)
    assert out.returncode == 2 and out.stdout == ""


def test_the_cli_fails_without_the_program(tmp_path):
    """A directory holding only BENCHMARK.json and spbench/: no result."""
    import shutil
    shutil.copy(os.path.join(toy.REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(toy.SPBENCH, tmp_path / "spbench")
    out = subprocess.run([sys.executable, "-m", "spbench.run", "--workload", CELLS[0], "--seed",
                          "1", "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                         cwd=tmp_path, timeout=300, env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode != 0 and out.stdout == ""


def test_a_route_without_a_driver_fails_by_name(root, monkeypatch):
    from sparsetpu_torch.ops import hybrid
    monkeypatch.setattr(hybrid, "choose_strategy", lambda a, steps=1: "band")
    with pytest.raises(RuntimeError, match="'band'"):
        _run(root, "torus30.chain7_auto")
