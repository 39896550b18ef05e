"""``BENCHMARK.json`` keeps to the benchmark contract, and every file a cell
names is there and parses."""

import json
import os
import re

import pytest

from spbench import run
from spbench.tests import toy

SPEC = toy.real_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                         "per_layer"}
    assert SPEC["paths"] == ["spbench"]
    assert len(SPEC["command"]) <= 32 and all(_line(w) for w in SPEC["command"])
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    cells = len(SPEC["workloads"])
    full = 2 + 14 * 24  # runs of a full check once 24 cells exist
    assert full * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert 1 <= cells <= 24
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_configs():
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["name"] in used and c["reduced"] == []
        assert c["file"].startswith("spbench/")
        with open(os.path.join(toy.REPO, c["file"])) as f:
            cfg = json.load(f)
        assert os.path.exists(os.path.join(toy.SPBENCH, "generators", cfg["generator"] + ".py"))
        assert "assumed" in cfg and cfg["semiring"] == "u64"
    assert len({c["file"] for c in SPEC["configs"]}) == len(SPEC["configs"])


def test_workloads():
    names = [w["name"] for w in SPEC["workloads"]]
    assert len(set(names)) == len(names)
    pairs = {(w["config"], w["traffic"]) for w in SPEC["workloads"]}
    assert len(pairs) == len(names)
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] == 1
        with open(os.path.join(toy.SPBENCH, "traffic", w["traffic"] + ".json")) as f:
            traffic = json.load(f)
        assert os.path.exists(os.path.join(toy.SPBENCH, "units", traffic["unit"] + ".py"))


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"], ids=lambda m: m["name"])
def test_metric(metric):
    keys = {"name", "unit", "better", "source"}
    keys |= {"bound"} if "bound" in metric else {"layer", "moves", "workloads"}
    assert set(metric) == keys
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    reader = run.load_module(toy.REPO, "metrics", metric["name"])
    assert callable(reader.read)
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert _line(metric["layer"])
        assert metric["moves"] in {m["name"] for m in SPEC["end_to_end"]}
        assert set(metric["workloads"]) <= {w["name"] for w in SPEC["workloads"]}


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in SPEC["workloads"]:
        e2e = run.cell_metrics(SPEC, w["name"], False)
        assert e2e == [m["name"] for m in SPEC["end_to_end"]] and "setup_s" in e2e
        assert run.cell_metrics(SPEC, w["name"], True)
    assert [m["bound"] for m in SPEC["end_to_end"] if m["name"] == "setup_s"] == [0.25]


def test_files_under_paths_are_named_from_name_characters():
    for dirpath, _, files in os.walk(toy.SPBENCH):
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), toy.REPO)
            if "__pycache__" not in rel:
                assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


@pytest.mark.parametrize("module", ["reference.py", "bounds.py", "frozen.py", "trace.py",
                                    "generators/moore_torus.py"])
def test_the_yardstick_imports_nothing_of_the_program(module):
    """The reference, the bounds, the generators and the trace reading take
    nothing from the program."""
    import ast
    with open(os.path.join(toy.SPBENCH, module)) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    assert not [n for n in names if n.split(".")[0] in ("sparsetpu_torch", "sparsetpu", "jax")]

