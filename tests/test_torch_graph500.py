"""Graph 500's Kronecker graph: the port's generator against the benchmark's
frozen copy, the program's products on it against the plain reference
(``spbench/reference.py``), the tiled route's spans and counter, and the
``graph500_s17.a2_auto`` cell at a toy size on the CPU.

Tolerances: none.  The generators are compared bit for bit and every
product is exact (u64 values far below 2^24), so each comparison is
equality.
"""

import ast
import dataclasses
import io
import json
import os
import shutil
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from spbench import reference, run
from spbench.generators import graph500_kronecker as frozen
from spbench.trace import Trace
from sparsetpu_torch import obs
from sparsetpu_torch.csr import SparseCSR
from sparsetpu_torch.graphs import generate
from sparsetpu_torch.kernels import spmm as kspmm
from sparsetpu_torch.ops import denseacc
from sparsetpu_torch.ops import spgemm as ops_spgemm
from sparsetpu_torch.semiring import U64

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPBENCH = os.path.join(REPO, "spbench")
CELL = "graph500_s17.a2_auto"
INITIATOR = [0.57, 0.19, 0.19, 0.05]
SEEDS = (0, 7, 2**31 + 5)
P = obs.PREFIX


def _dense(coo):
    r, c, v, n = coo
    d = np.zeros((n, n), np.int64)
    d[r, c] = v.astype(np.int64)
    return d


# -- the generator ------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("scale", [8, 9, 10, 11, 12])
def test_the_ports_generator_is_the_frozen_copy_bit_for_bit(scale, seed):
    got = generate.graph500_kronecker(scale, 16, draw_seed=1, perm_seed=seed)
    want = frozen.kronecker(scale, 16, INITIATOR, 1, seed)
    assert got[3] == want[3] == 2**scale
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("scale, draw_seed", [(8, 1), (10, 1), (10, 2), (12, 3)])
def test_the_graph_has_the_specs_properties(scale, draw_seed):
    """n = 2^SCALE, undirected, no self-loops, values 1, and the initiator's
    skew: a largest degree far above the mean."""
    rows, cols, vals, n = generate.graph500_kronecker(scale, 16, draw_seed, perm_seed=5)
    assert n == 2**scale and rows.dtype == cols.dtype == np.int32 and vals.dtype == np.uint64
    assert np.all(vals == 1) and not np.any(rows == cols)
    key = rows.astype(np.int64) * n + cols
    assert np.all(np.diff(key) > 0)  # sorted by (row, col), no duplicates
    assert np.array_equal(np.sort(cols.astype(np.int64) * n + rows), key)  # symmetric
    deg = np.bincount(rows, minlength=n)
    # an Erdos-Renyi graph of this mean degree (17-24) peaks near twice it
    assert deg.max() > 5 * deg.mean()
    assert len(rows) <= 2 * 16 * n


def test_the_run_seed_only_renames_the_vertices():
    """Undoing each seed's vertex permutation gives one matrix: every seed
    does the same work."""
    base = None
    for seed in SEEDS:
        d = _dense(frozen.kronecker(8, 16, INITIATOR, 1, seed))
        perm = np.random.default_rng(seed).permutation(256)
        d = d[np.ix_(perm, perm)]
        if base is None:
            base = d
        assert np.array_equal(d, base)
    assert not np.array_equal(_dense(frozen.kronecker(8, 16, INITIATOR, 2, 0)),
                              _dense(frozen.kronecker(8, 16, INITIATOR, 1, 0)))


@pytest.mark.parametrize("module", ["generators/graph500_kronecker.py",
                                    "metrics/tiled_roofline_pct.py",
                                    "metrics/panel_pack_share_pct.py"])
def test_the_new_benchmark_files_import_nothing_of_the_program(module):
    with open(os.path.join(SPBENCH, module)) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    assert not [n for n in names if n.split(".")[0] in ("sparsetpu_torch", "sparsetpu", "jax")]


# -- the program's products against the plain reference -------------------------

@pytest.fixture(scope="module")
def s10():
    """The SCALE-10 graph (largest degree 470) as the program's CSR, and the
    reference's A^2."""
    rows, cols, vals, n = generate.graph500_kronecker(10, 16, draw_seed=1, perm_seed=3)
    a = SparseCSR.from_coo_host(rows, cols, vals, n, sr=U64, device="cpu")
    ref = reference.from_coo(rows, cols, vals, n, "cpu")
    return a, reference.matmul(ref, ref), (rows, cols, n)


def _same_as_reference(c: SparseCSR, ref) -> None:
    row_ptr, col, vals = c.to_numpy()
    assert int(c.nnz) == ref.nnz
    assert np.array_equal(row_ptr.astype(np.int64), ref.row_ptr.numpy())
    assert np.array_equal(col.astype(np.int64), ref.col.numpy())
    assert np.array_equal(vals.astype(np.int64), ref.val.numpy())


@pytest.mark.parametrize("route", ["auto", "denseacc_tiled", "esc", "colchunk", "rowcat"])
def test_a_squared_equals_the_reference_on_every_route(s10, route):
    a, ref, _ = s10
    if route == "denseacc_tiled":  # 4 panels, the last one 124 columns wide
        c = denseacc.spgemm_dense_acc_tiled(a, a, panel_cols=300).check()
    else:
        c = ops_spgemm.spgemm_auto(a, a, kernel=route)
    _same_as_reference(c, ref)


def test_plan_dense_acc_counts_the_distinct_columns_and_launches_carry_bytes(s10):
    a, _, (rows, cols, n) = s10
    with profile(activities=[ProfilerActivity.CPU]):
        op = denseacc.plan_dense_acc(a)
    distinct = len(set(cols.tolist()))
    assert op.distinct_cols == distinct
    nnz, m = len(cols), 2048
    # row offsets and columns (4 B each), f32 values, each referenced P row
    # and each C row once
    assert kspmm.launch_bytes(op, m) == 4 * (n + 1) + 4 * nnz + 4 * nnz + 4 * distinct * m \
        + 4 * n * m


def test_an_untraced_plan_counts_no_columns(s10):
    op = denseacc.plan_dense_acc(s10[0])
    assert op.distinct_cols is None and kspmm.launch_bytes(op, 2048) is None


def test_a_tiled_product_shows_its_sweeps_and_counts_its_panels(s10):
    a, ref, _ = s10
    before = denseacc.PANELS
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        c = denseacc.spgemm_dense_acc_tiled(a, a, panel_cols=256)  # 4 panels
    finally:
        prof.stop()
    assert denseacc.PANELS - before == 2 * 4
    _same_as_reference(c.check(), ref)
    spans = sorted(((e.name[len(P):], e.time_range.start, e.time_range.end)
                    for e in prof.events() if e.name.startswith(P)), key=lambda s: s[1])

    def one(name):
        (s,) = [s for s in spans if s[0] == name]
        return s

    def inside(inner, outer):
        return outer[1] <= inner[1] and inner[2] <= outer[2]

    product, count, pack = one("product/denseacc_tiled"), one("tiled/count"), one("tiled/pack")
    assert inside(count, product) and inside(pack, product) and count[2] <= pack[1]
    assert inside(one("sync/distinct_cols"), product) and one("sync/distinct_cols")[2] <= count[1]
    assert inside(one("sync/panel_counts"), count)


# -- the cell at a toy size ----------------------------------------------------------

@pytest.fixture(scope="module")
def toy_root(tmp_path_factory):
    """A benchmark root holding the new cell on the SCALE-9 graph: the
    harness's files as they are, the toy configuration added as data."""
    root = str(tmp_path_factory.mktemp("g500"))
    shutil.copytree(SPBENCH, os.path.join(root, "spbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        spec = json.load(f)
    with open(os.path.join(SPBENCH, "configs", "graph500_s17.json")) as f:
        cfg = {**json.load(f), "scale": 9, "n": 512}
    path = "spbench/configs/toy_graph500.json"
    with open(os.path.join(root, path), "w") as f:
        json.dump(cfg, f)
    config = next(c for c in spec["configs"] if c["name"] == "graph500_s17")
    spec["configs"] = [{**config, "name": "toy_graph500", "file": path}]
    spec["workloads"] = [{**w, "config": "toy_graph500"} for w in spec["workloads"]
                         if w["name"] == CELL]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f, indent=1)
    return root


def _run(root, trace=False):
    return run.run_cell(root, CELL, 2**31 + 77, 0.05, trace, "cpu", time.perf_counter(),
                        log=io.StringIO())


@pytest.mark.parametrize("trace", [False, True])
def test_the_toy_cell_runs_and_ends_correct(toy_root, trace):
    r = _run(toy_root, trace)
    assert r["correct"] is True and r["failed"] == 0
    assert r["checks"]["wrong_entries"]["value"] == 0
    info = r["info"]
    assert info["nnz"]["A^2"] > info["nnz"]["A^1"] and info["unit_nnz"] == info["nnz"]["A^2"]
    assert set(info["route"]) == {"A^2"} and info["panels_per_unit"] >= 0
    assert info["dense_acc_launches_per_unit"] == 0  # no CUDA launch on the CPU
    if not trace:
        assert set(r["metrics"]) >= {"nnz_per_s", "unit_p95_ms", "setup_s"}


def test_one_wrong_entry_of_a_squared_makes_the_toy_cell_incorrect(toy_root, monkeypatch):
    auto = ops_spgemm.spgemm_auto

    def one_wrong(a, b, **kw):
        c = auto(a, b, **kw)
        lo = c.values[0].clone()
        lo[int(c.nnz) // 2] += 1
        return dataclasses.replace(c, values=(lo,) + tuple(c.values[1:]))

    monkeypatch.setattr(ops_spgemm, "spgemm_auto", one_wrong)
    r = _run(toy_root)
    # the judge counts the altered entry as one missing and one extra
    assert r["correct"] is False and r["checks"]["wrong_entries"]["value"] == 2


# -- the two readers on a made-up trace ---------------------------------------------

SPMM = "void (anonymous namespace)::spmm_dense_acc_kernel<float4, 2>(int const*)"
BYTES = 3_350_000  # 1 us at 3.35 TB/s


def _trace(launch_names=(f"kernel/spmm_dense_acc bytes={BYTES}",) * 3, product=(10, 95)):
    """One unit (0-100 us); three launches at 20, 40 and 92 us, inside the
    tiled product span ``product`` (None: no such span); 10 us of the
    kernel, 8 us of other device work."""
    host = [(P + name, s, s + 1) for name, s in zip(launch_names, (20, 40, 92))]
    if product:
        host.append((P + "product/denseacc_tiled",) + product)
    device = [(SPMM, 30, 34), (SPMM, 50, 54), ("fill", 60, 64), ("nonzero", 64, 68),
              (SPMM, 95, 97)]
    return Trace(device, host, [(0.0, 100.0)], completed_units=1)


def _read(metric, t):
    reading = run.Reading(1.0, [1.0], 1, 1.0, None, 1, trace=t)
    return run.load_module(REPO, "metrics", metric).read(reading)


def test_the_readers_give_their_numbers_on_a_made_up_trace():
    t = _trace()
    # three launches: 3 us at the bound over 10 us of the kernel
    assert _read("tiled_roofline_pct", t) == pytest.approx(30.0)
    # 18 us busy, 10 of them the kernel
    assert _read("panel_pack_share_pct", t) == pytest.approx(100.0 * 8 / 18)


@pytest.mark.parametrize("metric, trace", [
    ("tiled_roofline_pct", _trace(product=None)),
    ("tiled_roofline_pct", _trace(("kernel/spmm_dense_acc",) * 3)),  # no bytes counted
    ("tiled_roofline_pct", _trace(product=(10, 90))),  # a launch outside the tiled route
    ("panel_pack_share_pct", _trace(product=None)),
    ("panel_pack_share_pct", None),
])
def test_the_readers_read_nothing_where_there_is_nothing_to_read(metric, trace):
    assert _read(metric, trace) is None
