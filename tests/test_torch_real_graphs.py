"""The port's real-graph study (``sparsetpu_torch.bench.real_graphs``)
against the JAX package's (``sparsetpu.bench.real_graphs``), on the CPU.

- ``load_or_synthesize("cora", ...)``: the same label and COO, bit for bit,
  and RCM's permutation of it bit for bit;
- ``bench_chain``, ``bench_algos`` and ``bench_band_hybrid`` on one seeded
  300-node power-law graph, under JAX's guards: every CSV column but
  ``seconds`` equal to JAX's rows, and the structure report's lines but the
  RCM time;
- the chain's routes under JAX's guards equal the ``algo`` column of the
  TPU's ``reports/real_graphs_r5.csv`` at its product counts; the card's
  guards change only the TPU's DNF row of ogbn A^3;
- the DNF discipline: out of memory becomes a row, a kernel failure
  propagates; ``host_diameter`` against all-pairs BFS.
"""

import csv
import os

import numpy as np
import pytest
import torch

from sparsetpu import SparseCSR as JCSR, U64 as JU64
from sparsetpu.bench import real_graphs as jrg
from sparsetpu.graphs import algos as jalgos

from sparsetpu_torch import SparseCSR, U64
from sparsetpu_torch.bench import real_graphs as rg
from sparsetpu_torch.graphs import algos, datasets, patterns

R5 = os.path.join(os.path.dirname(__file__), "..", "reports", "real_graphs_r5.csv")


def _strip_seconds(rows):
    """CSV rows without the seconds column (index 6)."""
    return [r.split(",")[:6] + r.split(",")[7:] for r in rows]


@pytest.fixture(scope="module")
def small():
    coo = datasets.power_law(300, 2, seed=5)
    r, c, v, n = coo
    j = JCSR.from_coo_host(r, c, v, n, sr=JU64)
    a = SparseCSR.from_coo_host(r, c, v, n, sr=U64, device="cpu")
    return coo, j, a


@pytest.fixture(scope="module")
def jax_rows(small):
    coo, j, _ = small
    return dict(chain=jrg.bench_chain("pl300", j, 4, iters=1, verbose=False),
                algos=jrg.bench_algos("pl300", j, verbose=False),
                hybrid=jrg.bench_band_hybrid("pl300", j, iters=1, verbose=False),
                report=jrg.structure_report("pl300", coo, j))


def test_cora_substitute_and_its_rcm_match_jax():
    label, coo = rg.load_or_synthesize("cora", 2708, 10556)
    jlabel, jcoo = jrg.load_or_synthesize("cora", 2708, 10556)
    assert label == jlabel == "cora_pl"
    for g, w in zip(coo[:3], jcoo[:3]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert coo[3] == jcoo[3] == 2708 and len(coo[0]) == 10530
    r, c, v, n = coo
    a = SparseCSR.from_coo_host(r, c, v, n, sr=U64, device="cpu")
    _, perm = algos.rcm(a)
    _, jperm = jalgos.rcm(JCSR.from_coo_host(r, c, v, n, sr=JU64))
    np.testing.assert_array_equal(perm, jperm)


def test_chain_rows_match_jax(small, jax_rows):
    _, _, a = small
    got = rg.bench_chain("pl300", a, 4, iters=1, verbose=False, guards=rg.JAX_GUARDS)
    assert _strip_seconds(got) == _strip_seconds(jax_rows["chain"])
    assert [r.split(",")[7] for r in got] == ["slab"] * 3


def test_algos_rows_match_jax(small, jax_rows):
    _, _, a = small
    details = []
    got = rg.bench_algos("pl300", a, verbose=False, guards=rg.JAX_GUARDS, details=details)
    assert _strip_seconds(got) == _strip_seconds(jax_rows["algos"])
    assert [d["algo"] for d in details] == ["reachability", "diameter"]
    # 300 nodes in a 384 frame: reachability's k - 1 = 6 products
    assert details[0]["int8_ops"] == 6 * 2 * 384 ** 3
    # the card's guards change nothing here: the dense engine takes both
    card = rg.bench_algos("pl300", a, verbose=False)
    assert _strip_seconds(card) == _strip_seconds(got)


def test_band_hybrid_rows_match_jax(small, jax_rows):
    _, _, a = small
    got = rg.bench_band_hybrid("pl300", a, iters=1, verbose=False)
    assert _strip_seconds(got) == _strip_seconds(jax_rows["hybrid"])
    assert got[0].split(",")[3].startswith("hybrid@")


def test_structure_report_matches_jax(small, jax_rows):
    coo, _, a = small
    got = rg.structure_report("pl300", coo, a)
    want = jax_rows["report"]
    assert got[:-1] == want[:-1]
    # the RCM line differs in its time only
    cut = lambda line: line.split(" (")[0] + line.split(" ms)")[1]
    assert cut(got[-1]) == cut(want[-1])


def _r5_rows():
    """The chain rows of the TPU run, one per (graph, step) (nell ran twice)."""
    with open(R5) as f:
        rows = {(r["graph"], r["step"]): r for r in csv.DictReader(f) if r["step"].isdigit()}
    return list(rows.values())


def test_routes_under_jax_guards_match_the_tpu_run():
    """Every chain row of reports/real_graphs_r5.csv: route_step under
    JAX_GUARDS at the row's (n, nnz(A), products) gives its algo column (its
    DNF label where the TPU wrote one)."""
    rows = _r5_rows()
    assert len(rows) == 8
    for r in rows:
        want = r["algo"] if r["algo"] != "auto" else r["nnz_out"]
        got = rg.route_step(int(r["n"]), int(r["nnz_a"]), int(r["flops"]), rg.JAX_GUARDS)
        assert got == want, r


def test_card_guards_attempt_ogbn_a3_and_keep_the_other_routes():
    for r in _r5_rows():
        args = int(r["n"]), int(r["nnz_a"]), int(r["flops"])
        card, tpu = rg.route_step(*args, rg.CARD_GUARDS), rg.route_step(*args, rg.JAX_GUARDS)
        if (r["graph"], r["step"]) == ("ogbn_arxiv_pl", "3"):
            assert (tpu, card) == ("DNF_budget", "denseacc_tiled")
        else:
            assert card == tpu
    # nell A^4 would not fit the untiled frames even at the card's budget
    assert rg.route_step(65755, 251536, 403647080, rg.CARD_GUARDS) == "denseacc_tiled"


@pytest.mark.parametrize("n, nnz_a, panels", [(65755, 251536, 13), (169343, 1166243, 83)])
def test_gather_guard_counts_the_panels_the_tiled_route_runs(n, nnz_a, panels):
    """The tiled route's gathers are priced at the panel width spgemm_auto
    runs (dense_acc_panel_cols at the router's budget: 5,120 columns at
    nell, 2,048 at ogbn-arxiv), not at the untiled frames' budget: a gather
    budget of exactly 2 x nnz(A) x panels admits the route, one less refuses it."""
    from sparsetpu_torch.ops.spgemm import dense_acc_panel_cols

    assert -(-n // dense_acc_panel_cols(n)) == panels
    flops = 1 << 29  # past colchunk's cap, within the output budget
    for budget, want in ((2 * nnz_a * panels, "denseacc_tiled"),
                         (2 * nnz_a * panels - 1, "DNF_budget")):
        guards = rg.dataclasses.replace(rg.CARD_GUARDS, max_dma_issues=budget)
        assert rg.route_step(n, nnz_a, flops, guards) == want


def test_out_of_memory_becomes_a_dnf_row_and_a_kernel_failure_propagates(small, monkeypatch):
    _, _, a = small
    calls = []

    def oom(*args, **kwargs):
        calls.append(1)
        raise torch.cuda.OutOfMemoryError("out of memory (test)")

    monkeypatch.setattr(rg, "spgemm_auto", oom)
    rows = rg.bench_chain("pl300", a, 4, iters=1, verbose=False)
    assert rows == ["pl300,300,1168,2,DNF_OutOfMemoryError,10098,0,slab"]
    assert len(calls) == 1  # never run again outside the handler

    def kernel_failure(*args, **kwargs):
        raise RuntimeError("spmm_dense_acc launch failed: test")

    monkeypatch.setattr(rg, "spgemm_auto", kernel_failure)
    with pytest.raises(RuntimeError, match="launch failed"):
        rg.bench_chain("pl300", a, 4, iters=1, verbose=False)


def test_closure_guard_writes_dnf_rows_on_the_sparse_route(small, monkeypatch):
    """Where the frame does not fit and sum |C|^2 entries pass the card's
    budget, reachability and the diameter are DNF_closure_budget rows."""
    _, _, a = small
    assert rg.closure_bound(a) == 300 * 300
    monkeypatch.setattr(patterns, "fits", lambda n: False)
    # 90,000 entries of 20 B: past a budget of 1e6 B, within the card's 40e9
    assert rg.bench_algos("pl300", a, verbose=False)[0].split(",")[4] == "90000"
    tight = rg.dataclasses.replace(rg.CARD_GUARDS, out_budget_bytes=1e6)
    rows = rg.bench_algos("pl300", a, verbose=False, guards=tight)
    assert [r.split(",")[3:6] for r in rows] == [
        ["reachability", "DNF_closure_budget", "90000"],
        ["diameter", "DNF_closure_budget", "90000"]]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_diameter_is_exact(seed):
    """Against all-pairs BFS on connected graphs: a long ring (eccentricity
    all alike) with power-law chords, and two of the chords alone joined by
    a path."""
    import scipy.sparse as ssp
    from scipy.sparse.csgraph import shortest_path

    from sparsetpu_torch.graphs import generate

    n = 120 + 40 * seed
    pr, pc, _, _ = datasets.power_law(n, 1 + seed, seed=seed)
    ring = [(i, i + 1) for i in range(n - 1)] + ([(n - 1, 0)] if seed == 2 else [])
    chords = list(zip(pr.tolist(), pc.tolist()))[::7 if seed else 1]
    coo = generate.from_edges(n, ring + chords, undirected=True)
    r, c, _, n = coo
    d = shortest_path(ssp.csr_matrix((np.ones(len(r)), (r, c)), shape=(n, n)),
                      unweighted=True)
    assert rg.host_diameter(coo) == int(d.max())


def test_main_writes_the_csv_on_the_cpu(tmp_path):
    out = tmp_path / "rg.csv"
    rg.main(["--graphs", "cora", "--max-power", "2", "--iters", "1", "--device", "cpu",
             "--out", str(out)])
    lines = out.read_text().strip().split("\n")
    assert lines[0] == rg.HEADER
    assert lines[1].split(",")[:6] == ["cora_pl", "2708", "10530", "2", "131360", "141154"]


def test_main_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rg.main(["--graphs", "cora"])
