"""The port's chain driver (sparsetpu_torch.bench.chain), router and oracle
loader against the JAX package, on the CPU at small sizes.

Tolerance: exact equality throughout (``assert_array_equal``, ``==``): chain
values are integers below 2^24 carried in f32, where every order of
summation is exact, and routes and oracle outputs are discrete.
"""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from sparsetpu import U64, SparseCSR
from sparsetpu import native as jnative
from sparsetpu.bench import chain as jchain
from sparsetpu.graphs import generate as jgen
from sparsetpu.kernels import bandplanes as jbp
from sparsetpu.ops import slab as jslab
from sparsetpu.ops.hybrid import choose_strategy as jax_choose_strategy

from sparsetpu_torch import native as tnative
from sparsetpu_torch.bench import chain as tchain
from sparsetpu_torch.csr import HostCSR
from sparsetpu_torch.interop import csr_from_jax_host, dense_from_row_planes
from sparsetpu_torch.kernels import bandmm, bandplanes
from sparsetpu_torch.ops.hybrid import choose_strategy


@pytest.fixture(scope="module")
def torus4():
    """The 4^3 thinned torus in both packages, and the oracle's A^2..A^4."""
    jh = jchain.build_torus_host(dims=(4, 4, 4))
    th = tchain.build_torus_host(dims=(4, 4, 4))
    stats, final = tchain.native_chain_stats_host(
        th.row_ptr, th.col_idx, th.vals, th.n_rows, 4)
    return jh, th, stats, final


@pytest.fixture(scope="module")
def pallas_final4(torus4):
    """A^4 of the 4^3 torus through the JAX package's Pallas chain (interpret
    mode), as a dense numpy array."""
    jh = torus4[0]
    planes = jchain.chain_final_pallas(jh.to_device(), max_step=4, rows_per_tile=8)
    return dense_from_row_planes(jax.device_get(planes), jh.n)


def test_port_torus_equals_jax_host_csr(torus4):
    jh, th, _, _ = torus4
    want = csr_from_jax_host(jh.row_ptr, jh.col_idx, jh.limbs, jh.nnz, jh.n, jh.n, "u64")
    np.testing.assert_array_equal(th.row_ptr, want.row_ptr)
    np.testing.assert_array_equal(th.col_idx, want.col_idx)
    np.testing.assert_array_equal(th.vals, want.vals)


def test_oracle_stats_match_jax(torus4):
    jh, _, stats, final = torus4
    want_stats, want_final = jchain.native_chain_stats_host(
        jh.row_ptr, jh.col_idx, jh.vals_u64(), jh.n, 4)
    assert stats == want_stats
    for got, want in zip(final, want_final):
        np.testing.assert_array_equal(got, want)


def test_oracle_spgemm_matches_jax_native():
    rows, cols, vals, n = jgen.random_graph(200, 900, seed=4)
    h = HostCSR.from_coo(rows, cols, vals, n)
    a = tnative.as_host_csr(h.row_ptr, h.col_idx, h.vals)
    got = tnative.spgemm(a, a, n)
    want = jnative.spgemm(jnative.as_host_csr(h.row_ptr, h.col_idx, h.vals),
                          jnative.as_host_csr(h.row_ptr, h.col_idx, h.vals), n)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert tnative.lib()._name.startswith(tnative.BUILD_DIR)


def test_chain_cpu_matches_oracle_and_pallas(torus4, pallas_final4):
    jh, th, stats, final = torus4
    results, p = tchain.run_chain_dense_acc(th, "cpu", max_step=4, iters=2,
                                            native_stats=stats, verbose=False)
    assert [(r.step, r.nnz, r.max_value) for r in results] == \
        [(s, nnz, float(mx)) for s, nnz, mx, _ in stats]
    # flops of A x P equal the oracle's P x A count on the symmetric torus
    assert [r.flops for r in results] == [s[3] for s in stats]
    assert all(r.seconds > 0 for r in results)
    tchain.verify_final_values(p, final, sample_rows=64)
    np.testing.assert_array_equal(p.numpy(), pallas_final4)
    csv = tchain.chain_csv(results)
    assert csv.count("\n") == 4  # header + A^2..A^4


def _assert_chain_matches(results, p, stats, final, want):
    assert [(r.step, r.nnz, r.max_value) for r in results] == \
        [(s, nnz, float(mx)) for s, nnz, mx, _ in stats]
    assert [r.flops for r in results] == [s[3] for s in stats]
    tchain.verify_final_values(p, final, sample_rows=64)
    np.testing.assert_array_equal(p.numpy(), want)


def test_foldband_chain_cpu_matches_oracle_and_pallas(torus4, pallas_final4):
    _, th, stats, final = torus4
    results, p_band, base, perm = tchain.run_chain_foldband(
        th, "cpu", (4, 4, 4), max_step=4, iters=2, native_stats=stats, verbose=False)
    np.testing.assert_array_equal(perm, jbp.fold_perm((4, 4, 4)))
    # the folded product, read in folded labels, is the folded A^4
    np.testing.assert_array_equal(
        bandplanes.band_to_dense(p_band, base, th.n_rows).numpy()[np.ix_(perm, perm)],
        pallas_final4)
    _assert_chain_matches(results, tchain.unfold_band(p_band, base, perm), stats, final,
                          pallas_final4)


def test_foldband_chain_on_a_narrow_band():
    """64 x 4 x 4 torus folded: the windows stay narrower than the row."""
    th = tchain.build_torus_host(dims=(64, 4, 4))
    stats, final = tchain.native_chain_stats_host(th.row_ptr, th.col_idx, th.vals,
                                                  th.n_rows, 3)
    results, p_band, base, perm = tchain.run_chain_foldband(
        th, "cpu", (64, 4, 4), max_step=3, iters=1, native_stats=stats, verbose=False)
    assert p_band.shape[1] < th.n_rows
    tchain.verify_final_values(tchain.unfold_band(p_band, base, perm), final)


def test_group_dot_chain_cpu_matches_oracle_and_pallas(torus4, pallas_final4):
    _, th, stats, final = torus4
    results, p = tchain.run_chain_dense_acc(th, "cpu", max_step=4, iters=2,
                                            native_stats=stats, verbose=False,
                                            kernel="group-dot")
    _assert_chain_matches(results, p, stats, final, pallas_final4)
    with pytest.raises(ValueError, match="kernel"):
        tchain.run_chain_dense_acc(th, "cpu", max_step=4, kernel="mxu")


def test_mixed_chain_cpu_matches_oracle_and_jax_slab():
    """8^3 thinned torus: A^2..A^4 by slab ESC (compared whole with JAX's
    spgemm_slab products), then A^5..A^7 by dense-acc from the densified A^4."""
    th = tchain.build_torus_host(dims=(8, 8, 8))
    stats, final = tchain.native_chain_stats_host(th.row_ptr, th.col_idx, th.vals,
                                                  th.n_rows, 7)
    keep = {}
    results, p, t_dens = tchain.run_chain_mixed(th, "cpu", max_step=7, switch_step=5,
                                                iters=1, native_stats=stats,
                                                verbose=False, keep=keep)
    crp, cc, cv = final
    want = np.zeros((th.n_rows, th.n_rows), np.float32)
    want[np.repeat(np.arange(th.n_rows), np.diff(crp)), cc] = cv
    _assert_chain_matches(results, p, stats, final, want)
    assert t_dens > 0 and sorted(keep) == [2, 3, 4]
    ja = jchain.build_torus_host(dims=(8, 8, 8)).to_device()
    cur = ja
    for step in (2, 3, 4):
        cur = jslab.spgemm_slab(cur, ja)
        got = keep[step]
        assert int(got.nnz) == int(cur.nnz) and got.capacity == cur.capacity
        np.testing.assert_array_equal(got.row_ptr.numpy(), np.asarray(cur.row_ptr))
        np.testing.assert_array_equal(got.col_idx.numpy(), np.asarray(cur.col_idx))
        for g, w in zip(got.values, cur.values):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int64))
    with pytest.raises(ValueError, match="switch_step"):
        tchain.run_chain_mixed(th, "cpu", max_step=4, switch_step=2)


def test_chain_raises_on_oracle_disagreement(torus4):
    _, th, stats, final = torus4
    bad = [stats[0], (3, stats[1][1] + 1, *stats[1][2:]), stats[2]]
    with pytest.raises(RuntimeError, match="A\\^3"):
        tchain.run_chain_dense_acc(th, "cpu", max_step=4, iters=1,
                                   native_stats=bad, verbose=False)
    _, p = tchain.run_chain_dense_acc(th, "cpu", max_step=4, iters=1, verbose=False)
    p[3, 5] += 1
    with pytest.raises(RuntimeError):
        tchain.verify_final_values(p, final)


def _path_graph(n):
    i = np.arange(n - 1)
    return np.concatenate([i, i + 1]), np.concatenate([i + 1, i]), np.ones(2 * (n - 1), np.uint64), n


GRAPHS = {
    "torus4x4x4": (lambda: jgen.lattice([4, 4, 4], torus=True), "dense-acc"),
    "path1000": (lambda: _path_graph(1000), "band"),
    "random2000x2000": (lambda: jgen.random_graph(2000, 2000, seed=0), "esc"),
}


@pytest.mark.parametrize("name", list(GRAPHS))
@pytest.mark.parametrize("steps", [1, 6])
def test_choose_strategy_matches_jax(name, steps):
    make, route_at_one_step = GRAPHS[name]
    rows, cols, vals, n = make()
    a = SparseCSR.from_coo_host(rows, cols, vals, n, sr=U64)
    got = choose_strategy(HostCSR.from_coo(rows, cols, vals, n), steps=steps)
    assert got == jax_choose_strategy(a, steps=steps)
    if steps == 1:
        assert got == route_at_one_step


def test_main_runs_on_cpu(tmp_path, capsys):
    csv = tmp_path / "chain.csv"
    record = tchain.main(["--quick", "--device", "cpu", "--steps", "4", "--iters", "1",
                          "--csv", str(csv)])
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == record
    assert record["metric"] == "spgemm_chain_A4_nnz_per_s" and record["verified"]
    assert record["device"] == "cpu" and record["value"] > 0
    assert sum(line.startswith("A^") for line in out) == 3
    assert csv.read_text().count("\n") == 4


@pytest.mark.parametrize("switches,algo,kernel", [
    (["--algo", "foldband"], "foldband", "band"),
    (["--kernel", "group-dot"], "auto", "group-dot"),
    (["--algo", "rowcat"], "rowcat", "rowcat"),
])
def test_main_switches_run_on_cpu(capsys, switches, algo, kernel):
    record = tchain.main(["--quick", "--device", "cpu", "--steps", "4", "--iters", "1",
                          *switches])
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == record
    assert record["verified"] and (record["algo"], record["kernel"]) == (algo, kernel)
    assert record["metric"] == "spgemm_chain_A4_nnz_per_s" and record["value"] > 0
    assert sum(line.startswith("A^") for line in out) == 3


@pytest.mark.parametrize("steps,switch,dense_steps", [(6, 4, 3), (4, 5, 0)])
def test_main_mixed_runs_on_cpu(capsys, steps, switch, dense_steps):
    record = tchain.main(["--quick", "--device", "cpu", "--steps", str(steps), "--iters", "1",
                          "--algo", "mixed", "--switch-step", str(switch)])
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == record
    assert record["verified"] and (record["algo"], record["kernel"]) == ("mixed",
                                                                         "slab+dense-acc")
    assert record["switch_step"] == min(switch, steps + 1)
    assert (record["densify_ms"] > 0) == (dense_steps > 0)
    slab_steps = steps - 1 - dense_steps
    assert sum(line.startswith("A^") and "[slab call" in line for line in out) == slab_steps
    assert sum(line.startswith("A^") for line in out) == 2 * slab_steps + dense_steps
    assert any(line.startswith("chain total") and "incl. densify" in line for line in out)


def test_main_default_keys_and_switch_conflict(capsys):
    record = tchain.main(["--quick", "--device", "cpu", "--steps", "3", "--iters", "1",
                          "--no-verify"])
    assert set(record) == {"metric", "value", "unit", "vs_baseline", "chain_ms", "device",
                           "verified", "algo", "kernel"}
    assert (record["algo"], record["kernel"], record["verified"]) == ("auto", "dense-acc", False)
    with pytest.raises(SystemExit):
        tchain.main(["--quick", "--device", "cpu", "--algo", "foldband",
                     "--kernel", "group-dot"])


def test_main_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA"):
        tchain.main(["--quick", "--no-verify"])


def test_main_refuses_unported_routes(monkeypatch, capsys):
    """The router's "band" route, once refused, now runs the block-band
    chain (bench.py maps "band" to run_chain_band), checked against the
    oracle at every step and on the final values."""
    monkeypatch.setattr(tchain, "choose_strategy", lambda h, steps: "band")
    record = tchain.main(["--quick", "--device", "cpu", "--steps", "3", "--iters", "1"])
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == record
    assert record["verified"] and (record["algo"], record["kernel"]) == ("auto", "band-matmul")
    assert sum(line.startswith("A^") and "[band cpu" in line for line in out) == 2


@pytest.mark.parametrize("algo,kernel,label", [
    ("esc", "esc", "esc"), ("escb", "escb", "escb"), ("dense", "dense", "dense"),
    ("band", "band-matmul", "band"), ("pallas", "dense-acc", "dense-acc"),
])
def test_main_runs_every_algo_on_12_cubed(capsys, algo, kernel, label):
    """bench.py's --algo forms on the 12^3 torus, A^2..A^4, each against the
    oracle (every step's (nnz, max); the whole CSR for esc and escb, the
    final values for the dense forms)."""
    record = tchain.main(["--quick", "--device", "cpu", "--steps", "4", "--iters", "1",
                          "--algo", algo])
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == record
    assert record["verified"] and (record["algo"], record["kernel"]) == (algo, kernel)
    assert record["metric"] == "spgemm_chain_A4_nnz_per_s" and record["value"] > 0
    assert sum(line.startswith("A^") and f"[{label} cpu" in line for line in out) == 3


def test_esc_escb_dense_band_chains_match_oracle_and_jax(torus4, pallas_final4):
    """The 4^3 torus, A^2..A^4: the ESC and blocked-ESC chains equal the
    oracle's whole CSR, the dense and band chains its values and JAX's
    Pallas chain; the band chain's per-step nnz equal JAX's run_chain_band."""
    jh, th, stats, final = torus4
    want_steps = [(s, nnz, float(mx)) for s, nnz, mx, _ in stats]
    for run in (tchain.run_chain, tchain.run_chain_escb):
        results, c = run(th, "cpu", max_step=4, iters=1, native_stats=stats, verbose=False)
        assert [(r.step, r.nnz, r.max_value) for r in results] == want_steps
        assert [r.flops for r in results] == [s[3] for s in stats]
        for got, want in zip(c.to_numpy(), final):
            np.testing.assert_array_equal(got.astype(want.dtype), want)
    results, p = tchain.run_chain_dense(th, "cpu", max_step=4, iters=1, n_chunks=3,
                                        native_stats=stats, verbose=False)
    _assert_chain_matches(results, p, stats, final, pallas_final4)
    results, band = tchain.run_chain_band(th, "cpu", 21, block=8, max_step=4, iters=1,
                                          native_stats=stats, verbose=False)
    assert [(r.step, r.nnz, r.max_value) for r in results] == want_steps
    np.testing.assert_array_equal(bandmm.band_to_dense(band).numpy(), pallas_final4)
    jres = jchain.run_chain_band(jh.to_device(), half_width=21, block=8, max_step=4, iters=1,
                                 verbose=False)
    assert [r.nnz for r in jres] == [r.nnz for r in results]
    bad = [stats[0], (3, stats[1][1] + 1, *stats[1][2:]), stats[2]]
    for run in (tchain.run_chain, tchain.run_chain_escb, tchain.run_chain_dense):
        with pytest.raises(RuntimeError, match="A\\^3"):
            run(th, "cpu", max_step=4, iters=1, native_stats=bad, verbose=False)
    with pytest.raises(RuntimeError, match="A\\^3"):
        tchain.run_chain_band(th, "cpu", 21, block=8, max_step=4, iters=1, native_stats=bad,
                              verbose=False)
    with pytest.raises(ValueError, match="cyclic band"):
        tchain.run_chain_band(th, "cpu", 3, block=8, max_step=3, iters=1, verbose=False)


def test_main_routes_esc_to_the_rowcat_chain(capsys):
    """The 12^3 torus at --steps 2 routes to "esc" in both routers, and the
    chain runs it as the rowcat chain (bench.py's mapping), every step's
    whole CSR equal to the oracle's."""
    h = tchain.build_torus_host(dims=(12, 12, 12))
    assert choose_strategy(h, steps=1) == "esc"
    assert jax_choose_strategy(jchain.build_torus_host(dims=(12, 12, 12)).to_device(),
                               steps=1) == "esc"
    record = tchain.main(["--quick", "--device", "cpu", "--steps", "2", "--iters", "1"])
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == record
    assert record["verified"] and (record["algo"], record["kernel"]) == ("auto", "rowcat")
    assert record["metric"] == "spgemm_chain_A2_nnz_per_s" and record["value"] > 0
    assert sum(line.startswith("A^2 [rowcat cpu]") for line in out) == 1
    with pytest.raises(ValueError, match="rowcat"):
        tchain.main(["--quick", "--device", "cpu", "--steps", "2", "--kernel", "group-dot"])


def test_rowcat_chain_matches_oracle_and_raises_on_disagreement(torus4):
    _, th, stats, final = torus4
    results, c = tchain.run_chain_rowcat(th, "cpu", max_step=4, iters=1, native_stats=stats,
                                         verbose=False)
    assert [(r.step, r.nnz, r.max_value, r.flops) for r in results] == \
        [(s, nnz, float(mx), fl) for s, nnz, mx, fl in stats]
    for got, want in zip(c.to_numpy(), final):
        np.testing.assert_array_equal(got.astype(want.dtype), want)
    bad = [stats[0], (3, stats[1][1], stats[1][2] + 1, stats[1][3]), stats[2]]
    with pytest.raises(RuntimeError, match="A\\^3"):
        tchain.run_chain_rowcat(th, "cpu", max_step=4, iters=1, native_stats=bad,
                                verbose=False)


def test_port_never_imports_jax():
    code = ("import sys; import sparsetpu_torch, sparsetpu_torch.bench.chain, "
            "sparsetpu_torch.kernels.spmm, sparsetpu_torch.kernels.bandplanes, "
            "sparsetpu_torch.kernels.groupdot, sparsetpu_torch.kernels._build, "
            "sparsetpu_torch.interop, sparsetpu_torch.semiring, sparsetpu_torch.csr, "
            "sparsetpu_torch.ops.segments, sparsetpu_torch.ops.spgemm, "
            "sparsetpu_torch.attention.scores, sparsetpu_torch.kernels.blocksparse, "
            "sparsetpu_torch.bench.tipover, sparsetpu_torch.bench.spgemm_bench, "
            "sparsetpu_torch.kernels.sortmerge, sparsetpu_torch.ops.rowcat, "
            "sparsetpu_torch.ops.escb, sparsetpu_torch.graphs.datasets, "
            "sparsetpu_torch.kernels.coalesce, sparsetpu_torch.ops.slab, "
            "sparsetpu_torch.ops.colchunk, sparsetpu_torch.ops.denseacc, "
            "sparsetpu_torch.ops.spmm, sparsetpu_torch.ops.elementwise, "
            "sparsetpu_torch.ops.hybrid, sparsetpu_torch.kernels.bandmm, "
            "sparsetpu_torch.utils.bcoo, sparsetpu_torch.utils.stdrng, "
            "sparsetpu_torch.utils.oracle, sparsetpu_torch.einsum.parser, "
            "sparsetpu_torch.graphs.generate, sparsetpu_torch.graphs.patterns, "
            "sparsetpu_torch.graphs.algos, sparsetpu_torch.bench.real_graphs; "
            "bad = sorted(m for m in sys.modules "
            "if m == 'jax' or m.startswith(('jax.', 'sparsetpu.')) or m == 'sparsetpu'); "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
