"""The port's last benchmark modules against the JAX package's, on the CPU:
``bench/configs`` (equal tables), ``bench/memcross`` (equal rows and
summaries on the committed tipover CSVs), ``bench/report`` (equal markdown
strings), ``bench/scaling`` (equal ``work_imbalance`` at 1, 2 and 4 shards;
the port's worlds run over gloo here, so its CSV carries the sharing
caveat), and ``entry.py`` (the step and the dry run at 2).

Tolerance: exact (strings, integers, and the imbalance, a ratio of the
same integers in float64).
"""

import dataclasses
import os
import sys

import numpy as np
import pytest

from sparsetpu import U64 as JU64
from sparsetpu import SparseCSR as JCSR
from sparsetpu.bench import chain as jchain
from sparsetpu.bench import configs as jconfigs
from sparsetpu.bench import memcross as jmemcross
from sparsetpu.bench import report as jreport
from sparsetpu.bench import scaling as jscaling
from sparsetpu.graphs import generate as jgen

from sparsetpu_torch import entry
from sparsetpu_torch.bench import chain as tchain
from sparsetpu_torch.bench import configs as tconfigs
from sparsetpu_torch.bench import memcross as tmemcross
from sparsetpu_torch.bench import report as treport
from sparsetpu_torch.bench import scaling as tscaling

REPORTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "reports")
TIPOVER = [os.path.join(REPORTS, f"tipover_results_{i}.csv") for i in range(5)]
MARKDOWN_CSVS = ["chain_final.csv", "scaling_virtual8.csv", "tipover_results_1.csv",
                 "spgemm_sweep_h100.csv", "engine_bench_h100.csv"]


def _dense(coo):
    rows, cols, vals, n = coo
    a = np.zeros((n, n), np.int64)
    np.add.at(a, (rows, cols), vals.astype(np.int64))
    return a


@pytest.mark.parametrize("table", ["CHAIN_CONFIGS", "RANDOM_SWEEPS", "POWER_LAW"])
def test_configs_equal_jax(table):
    got, want = getattr(tconfigs, table), getattr(jconfigs, table)
    assert list(got) == list(want)
    for name in want:
        assert dataclasses.asdict(got[name]) == dataclasses.asdict(want[name])
        if table == "CHAIN_CONFIGS":
            assert (got[name].n, got[name].half_width) == (want[name].n, want[name].half_width)


@pytest.mark.parametrize("cfg", range(5))
def test_memcross_analyze_matches_jax(cfg):
    assert tmemcross.parse_csv(TIPOVER[cfg]) == jmemcross.parse_csv(TIPOVER[cfg])
    assert tmemcross.analyze(TIPOVER[cfg], cfg) == jmemcross.analyze(TIPOVER[cfg], cfg)


def test_memcross_main_writes_jax_file_to_a_new_path(tmp_path):
    want, got = tmp_path / "jax.csv", tmp_path / "out" / "port.csv"
    jmemcross.main(["--dir", REPORTS, "--out", str(want)])
    tmemcross.main(["--dir", REPORTS, "--out", str(got)])
    assert got.read_text() == want.read_text()


@pytest.mark.parametrize("name", MARKDOWN_CSVS)
@pytest.mark.parametrize("title", [None, "a title"])
def test_csv_to_markdown_matches_jax(name, title):
    with open(os.path.join(REPORTS, name)) as f:
        text = f.read()
    got = treport.csv_to_markdown(text, title=title)
    assert got == jreport.csv_to_markdown(text, title=title) and got.count("|") > 10


@pytest.mark.parametrize("baseline", [None, {2: 1.0, 7: 2.5}])
def test_chain_report_matches_jax(baseline):
    steps = [tchain.ChainStep(step=k, nnz=1000 * k, flops=3000 * k, seconds=1e-3 * k,
                              nnz_per_s=1e6 / k, gflops=0.0) for k in range(2, 8)]
    jsteps = [jchain.ChainStep(s.step, s.nnz, s.flops, s.seconds, s.nnz_per_s, s.gflops)
              for s in steps]
    assert treport.chain_report(steps, baseline) == jreport.chain_report(jsteps, baseline)


def test_report_main_over_a_directory_of_csvs(tmp_path):
    """The same tables as JAX's main under the port's own title, in a new
    file."""
    for name in ("chain_final.csv", "scaling_virtual8.csv", "tipover_results_1.csv",
                 "engine_bench_h100.csv"):
        dst = "chain_r.csv" if name.startswith("chain") else name
        (tmp_path / dst).write_text(open(os.path.join(REPORTS, name)).read())
    jreport.main(["--bench-dir", str(tmp_path), "--out", str(tmp_path / "jax.md")])
    treport.main(["--bench-dir", str(tmp_path), "--out", str(tmp_path / "port" / "r.md")])
    got = (tmp_path / "port" / "r.md").read_text().split("\n")
    want = (tmp_path / "jax.md").read_text().split("\n")
    assert got[0] == "# sparsetpu_torch benchmark report (H100)" and got[1:] == want[1:]


def _chain_csv():
    return tchain.chain_csv([tchain.ChainStep(2, 10, 30, 1e-3, 1e4, 0.1)])


def test_plots_return_false_without_matplotlib(tmp_path, monkeypatch):
    """The card's machine has no matplotlib: every plot returns False, as
    JAX's do."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert not treport.try_plot_chain(_chain_csv(), str(tmp_path / "c.png"))
    assert not treport.try_plot_overhead("n,overhead\n1,0.1\n", str(tmp_path / "e.png"))
    assert not treport.try_plot_crossover([], str(tmp_path / "f.png"))
    assert not treport.try_plot_spgemm_surface("", str(tmp_path / "g.png"))
    assert not list(tmp_path.iterdir())


def test_chain_plot_is_written_with_matplotlib(tmp_path):
    pytest.importorskip("matplotlib")
    assert treport.try_plot_chain(_chain_csv(), str(tmp_path / "c.png"))
    assert (tmp_path / "c.png").stat().st_size > 0


@pytest.fixture(scope="module")
def scaling_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("scaling") / "scaling.csv"
    results = tscaling.main(["--config", "torus8", "--devices", "1", "2", "4", "--steps", "1",
                             "--iters", "1", "--device", "cpu", "--out", str(out)])
    return results, out.read_text()


def test_scaling_imbalance_matches_jax(scaling_run):
    """work_imbalance at 1, 2 and 4 shards equals JAX's; the chain's nnz is
    the oracle's A^2."""
    results, _ = scaling_run
    cfg = jconfigs.CHAIN_CONFIGS["torus8"]
    coo = jgen.thin(jgen.lattice(list(cfg.dims), torus=True), cfg.density, seed=cfg.seed)
    a = JCSR.from_coo(*coo[:3], coo[3], sr=JU64)
    want = jscaling.measure_scaling(a, device_counts=(1, 2, 4), steps=1, iters=1,
                                    verbose=False)
    assert [r.devices for r in results] == [1, 2, 4]
    assert [r.work_imbalance for r in results] == [w.work_imbalance for w in want]
    nnz = np.count_nonzero(np.linalg.matrix_power(_dense(coo), 2))
    for r in results:
        assert r.transport == "gloo" and r.seconds > 0
        assert round(r.nnz_per_s * r.seconds) == nnz


def test_scaling_csv_has_jax_columns_and_the_sharing_caveat(scaling_run):
    results, text = scaling_run
    lines = text.strip().split("\n")
    comments = [l for l in lines if l.startswith("#")]
    assert "hardware_meaningful=NO" in "\n".join(comments)
    assert "transports: 1 rank(s): gloo; 2 rank(s): gloo; 4 rank(s): gloo" in text
    body = "\n".join(l for l in lines if not l.startswith("#")) + "\n"
    assert body == tscaling.scaling_csv(results)
    assert body.split("\n")[0] == jscaling.scaling_csv([]).strip()


def test_entry_step_on_the_cpu():
    fn, (a, b) = entry.entry(device="cpu")
    c = fn(a, b).check()
    coo = jgen.thin(jgen.lattice([8, 8, 8], torus=True), 3.0 / 26.0, seed=42)
    want = np.linalg.matrix_power(_dense(coo), 2)
    np.testing.assert_array_equal(c.to_dense_numpy().astype(np.int64), want)


def test_dryrun_multichip_at_2(capsys):
    got = entry.dryrun_multichip(2, device="cpu")
    coo = jgen.thin(jgen.lattice([4, 4, 4], torus=True), 0.3, seed=7)
    want = int(np.count_nonzero(np.linalg.matrix_power(_dense(coo), 2)))
    assert got == {"esc": want, "ring": want, "band": want}
    out = capsys.readouterr().out
    for label in ("ESC", "ring-panel", "band"):
        assert f"dryrun_multichip(2): {label} A^2 nnz={want} OK" in out


def test_torus30_band_needs_its_cyclic_bandwidth():
    """configs' nominal half-width of the 30^3 torus (931) is below the
    thinned torus's cyclic bandwidth (1,799): the sharded band product on
    the card takes the bandwidth, as the band chain does."""
    from sparsetpu_torch.kernels import bandmm

    cfg = tconfigs.CHAIN_CONFIGS["torus30"]
    h = tchain.build_torus_host(cfg.dims, cfg.density, cfg.seed)
    assert cfg.half_width == 931 and bandmm.cyclic_bandwidth(h) == 1799
