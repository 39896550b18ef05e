"""The port's general-SpGEMM sweep (sparsetpu_torch.bench.spgemm_bench) on
the CPU at a toy size: its rows' graph columns equal the values computed
from the JAX package's generators and its native oracle, every one of JAX's
eight algorithms agrees with the oracle (no DNF row), the dense routes keep
JAX's DNF rules, and an unknown algorithm raises."""

import numpy as np
import pytest
import torch

from sparsetpu import native as jnative
from sparsetpu.graphs import datasets as jdata, generate as jgen

from sparsetpu_torch.bench import spgemm_bench as sb

from sparsetpu.bench import spgemm_bench as jsb
from sparsetpu.ops import denseacc as jdenseacc

ALGOS = ("esc", "escb", "rowcat", "rowcat_pallas", "denseacc", "densedense",
         "densedense_tiled", "bcoo")


def _jax_columns(case, n, epn, coo):
    """case,n,e_per_n,nnz_a,flops,nnz_c from JAX's graph and oracle."""
    rows, cols, vals, nn = coo
    row_ptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=nn))])
    flops = int(np.diff(row_ptr)[cols].sum())
    host = jnative.as_host_csr(row_ptr, cols, vals)
    nnz_c = int(jnative.spgemm(host, host, nn)[0][-1])
    return f"{case},{n},{epn},{len(rows)},{flops},{nnz_c}"


@pytest.fixture(scope="module")
def sweep():
    return sb.run(sides=(60,), e_per_n=(2, 8), power_law_sides=(300,), algos=ALGOS,
                  iters=1, verbose=False, device="cpu")


def test_sweep_rows_match_jax_generators_and_oracle(sweep):
    lines = sweep.strip().split("\n")
    assert lines[0] == sb.HEADER
    want = [_jax_columns("er", 60, epn, jgen.random_graph(60, 60 * epn, seed=60 + epn))
            for epn in (2, 8)]
    want.append(_jax_columns("powerlaw", 300, 8, jdata.power_law(300, 8, seed=17)))
    rows = [line.split(",") for line in lines[1:]]
    assert len(rows) == 3 * len(ALGOS)
    for i, r in enumerate(rows):
        assert ",".join(r[:6]) == want[i // len(ALGOS)]
        assert r[6] == ALGOS[i % len(ALGOS)]
        assert float(r[7]) > 0 and float(r[8]) >= 0, f"DNF row: {r}"


def test_cases_match_jax_generators():
    cases = sb.make_cases(sides=(40,), e_per_n=(3,), power_law_sides=(50,))
    assert [c[:3] for c in cases] == [("er", 40, 3), ("powerlaw", 50, 8)]
    for got, want in zip(cases, (jgen.random_graph(40, 120, seed=43),
                                 jdata.power_law(50, 8, seed=17))):
        for g, w in zip(got[3][:3], want[:3]):
            np.testing.assert_array_equal(g, w)


def test_algos_are_jaxs_eight():
    assert sb.ALGOS == ALGOS
    for algo in ALGOS:  # each is a branch of JAX's sweep
        assert f'algo == "{algo}"' in open(jsb.__file__).read()


@pytest.mark.parametrize("algo", ["denseacc", "densedense", "densedense_tiled", "bcoo"])
def test_unported_algorithms_raise(algo):
    """The four algorithms the sweep once refused now give a row equal to
    the oracle; only an unknown algorithm raises."""
    csv = sb.run(sides=(40,), e_per_n=(2,), power_law_sides=(), algos=(algo,), iters=1,
                 verbose=False, device="cpu")
    (row,) = [line.split(",") for line in csv.strip().split("\n")[1:]]
    assert row[6] == algo and float(row[7]) > 0
    with pytest.raises(ValueError):
        sb.run(sides=(40,), e_per_n=(2,), power_law_sides=(), algos=(algo, "nope"),
               device="cpu")


def test_dense_routes_keep_jaxs_dnf_rules(monkeypatch):
    """densedense where densedense_fits(n, n, n) fails and densedense_tiled
    where no panel fits give DNF_error rows, as in JAX's sweep; the other
    rows still run."""
    for n in (8000, 27000):
        assert sb.denseacc.densedense_fits(n, n, n) == jdenseacc.densedense_fits(n, n, n)
        assert sb.denseacc.densedense_tiled_panel_cols(n, n) == \
            jdenseacc.densedense_tiled_panel_cols(n, n)
    assert not sb.denseacc.densedense_fits(27000, 27000, 27000)
    monkeypatch.setattr(sb.denseacc, "densedense_fits", lambda n, k, m: False)
    monkeypatch.setattr(sb.denseacc, "densedense_tiled_panel_cols", lambda n, k: 0)
    csv = sb.run(sides=(40,), e_per_n=(2,), power_law_sides=(),
                 algos=("densedense", "densedense_tiled", "denseacc"), iters=1, verbose=False,
                 device="cpu")
    rows = [line.split(",") for line in csv.strip().split("\n")[1:]]
    assert [(r[6], r[7]) for r in rows[:2]] == [("densedense", "DNF_error"),
                                                 ("densedense_tiled", "DNF_error")]
    assert rows[2][6] == "denseacc" and float(rows[2][7]) > 0


def test_main_writes_the_csv_on_cpu(tmp_path):
    out = tmp_path / "sweep.csv"
    sb.main(["--sides", "40", "--e-per-n", "2", "--power-law-sides", "--algos", "esc",
             "rowcat_pallas", "--iters", "1", "--out", str(out), "--device", "cpu"])
    lines = out.read_text().strip().split("\n")
    assert lines[0] == sb.HEADER and len(lines) == 3
    assert all("DNF" not in line for line in lines)


def test_main_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA"):
        sb.main(["--sides", "40"])
