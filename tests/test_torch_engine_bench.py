"""The port's einsum engine benchmark (``sparsetpu_torch.bench.engine_bench``)
against the JAX package's (``sparsetpu.bench.engine_bench``), on the CPU at a
toy size: the same CSV header and the same (case, impl) rows in the same
order, every engine result held against its direct call on the way (the
run raises otherwise), and each tier's route.  Times are the host's and
are not compared."""

import numpy as np
import pytest
import torch

from sparsetpu.bench import engine_bench as jeb

from sparsetpu_torch.bench import engine_bench as eb


def _rows(csv):
    lines = csv.strip().split("\n")
    return lines[0], [tuple(r.split(",")[:2]) for r in lines[1:]]


def test_rows_match_jax_at_a_toy_size():
    details = {}
    got = eb.run(n=48, nnz_per_row=3, reps=2, iters=1, verbose=False, device="cpu",
                 details=details)
    want = jeb.run(n=48, nnz_per_row=3, reps=2, iters=1, verbose=False)
    assert _rows(got) == _rows(want)
    assert _rows(got)[0] == eb.HEADER
    for line in got.strip().split("\n")[1:]:
        secs, slowdown = map(float, line.split(",")[2:])
        assert secs > 0 and slowdown > 0
    # 48 x 3: A.B has 432 products, (AB).C 1,377, both under 2^19: esc
    assert details["spgemm"]["route"] == "esc" and details["chain"]["route"] == ["esc", "esc"]
    assert details["spmm_max_abs_err"] <= 1e-4


def test_random_operands_match_jax():
    j = jeb._rand_csr(40, 40, 120, 1)
    p = eb._rand_csr(40, 40, 120, 1, device="cpu")
    np.testing.assert_array_equal(p.to_dense_numpy(), j.to_dense_numpy())
    assert p.capacity == j.capacity == 120 and j.sr_name == "u64" == p.sr_name


def test_disagreement_raises():
    a = eb._rand_csr(8, 8, 16, 1, device="cpu")
    b = eb._rand_csr(8, 8, 16, 2, device="cpu")
    with pytest.raises(RuntimeError, match="!= the direct call's"):
        eb.same_csr(a, b, "toy")
    eb.same_csr(a, a, "toy")


def test_cli_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        eb.main(["--n", "8", "--out", str(tmp_path / "e.csv")])
    eb.main(["--n", "16", "--nnz-per-row", "2", "--device", "cpu",
             "--out", str(tmp_path / "e.csv")])
    text = (tmp_path / "e.csv").read_text().strip().split("\n")
    assert text[0].startswith("# cpu") and text[1] == eb.HEADER and len(text) == 13


def test_spmm_gather_in_column_panels_changes_nothing(monkeypatch):
    """The SpMM tier's ``spmm_csr_dense`` gathers D in column panels of at
    most ``GATHER_BYTES`` (27,000 x 8 would gather 23 GB at once); every
    output element sums the same terms in the same order, so a budget of
    three columns gives the one-panel result bit for bit, on float values
    too."""
    from sparsetpu_torch.csr import SparseCSR
    from sparsetpu_torch.ops import spmm
    from sparsetpu_torch.semiring import F32SR

    rng = np.random.default_rng(3)
    dense = np.where(rng.random((9, 11)) < 0.4, rng.standard_normal((9, 11)), 0)
    a = SparseCSR.from_dense_numpy(dense.astype(np.float32), sr=F32SR, device="cpu")
    d = torch.from_numpy(rng.standard_normal((11, 13)).astype(np.float32))
    whole = spmm.spmm_csr_dense(a, d)
    monkeypatch.setattr(spmm, "GATHER_BYTES", 4 * a.capacity * 3)
    assert torch.equal(spmm.spmm_csr_dense(a, d), whole)
    np.testing.assert_allclose(whole.numpy(), dense @ d.numpy(), rtol=1e-5, atol=1e-5)
