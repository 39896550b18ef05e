"""The port's categorized SpGEMM (sparsetpu_torch.ops.hybrid: band +
outliers) against the JAX package's (sparsetpu.ops.hybrid), on the CPU.

Tolerance: exact (integer counts below 2^24 carried in f32; u64 CSRs
compared entry for entry).  The JAX hybrid product of tests/test_band.py's
banded graph with three far outliers is computed once (module fixture) and
its band, outliers and CSR are each compared with the port's.
"""

import numpy as np
import pytest

from sparsetpu import U64 as JU64
from sparsetpu.csr import SparseCSR as JCSR
from sparsetpu.graphs import generate as jgen
from sparsetpu.ops import hybrid as jhybrid

from sparsetpu_torch.csr import HostCSR
from sparsetpu_torch.interop import carry_csr
from sparsetpu_torch.ops import hybrid
from sparsetpu_torch.semiring import U64


def _banded_with_outliers():
    rng = np.random.default_rng(4)
    n = 48
    dense = np.zeros((n, n), np.uint64)
    for r in range(n):
        for dc in (-2, -1, 1, 2):
            c = r + dc
            if 0 <= c < n and rng.random() < 0.7:
                dense[r, c] = rng.integers(1, 4)
    dense[0, 40] = 3
    dense[45, 2] = 2
    dense[20, 44] = 1
    return dense


def _assert_csr(got, want):
    assert int(got.nnz) == int(want.nnz)
    for g, w in zip(got.to_numpy(), want.to_numpy()):
        np.testing.assert_array_equal(g.astype(np.int64), np.asarray(w).astype(np.int64))


@pytest.fixture(scope="module")
def jax_hybrid():
    dense = _banded_with_outliers()
    j = JCSR.from_dense_numpy(dense, sr=JU64)
    h = jhybrid.hybrid_from_csr(j, half_width=2, block=8, cyclic=False)
    c = jhybrid.hybrid_matmul(h, h, a_csr=j)
    return dense, j, h, c, c.to_csr(sr=JU64)


def test_hybrid_with_outliers_matches_jax(jax_hybrid):
    dense, j, jh, jc, jcsr = jax_hybrid
    a = carry_csr(j, "cpu")
    h = hybrid.hybrid_from_csr(a, half_width=2, block=8, cyclic=False)
    assert int(h.outliers.nnz) == 3 and h.nnz() == jh.nnz() and h.n == 48
    _assert_csr(h.to_csr(U64), jh.to_csr(sr=JU64))
    c = hybrid.hybrid_matmul(h, h, a_csr=a)
    np.testing.assert_array_equal(c.band.data.numpy(), np.asarray(jc.band.data))
    _assert_csr(c.outliers, jc.outliers)
    got = c.to_csr(U64)
    _assert_csr(got, jcsr)
    want = dense.astype(np.int64) @ dense.astype(np.int64)
    np.testing.assert_array_equal(got.to_dense_numpy().astype(np.int64), want)
    with pytest.raises(ValueError, match="a_csr"):
        hybrid.hybrid_matmul(h, h)


def test_band_times_sparse_and_f32_round_trip_match_jax(jax_hybrid):
    _, j, jh, _, _ = jax_hybrid
    a = carry_csr(j, "cpu")
    h = hybrid.hybrid_from_csr(a, half_width=2, block=8, cyclic=False)
    ao = hybrid._as_f32_csr(h.outliers)
    jao = jhybrid._as_f32_csr(jh.outliers)
    assert ao.sr_name == "f32" and ao.values[0].tolist()[:3] == \
        np.asarray(jao.values[0])[:3].tolist()
    got = hybrid._band_times_sparse(h.band, ao)
    want = jhybrid._band_times_sparse(jh.band, jao)
    _assert_csr(hybrid._f32_to_sr_csr(got, U64), jhybrid._f32_to_sr_csr(want, JU64))


def test_cyclic_torus_has_no_outliers_and_guards():
    rows, cols, vals, n = jgen.lattice([4, 4, 4], torus=True)
    j = JCSR.from_coo(rows, cols, vals, n, sr=JU64)
    a = carry_csr(j, "cpu")
    h = hybrid.hybrid_from_csr(a, half_width=21, block=8, cyclic=True)
    assert int(h.outliers.nnz) == 0
    c = hybrid.hybrid_matmul(h, h)
    ad = a.to_dense_numpy().astype(np.int64)
    np.testing.assert_array_equal(c.to_csr(U64).to_dense_numpy().astype(np.int64), ad @ ad)
    big = carry_csr(JCSR.from_coo([0], [0], [1 << 25], 2, sr=JU64), "cpu")
    with pytest.raises(ValueError, match="2\\^24"):
        hybrid.hybrid_from_csr(big, half_width=1, block=2)
    with pytest.raises(ValueError, match="2\\^24"):
        jhybrid.hybrid_from_csr(JCSR.from_coo([0], [0], [1 << 25], 2, sr=JU64), 1, block=2)


@pytest.mark.parametrize("steps", [1, 6])
def test_choose_strategy_takes_a_sparse_csr(steps):
    """The router reads a device SparseCSR as it reads a HostCSR, and both
    equal JAX's, on graphs routed to each category."""
    i = np.arange(999)
    graphs = [jgen.lattice([4, 4, 4], torus=True),
              (np.concatenate([i, i + 1]), np.concatenate([i + 1, i]),
               np.ones(1998, np.uint64), 1000),
              jgen.random_graph(2000, 2000, seed=0)]
    for rows, cols, vals, n in graphs:
        j = JCSR.from_coo_host(rows, cols, vals, n, sr=JU64)
        want = jhybrid.choose_strategy(j, steps=steps)
        assert hybrid.choose_strategy(carry_csr(j, "cpu"), steps=steps) == want
        assert hybrid.choose_strategy(HostCSR.from_coo(rows, cols, vals, n), steps=steps) == want
