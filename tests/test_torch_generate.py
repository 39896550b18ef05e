"""The port's host graph generators and host CSR builder against the JAX package.

``sparsetpu_torch.graphs.generate`` and ``sparsetpu_torch.csr.HostCSR.from_coo``
are numpy copies of ``sparsetpu.graphs.generate`` and
``SparseCSR.host_csr_arrays``; for the same inputs and seed they must give
bit-identical arrays (tolerance: exact equality, ``assert_array_equal``).
"""

import numpy as np
import pytest

from sparsetpu import F32SR, U32, U64, SparseCSR
from sparsetpu.graphs import generate as jgen

from sparsetpu_torch.csr import HostCSR
from sparsetpu_torch.graphs import generate as tgen
from sparsetpu_torch.interop import csr_from_jax_host

SR = {"u64": U64, "u32": U32, "f32": F32SR}


def _assert_coo_equal(got, want):
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[3] == want[3]


@pytest.mark.parametrize("dims", [[4, 4, 4], [5, 5], [2, 3]])
@pytest.mark.parametrize("torus", [True, False])
def test_lattice_matches_jax(dims, torus):
    _assert_coo_equal(tgen.lattice(dims, torus), jgen.lattice(dims, torus))


def test_lattice_wrap_aliasing_sums_counts():
    # a 2-wide torus reaches the same neighbour by +1 and -1: counts add
    rows, cols, vals, n = tgen.lattice([2, 3], torus=True)
    assert n == 6 and vals.max() == 2


@pytest.mark.parametrize("dims,density,seed", [
    ([4, 4, 4], 0.4, 4), ([5, 5], 0.5, 1), ([2, 3], 0.5, 2),
])
def test_thin_matches_jax(dims, density, seed):
    got = tgen.thin(tgen.lattice(dims, True), density, seed=seed)
    want = jgen.thin(jgen.lattice(dims, True), density, seed=seed)
    _assert_coo_equal(got, want)


def test_headline_torus_matches_jax():
    """The 30^3 torus thinned at 3/26 with seed 42: n = 27,000, nnz = 80,882."""
    got = tgen.thin(tgen.lattice([30, 30, 30], True), 3.0 / 26.0, seed=42)
    want = jgen.thin(jgen.lattice([30, 30, 30], True), 3.0 / 26.0, seed=42)
    _assert_coo_equal(got, want)
    assert got[3] == 27_000 and len(got[0]) == 80_882


@pytest.mark.parametrize("n,m,seed", [(64, 200, 0), (2000, 2000, 3), (5, 40, 9)])
def test_random_graph_matches_jax(n, m, seed):
    _assert_coo_equal(tgen.random_graph(n, m, seed), jgen.random_graph(n, m, seed))


def test_random_graph_rejects_tiny_n():
    with pytest.raises(ValueError):
        tgen.random_graph(1, 3)


def _jax_host_csr(rows, cols, vals, n_rows, n_cols, sr_name):
    rp, ci, limbs, nnz = SparseCSR.host_csr_arrays(
        rows, cols, vals, n_rows, n_cols, SR[sr_name])
    return csr_from_jax_host(rp, ci, limbs, nnz, n_rows, n_cols, sr_name)


def _assert_csr_equal(got: HostCSR, want: HostCSR):
    np.testing.assert_array_equal(got.row_ptr, want.row_ptr)
    np.testing.assert_array_equal(got.col_idx, want.col_idx)
    assert got.vals.dtype == want.vals.dtype
    np.testing.assert_array_equal(got.vals, want.vals)
    assert (got.n_rows, got.n_cols, got.sr_name) == (want.n_rows, want.n_cols, want.sr_name)


@pytest.mark.parametrize("case", [
    # duplicates merge; doubled 2^63 saturates to u64::MAX
    ([0, 0, 1], [1, 1, 0], [1 << 63, 1 << 63, 5], 2, 2, "u64"),
    # zero entries are dropped
    ([0, 1, 2], [0, 2, 1], [0, 3, 0], 3, 3, "u64"),
    # empty
    ([], [], [], 3, 3, "u64"),
    # u32 saturation at 2^32 - 1
    ([1, 1, 0], [0, 0, 2], [3 << 30, 3 << 30, 7], 2, 3, "u32"),
    # f32 sums, including a cancellation to zero
    ([0, 1, 1, 0], [1, 0, 0, 1], [1.5, -2.0, 2.0, 0.25], 2, 2, "f32"),
    # rectangular, unsorted input
    ([3, 0, 2, 0], [1, 4, 0, 4], [1, 2, 3, 4], 4, 5, "u64"),
])
def test_host_csr_matches_jax(case):
    rows, cols, vals, n_rows, n_cols, sr_name = case
    got = HostCSR.from_coo(rows, cols, vals, n_rows, n_cols, sr_name)
    _assert_csr_equal(got, _jax_host_csr(rows, cols, vals, n_rows, n_cols, sr_name))


def test_host_csr_saturation_values():
    h = HostCSR.from_coo([0, 0, 1], [1, 1, 0], [1 << 63, 1 << 63, 5], 2)
    assert h.vals.tolist() == [0xFFFFFFFFFFFFFFFF, 5]
    assert HostCSR.from_coo([0], [0], [0], 3).nnz == 0


def test_host_csr_of_headline_torus_matches_jax():
    rows, cols, vals, n = jgen.thin(jgen.lattice([30, 30, 30], True), 3.0 / 26.0, seed=42)
    got = HostCSR.from_coo(rows, cols, vals, n)
    _assert_csr_equal(got, _jax_host_csr(rows, cols, vals, n, n, "u64"))
    assert got.nnz == 80_882


def test_host_csr_rejects_unknown_semiring():
    with pytest.raises(ValueError):
        HostCSR.from_coo([0], [0], [1], 2, sr_name="i8")
