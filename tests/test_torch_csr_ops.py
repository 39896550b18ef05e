"""The port's last five SparseCSR methods (``from_dense_device``,
``from_dense_numpy``, ``get``, ``lookup``, ``transpose``) against the JAX
package's, on the CPU.

The same numpy matrices (fixed seeds, saturated u32/u64 values) go through
both.  Tolerance: bit for bit on every semiring (these methods move values
and add none), the whole CSR compared, its padded tail and a poisoned nnz
included.
"""

import doctest

import numpy as np
import pytest

import jax.numpy as jnp

from sparsetpu import semiring as jsr
from sparsetpu.csr import SparseCSR as JCSR

from sparsetpu_torch import semiring as psr
from sparsetpu_torch.csr import SparseCSR

SRS = ["u32", "u64", "f32"]


def _dense(name, n=9, m=13, seed=3):
    """A dense (n, m) matrix, about a third nonzero, with saturated values
    on the integer semirings."""
    rng = np.random.default_rng(seed)
    keep = rng.random((n, m)) < 0.35
    if name == "f32":
        vals = rng.standard_normal((n, m)).astype(np.float32)
    else:
        top = (1 << 64) - 1 if name == "u64" else (1 << 32) - 1
        vals = rng.integers(1, 1000, (n, m)).astype(np.uint64)
        vals[::3, ::4] = top
    return np.where(keep, vals, 0).astype(vals.dtype)


def _assert_same(got: SparseCSR, want: JCSR):
    """Every field equal: nnz, capacity, row_ptr, col_idx (padding included)
    and each limb (the port's int64 limbs hold JAX's uint32 ones)."""
    assert int(got.nnz) == int(want.nnz)
    assert got.capacity == want.capacity and got.shape == want.shape
    np.testing.assert_array_equal(got.row_ptr.numpy(), np.asarray(want.row_ptr))
    np.testing.assert_array_equal(got.col_idx.numpy(), np.asarray(want.col_idx))
    assert len(got.values) == len(want.values)
    for g, w in zip(got.values, want.values):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(g.numpy().dtype))


def _pair(name, dense, capacity=None):
    want = JCSR.from_dense_numpy(dense, jsr.by_name(name), capacity=capacity)
    got = SparseCSR.from_dense_numpy(dense, psr.by_name(name), capacity=capacity,
                                     device="cpu")
    return got, want


@pytest.mark.parametrize("name,capacity", [(name, None) for name in SRS] + [("u64", 64)])
def test_from_dense_device_matches_jax(name, capacity):
    """Without a capacity (sized to the nonzeros, one fetch) and padded."""
    dense = _dense(name)
    want = JCSR.from_dense_device(jsr.by_name(name).from_numpy(dense), jsr.by_name(name),
                                  capacity=capacity)
    got = SparseCSR.from_dense_device(psr.by_name(name).from_numpy(dense),
                                      psr.by_name(name), capacity=capacity)
    _assert_same(got, want)
    assert int(got.nnz) == int(np.count_nonzero(dense))
    np.testing.assert_array_equal(got.to_dense_numpy(), dense)


@pytest.mark.parametrize("name", SRS)
def test_from_dense_device_poisons_an_undersized_capacity(name):
    dense = _dense(name)
    cap = int(np.count_nonzero(dense)) - 3
    want = JCSR.from_dense_device(jsr.by_name(name).from_numpy(dense), jsr.by_name(name),
                                  capacity=cap)
    got = SparseCSR.from_dense_device(psr.by_name(name).from_numpy(dense),
                                      psr.by_name(name), capacity=cap)
    assert int(want.nnz) == -1
    _assert_same(got, want)  # the truncated entries too
    with pytest.raises(ValueError):
        got.check()


def test_from_dense_device_of_an_all_zero_matrix():
    dense = np.zeros((4, 6), np.uint64)
    want = JCSR.from_dense_device(jsr.U64.from_numpy(dense), jsr.U64)
    got = SparseCSR.from_dense_device(psr.U64.from_numpy(dense), psr.U64)
    _assert_same(got, want)


@pytest.mark.parametrize("name,capacity", [(name, 64) for name in SRS] + [("u64", None)])
def test_from_dense_numpy_matches_jax(name, capacity):
    got, want = _pair(name, _dense(name), capacity)
    _assert_same(got, want)


@pytest.mark.parametrize("name", SRS)
def test_get_matches_jax(name):
    dense = _dense(name)
    got, want = _pair(name, dense, capacity=64)
    for r in range(dense.shape[0]):
        for c in range(dense.shape[1]):
            g, w = got.get(r, c), want.get(r, c)
            assert g == w == dense[r, c], (r, c)
            assert type(g) is type(w)


@pytest.mark.parametrize("name", SRS)
def test_lookup_matches_jax(name):
    dense = _dense(name)
    n, m = dense.shape
    got, want = _pair(name, dense, capacity=64)  # padded tail in the search
    rng = np.random.default_rng(9)
    rows = np.concatenate([rng.integers(0, n, 60), [-1, n, n + 5, -7, 0, n - 1]])
    cols = np.concatenate([rng.integers(0, m, 60), [0, 0, 3, 2, m - 1, m - 1]])
    g = got.lookup(rows, cols)
    w = want.lookup(jnp.asarray(rows, jnp.int32), jnp.asarray(cols, jnp.int32))
    for gl, wl in zip(g, w):
        np.testing.assert_array_equal(gl.numpy(), np.asarray(wl).astype(gl.numpy().dtype))
    vals = psr.by_name(name).to_numpy(g)
    inside = (rows >= 0) & (rows < n)
    np.testing.assert_array_equal(vals[inside], dense[rows[inside], cols[inside]])
    assert not vals[~inside].any()  # rows out of range read zero


@pytest.mark.parametrize("name,capacity", [(name, None) for name in SRS] + [("u64", 128)])
def test_transpose_matches_jax(name, capacity):
    """At the matrix's own capacity (padded) and at a larger one."""
    dense = _dense(name)
    got, want = _pair(name, dense, capacity=64)
    t_got, t_want = got.transpose(capacity=capacity), want.transpose(capacity=capacity)
    _assert_same(t_got, t_want)
    np.testing.assert_array_equal(t_got.to_dense_numpy(), dense.T)


def test_package_doctest():
    """sparsetpu_torch's docstring runs the JAX package's doctest on the
    CPU, ``get`` included."""
    import sparsetpu_torch

    results = doctest.testmod(sparsetpu_torch, verbose=False)
    assert results.attempted >= 10 and results.failed == 0
