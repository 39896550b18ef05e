"""The port's ``GroupedCSR`` (``sparsetpu_torch.grouped``) against the JAX
package's (``sparsetpu.grouped``), on the CPU.

The same seeded (g, n, m) tensors go through both: ``from_dense`` /
``from_coo`` (the whole flat CSR, padding and capacity included),
``to_dense``, ``transpose`` and ``matmul`` (one flat ESC SpGEMM at the
power-of-two capacity of its product count), on f32, u32 and u64 with
saturating values.  Tolerance: none (f32 values are small integers).
"""

import numpy as np
import pytest
import torch

from sparsetpu import semiring as jsr
from sparsetpu.grouped import GroupedCSR as JG

from sparsetpu_torch import semiring as psr
from sparsetpu_torch.grouped import GroupedCSR
from sparsetpu_torch.interop import grouped_from_jax

SRS = ("f32", "u32", "u64")


def _batched(g, n, m, seed, sr_name, density=0.4):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 4, size=(g, n, m)).astype(np.uint64)
    if sr_name == "u64":
        x[rng.random((g, n, m)) < 0.1] = (1 << 63) + 5
    elif sr_name == "u32":
        x[rng.random((g, n, m)) < 0.1] = (1 << 31) + 5
    x *= (rng.random((g, n, m)) < density).astype(np.uint64)
    return x.astype(np.float32) if sr_name == "f32" else x


def _assert_same_flat(got: GroupedCSR, want: JG):
    """(g, n, m) and the whole flat CSR equal, padding included."""
    assert got.shape == want.shape
    f, w = got.flat, want.flat
    assert int(f.nnz) == int(w.nnz) and f.capacity == w.capacity and f.shape == w.shape
    np.testing.assert_array_equal(f.row_ptr.numpy(), np.asarray(w.row_ptr))
    np.testing.assert_array_equal(f.col_idx.numpy(), np.asarray(w.col_idx))
    for a, b in zip(f.values, w.values):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(a.numpy().dtype))


@pytest.mark.parametrize("sr_name", SRS)
def test_from_dense_and_to_dense_match_jax(sr_name):
    x = _batched(3, 4, 5, 0, sr_name)
    got = GroupedCSR.from_dense(x, sr=psr.by_name(sr_name), device="cpu")
    want = JG.from_dense(x, sr=jsr.by_name(sr_name))
    _assert_same_flat(got, want)
    np.testing.assert_array_equal(got.to_dense(), want.to_dense())
    np.testing.assert_array_equal(got.to_dense(), x)


@pytest.mark.parametrize("sr_name", SRS)
def test_from_coo_with_duplicates_and_a_capacity_matches_jax(sr_name):
    rng = np.random.default_rng(1)
    g, n, m, k = 4, 3, 6, 40
    b, r, c = rng.integers(0, g, k), rng.integers(0, n, k), rng.integers(0, m, k)
    v = rng.integers(1, 9, k).astype(np.uint64)
    if sr_name != "f32":
        v[::5] = (1 << 63) if sr_name == "u64" else (1 << 31)
    got = GroupedCSR.from_coo(b, r, c, v, g, n, m, sr=psr.by_name(sr_name), capacity=64,
                              device="cpu")
    want = JG.from_coo(b, r, c, v, g, n, m, sr=jsr.by_name(sr_name), capacity=64)
    _assert_same_flat(got, want)


@pytest.mark.parametrize("sr_name", SRS)
def test_matmul_matches_jax(sr_name):
    a, b = _batched(3, 4, 5, 2, sr_name), _batched(3, 5, 6, 3, sr_name)
    psr_, jsr_ = psr.by_name(sr_name), jsr.by_name(sr_name)
    got = GroupedCSR.from_dense(a, sr=psr_, device="cpu").matmul(
        GroupedCSR.from_dense(b, sr=psr_, device="cpu"))
    want = JG.from_dense(a, sr=jsr_).matmul(JG.from_dense(b, sr=jsr_))
    _assert_same_flat(got, want)
    ref = np.einsum("bij,bjk->bik", a.astype(object), b.astype(object))
    if sr_name != "f32":
        ref = np.minimum(ref, (1 << (64 if sr_name == "u64" else 32)) - 1)
    np.testing.assert_array_equal(got.to_dense().astype(object), ref)


@pytest.mark.parametrize("sr_name", SRS)
def test_transpose_matches_jax(sr_name):
    x = _batched(2, 3, 4, 4, sr_name)
    got = GroupedCSR.from_dense(x, sr=psr.by_name(sr_name), device="cpu").transpose()
    want = JG.from_dense(x, sr=jsr.by_name(sr_name)).transpose()
    _assert_same_flat(got, want)
    np.testing.assert_array_equal(got.to_dense(), np.swapaxes(x, 1, 2))


def test_carried_from_jax_and_shape_checks():
    x = _batched(2, 3, 4, 5, "u64")
    j = JG.from_dense(x, sr=jsr.U64, capacity=32)
    got = grouped_from_jax(j.flat.row_ptr, j.flat.col_idx,
                           [np.asarray(l) for l in j.flat.values], j.flat.nnz, "u64",
                           j.g, j.n, j.m, device="cpu")
    _assert_same_flat(got, j)
    with pytest.raises(ValueError, match="do not chain"):
        got.matmul(got)
    with pytest.raises(ValueError, match="3-D"):
        GroupedCSR.from_dense(np.ones((2, 2)), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            GroupedCSR.from_dense(x)
