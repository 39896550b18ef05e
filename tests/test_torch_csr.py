"""The port's device SparseCSR and sorted-segment primitives
(sparsetpu_torch.csr, sparsetpu_torch.ops.segments) against the JAX
package's (sparsetpu.csr, sparsetpu.ops.segments).

The same COO streams (numpy, fixed seeds, with duplicates and zeros) go
through both.  Tolerances: u32/u64 bit for bit; f32 1e-6 relative, since the
two packages add a segment's duplicates in different orders.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparsetpu import semiring as jsr
from sparsetpu.csr import SparseCSR as JCSR
from sparsetpu.ops import segments as jseg

from sparsetpu_torch import interop
from sparsetpu_torch import semiring as psr
from sparsetpu_torch.attention import scores
from sparsetpu_torch.csr import SparseCSR
from sparsetpu_torch.interop import sparse_csr_from_jax
from sparsetpu_torch.kernels import blocksparse
from sparsetpu_torch.ops import segments as pseg

SRS = ["u32", "u64", "f32"]


def _coo(name, n_rows=13, n_cols=11, m=96, seed=0):
    """COO with many duplicates, explicit zeros and (integers) saturating
    values."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n_rows, m)
    cols = rng.integers(0, n_cols, m)
    if name == "f32":
        vals = rng.standard_normal(m).astype(np.float32)
    else:
        top = (1 << 64) - 1 if name == "u64" else (1 << 32) - 1
        vals = rng.integers(0, 4, m).astype(np.uint64)
        vals[::7] = top - rng.integers(0, 3, len(vals[::7])).astype(np.uint64)
    vals[::5] = 0
    return rows, cols, vals, n_rows, n_cols


def _assert_same(port: SparseCSR, jax_csr: JCSR, name):
    assert int(port.nnz) == int(jax_csr.nnz)
    assert port.capacity == jax_csr.capacity
    pr, pc, pv = port.to_numpy()
    jr, jc, jv = jax_csr.to_numpy()
    np.testing.assert_array_equal(pr, jr)
    np.testing.assert_array_equal(pc, jc)
    # the padded tail too: sentinel columns and zero limbs
    np.testing.assert_array_equal(port.col_idx.numpy(), np.asarray(jax_csr.col_idx))
    if name == "f32":
        np.testing.assert_allclose(pv, jv, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(pv, jv)


@pytest.mark.parametrize("name", SRS)
def test_from_coo_device_and_host(name):
    rows, cols, vals, n_rows, n_cols = _coo(name)
    jsr_, psr_ = jsr.by_name(name), psr.by_name(name)
    want = JCSR.from_coo(rows, cols, vals, n_rows, n_cols, sr=jsr_, capacity=128)
    got = SparseCSR.from_coo(rows, cols, vals, n_rows, n_cols, sr=psr_, capacity=128,
                             device="cpu")
    _assert_same(got, want, name)
    host = SparseCSR.from_coo_host(rows, cols, vals, n_rows, n_cols, sr=psr_, capacity=128,
                                  device="cpu")
    _assert_same(host, JCSR.from_coo_host(rows, cols, vals, n_rows, n_cols, sr=jsr_,
                                          capacity=128), name)
    # host and device builds agree within the port, and with the JAX arrays
    np.testing.assert_array_equal(host.row_ptr.numpy(), got.row_ptr.numpy())
    jarr = JCSR.host_csr_arrays(rows, cols, vals, n_rows, n_cols, sr=jsr_, capacity=128)
    parr = SparseCSR.host_csr_arrays(rows, cols, vals, n_rows, n_cols, sr=psr_, capacity=128)
    for j, p in zip(jarr[:2], parr[:2]):
        np.testing.assert_array_equal(p, j)
    assert parr[3] == jarr[3]
    as_values = np.float64 if name == "f32" else np.uint64
    for j, p in zip(jarr[2], parr[2]):
        np.testing.assert_array_equal(np.asarray(p, as_values), np.asarray(j, as_values))
    # views
    np.testing.assert_array_equal(got.row_of_slot().numpy(), np.asarray(want.row_of_slot()))
    np.testing.assert_array_equal(got.row_nnz().numpy(), np.asarray(want.row_nnz()))
    for pl, jl in zip(got.to_dense(), want.to_dense()):
        np.testing.assert_allclose(pl.numpy().astype(np.float64),
                                   np.asarray(jl).astype(np.float64), rtol=1e-6)
    np.testing.assert_array_equal(got.to_dense_numpy() != 0, want.to_dense_numpy() != 0)
    # the interop copy of JAX's matrix is the same matrix, capacity and limbs
    carried = sparse_csr_from_jax(np.asarray(want.row_ptr), np.asarray(want.col_idx),
                                  [np.asarray(l) for l in want.values], int(want.nnz),
                                  n_rows, n_cols, name, device="cpu")
    _assert_same(carried, want, name)


def test_capacity_overflow_poisons():
    rows, cols, vals, n_rows, n_cols = _coo("u64")
    want = JCSR.from_coo(rows, cols, vals, n_rows, n_cols, sr=jsr.U64, capacity=8)
    got = SparseCSR.from_coo(rows, cols, vals, n_rows, n_cols, sr=psr.U64, capacity=8,
                             device="cpu")
    assert int(want.nnz) == int(got.nnz) == -1
    with pytest.raises(ValueError, match="capacity overflow"):
        got.check()
    with pytest.raises(ValueError):
        SparseCSR.from_coo_host(rows, cols, vals, n_rows, n_cols, sr=psr.U64, capacity=8,
                                device="cpu")
    ok = SparseCSR.from_coo(rows, cols, vals, n_rows, n_cols, sr=psr.U64, capacity=128,
                            device="cpu")
    assert ok.check() is ok


def test_key_wider_than_int32():
    """(n_rows + 1) * n_cols > 2^31: JAX switches to two sort keys, the port
    always sorts one int64 key; the matrices agree."""
    n_rows, n_cols = 70_000, 70_000
    assert (n_rows + 1) * n_cols > 2**31
    rows = np.array([69_999, 0, 69_999, 35_000, 0, 69_999])
    cols = np.array([69_999, 69_999, 69_999, 1, 69_999, 0])
    vals = np.array([1, 2, 3, 4, 5, 0], np.uint64)
    want = JCSR.from_coo(rows, cols, vals, n_rows, n_cols, sr=jsr.U32, capacity=8)
    got = SparseCSR.from_coo(rows, cols, vals, n_rows, n_cols, sr=psr.U32, capacity=8,
                             device="cpu")
    _assert_same(got, want, "u32")
    _, c, v = got.to_numpy()
    np.testing.assert_array_equal(c, [69_999, 1, 69_999])
    np.testing.assert_array_equal(v, [7, 4, 4])


def test_empty_with_capacity_and_memory():
    e = SparseCSR.empty(4, 5, 8, psr.U64, device="cpu")
    je = JCSR.empty(4, 5, 8, jsr.U64)
    _assert_same(e, je, "u64")
    # f32 limbs are 4 bytes in both packages; integer limbs are 8 in the port
    rows, cols, vals, n_rows, n_cols = _coo("f32")
    f = SparseCSR.from_coo_host(rows, cols, vals, n_rows, n_cols, sr=psr.F32SR, capacity=100,
                                device="cpu")
    jf = JCSR.from_coo_host(rows, cols, vals, n_rows, n_cols, sr=jsr.F32SR, capacity=100)
    assert f.memory_bytes() == jf.memory_bytes()
    assert e.memory_bytes() == 5 * 4 + 8 * (4 + 8 + 8)
    grown, shrunk = f.with_capacity(120), f.with_capacity(int(f.nnz))
    for p, j in ((grown, jf.with_capacity(120)), (shrunk, jf.with_capacity(int(jf.nnz)))):
        _assert_same(p, j, "f32")


# -- segment primitives ------------------------------------------------------

def _sorted_stream(seed=0, n=200):
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.integers(0, 40, n)).astype(np.int32)
    return rng, keys


def test_sort_by_keys_and_heads():
    rng = np.random.default_rng(1)
    k1 = rng.integers(0, 5, 100).astype(np.int32)
    k2 = rng.integers(0, 7, 100).astype(np.int32)
    pay = np.arange(100, dtype=np.int32)
    (jk1, jk2), (jp,) = jseg.sort_by_keys([jnp.asarray(k1), jnp.asarray(k2)],
                                          [jnp.asarray(pay)])
    (pk1, pk2), (pp,) = pseg.sort_by_keys([torch.from_numpy(k1), torch.from_numpy(k2)],
                                          [torch.from_numpy(pay)])
    for j, p in ((jk1, pk1), (jk2, pk2), (jp, pp)):
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))  # stable: payload order too
    np.testing.assert_array_equal(pseg.segment_heads([pk1, pk2]).numpy(),
                                  np.asarray(jseg.segment_heads([jk1, jk2])))


@pytest.mark.parametrize("name", SRS)
def test_segment_reduce_sorted(name):
    rng, keys = _sorted_stream()
    heads = np.array(jseg.segment_heads([jnp.asarray(keys)]))
    if name == "f32":
        x = rng.standard_normal(len(keys)).astype(np.float32)
    else:
        bits = 64 if name == "u64" else 32
        x = rng.integers(0, 1 << bits, len(keys), dtype=np.uint64)
    js, ps = jsr.by_name(name), psr.by_name(name)
    jt, jok = jseg.segment_reduce_sorted(js, jnp.asarray(heads), js.from_numpy(x))
    pt, pok = pseg.segment_reduce_sorted(ps, torch.from_numpy(heads), ps.from_numpy(x))
    assert bool(jok) and bool(pok)
    if name == "f32":
        np.testing.assert_allclose(ps.to_numpy(pt), js.to_numpy(jt), rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_array_equal(ps.to_numpy(pt), js.to_numpy(jt))


def test_compact_and_repeat_index():
    rng = np.random.default_rng(2)
    keep = rng.random(50) < 0.4
    a = rng.integers(0, 100, 50).astype(np.int32)
    for out_size in (10, 40):
        (ja,), jc = jseg.compact(jnp.asarray(keep), [jnp.asarray(a)], [-7], out_size)
        (pa,), pc = pseg.compact(torch.from_numpy(keep), [torch.from_numpy(a)], [-7], out_size)
        np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
        assert int(pc) == int(jc) == int(keep.sum())
    # non-decreasing starts with repeats (empty segments) and a start past the end
    starts = np.array([0, 0, 3, 3, 7, 12, 20, 20])
    vals = np.arange(8)
    for length in (15, 25):
        want = jseg.repeat_index(jnp.asarray(starts, jnp.int32), jnp.asarray(vals, jnp.int32),
                                 length)
        got = pseg.repeat_index(torch.from_numpy(starts), torch.from_numpy(vals), length)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = pseg.repeat_index(torch.tensor([2, 4]), torch.tensor([5, 9]), 6, fill=-3)
    np.testing.assert_array_equal(got.numpy(), [-3, -3, 5, 5, 9, 9])


@pytest.mark.parametrize("name", SRS + ["u64-narrow"])
def test_reduce_sorted_coo(name):
    rng, keys = _sorted_stream(seed=3)
    n = len(keys)
    valid = np.ones(n, bool)
    valid[-20:] = False
    keys = np.where(valid, keys, int(pseg.INT32_SENTINEL)).astype(np.int32)
    sr_name = "u64" if name == "u64-narrow" else name
    js, ps = jsr.by_name(sr_name), psr.by_name(sr_name)
    if name == "f32":
        x = rng.standard_normal(n).astype(np.float32)
    elif name == "u64-narrow":
        x = rng.integers(0, 1 << 31, n, dtype=np.uint64)
    else:
        x = rng.integers(0, 1 << (64 if name == "u64" else 32), n, dtype=np.uint64)
    x[::6] = 0
    jv, pv = js.from_numpy(x), ps.from_numpy(x)
    if name == "u64-narrow":  # one limb: the merge rebuilds hi from the carries
        jv, pv = jv[:1], pv[:1]
    for out_size in (n, 8):
        (jk,), jt, jc = jseg.reduce_sorted_coo(js, [jnp.asarray(keys)], jv,
                                               jnp.asarray(valid), out_size,
                                               key_fills=[jseg.INT32_SENTINEL])
        (pk,), pt, pc = pseg.reduce_sorted_coo(ps, [torch.from_numpy(keys)], pv,
                                               torch.from_numpy(valid), out_size,
                                               key_fills=[pseg.INT32_SENTINEL])
        assert int(pc) == int(jc)
        np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
        if name == "f32":
            np.testing.assert_allclose(ps.to_numpy(pt), js.to_numpy(jt), rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(ps.to_numpy(pt), js.to_numpy(jt))


def test_segment_of_2_16_nonzeros_diverges_on_purpose():
    """A segment of 2^16 nonzero duplicates: the JAX package's 16-bit planes
    lose exactness there and it poisons nnz to -1; the port's int64 sums stay
    exact (ROADMAP.md queue 3 records the divergence)."""
    m = (1 << 16) + 1
    rows, cols = np.zeros(m, np.int64), np.zeros(m, np.int64)
    vals = np.full(m, 3, np.uint64)
    want = JCSR.from_coo(rows, cols, vals, 2, 2, sr=jsr.U32, capacity=4)
    assert int(want.nnz) == -1
    got = SparseCSR.from_coo(rows, cols, vals, 2, 2, sr=psr.U32, capacity=4, device="cpu")
    assert int(got.check().nnz) == 1
    assert int(got.to_numpy()[2][0]) == 3 * m
    # the host merges of both packages are exact too
    assert int(JCSR.from_coo_host(rows, cols, vals, 2, 2, sr=jsr.U32).nnz) == 1


_DEFAULT_DEVICE_CALLS = {
    "SparseCSR.empty": lambda: SparseCSR.empty(4, 5, 8, psr.U64),
    "SparseCSR.identity": lambda: SparseCSR.identity(4),
    "SparseCSR.from_coo": lambda: SparseCSR.from_coo([0, 1], [1, 0], [1, 2], 2),
    "SparseCSR.from_host_arrays": lambda: SparseCSR.from_host_arrays(
        [0, 1, 1], [0], [np.ones(1, np.uint64), np.zeros(1, np.uint64)], 1, 2, 2, psr.U64),
    "SparseCSR.from_coo_host": lambda: SparseCSR.from_coo_host([0, 1], [1, 0], [1, 2], 2),
    "scores.tensor_to_grouped_csr": lambda: scores.tensor_to_grouped_csr(
        np.ones((1, 2, 2, 3), np.float32)),
    "BlockSparseMatrix.from_dense": lambda: blocksparse.BlockSparseMatrix.from_dense(
        np.ones((128, 128), np.float32)),
    "blocksparse.attention_block_operands": lambda: blocksparse.attention_block_operands(
        np.ones((1, 2, 2, 8), np.float32), np.ones((1, 2, 2, 8), np.float32)),
    "blocksparse.block_sparse_attention_scores":
        lambda: blocksparse.block_sparse_attention_scores(
            np.ones((1, 2, 2, 8), np.float32), np.ones((1, 2, 2, 8), np.float32)),
    "interop.sparse_csr_from_jax": lambda: interop.sparse_csr_from_jax(
        [0, 1, 1], [0], [np.ones(1, np.uint32), np.zeros(1, np.uint32)], 1, 2, 2, "u64"),
    "interop.block_sparse_from_jax": lambda: interop.block_sparse_from_jax(
        np.ones((1, 128, 128), np.float32), [0], [0], (128, 128), (128, 128)),
}


@pytest.mark.parametrize("name", list(_DEFAULT_DEVICE_CALLS))
def test_entry_points_default_to_the_card(monkeypatch, name):
    """Called without a device, the entry points build on the card; where
    there is none they raise, and never fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card.*device='cpu'"):
        _DEFAULT_DEVICE_CALLS[name]()
