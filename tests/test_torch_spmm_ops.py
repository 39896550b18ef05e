"""The port's plain-torch SpMM ops (sparsetpu_torch.ops.spmm) against the JAX
package's (sparsetpu.ops.spmm), on the CPU.

Tolerance: exact.  The operands are integer counts below 2^24 carried in
f32 (every order of the sums is exact) or the saturating u32/u64 limbs,
compared bit for bit.  The one divergence kept on purpose is pinned here:
``spmm_csr_dense_exact`` on a row of 2^16 - 1 entries or more, where JAX
reports ``exact_ok`` False and the port sums exactly.
"""

import numpy as np
import pytest
import torch

from sparsetpu import F32SR as JF32, U32 as JU32, U64 as JU64
from sparsetpu.csr import SparseCSR as JCSR
from sparsetpu.graphs.generate import lattice, random_graph
from sparsetpu.ops import spmm as jspmm

from sparsetpu_torch.interop import carry_csr
from sparsetpu_torch.ops import spmm
from sparsetpu_torch.semiring import U32, U64

GRAPHS = {
    "torus5": lambda: lattice((5, 5, 5), True),
    "random100": lambda: random_graph(100, 700, seed=3),
}


@pytest.fixture(scope="module", params=list(GRAPHS))
def case(request):
    rows, cols, vals, n = GRAPHS[request.param]()
    j = JCSR.from_coo_host(rows, cols, vals, n, sr=JU64)
    p = np.random.default_rng(7).integers(0, 5, (n, 33)).astype(np.float32)
    return j, carry_csr(j, "cpu"), p


def test_chunked_spmm_matches_jax(case):
    j, a, p = case
    pn = np.random.default_rng(1).integers(0, 5, (a.n_rows, a.n_rows)).astype(np.float32)
    *jop, jrpc = jspmm.prepare_spmm_operand(j, n_chunks=3)
    jc = jspmm.spmm_dense(*jop, pn, rows_per_chunk=jrpc)
    cols, vals, lrow, rpc = spmm.prepare_spmm_operand(a, n_chunks=3)
    assert rpc == -(-a.n_rows // 3) and cols.shape[0] == 3
    got = spmm.spmm_dense(cols, vals, lrow, torch.from_numpy(pn), rows_per_chunk=rpc)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jc))


def test_csr_dense_matches_jax_in_2d_and_1d(case):
    j, a, p = case
    np.testing.assert_array_equal(spmm.spmm_csr_dense(a, torch.from_numpy(p)).numpy(),
                                  np.asarray(jspmm.spmm_csr_dense(j, p)))
    v = p[:, 0].copy()
    np.testing.assert_array_equal(spmm.spmm_csr_dense(a, torch.from_numpy(v)).numpy(),
                                  np.asarray(jspmm.spmm_csr_dense(j, v)))
    with pytest.raises(ValueError):
        spmm.spmm_csr_dense(a, torch.zeros(a.n_cols + 1, 2))


def test_dense_to_csr_matches_jax(case):
    j, a, p = case
    dense = spmm.spmm_csr_dense(a, torch.from_numpy(p))
    got = spmm.dense_to_csr(dense, U64)
    want = jspmm.dense_to_csr(np.asarray(dense), JU64)
    assert int(got.nnz) == int(want.nnz) and got.capacity == want.capacity
    for g, w in zip(got.to_numpy(), want.to_numpy()):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("sr_name", ["u32", "u64"])
def test_exact_spmm_matches_jax_with_saturation(sr_name):
    """Values up to 2^40 (u64) or 2^31 (u32): the saturating multiply and
    add must agree limb for limb, saturated entries included."""
    rng = np.random.default_rng(3)
    rows, cols, _, n = random_graph(60, 300, seed=9)
    top = (1 << 40) if sr_name == "u64" else (1 << 31)
    vals = rng.integers(1, top, len(rows), dtype=np.uint64)
    jsr, sr = (JU64, U64) if sr_name == "u64" else (JU32, U32)
    j = JCSR.from_coo_host(rows, cols, vals, n, sr=jsr)
    a = carry_csr(j, "cpu")
    d = rng.integers(0, top, (n, 7), dtype=np.uint64)
    d[:3] = np.iinfo(np.uint64).max if sr_name == "u64" else (1 << 32) - 1
    want, ok = jspmm.spmm_csr_dense_exact(j, jsr.from_numpy(d))
    got, ok_t = spmm.spmm_csr_dense_exact(a, sr.from_numpy(d, device="cpu"))
    assert bool(ok) and bool(ok_t)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int64))


def test_exact_row_past_2_16_diverges_on_purpose():
    """One row of 65,535 entries: JAX's 16-bit planes flag it (exact_ok
    False); the port's int64 limb sums return the exact sum and True."""
    k = (1 << 16) - 1
    j = JCSR.from_coo_host(np.zeros(k, np.int64), np.arange(k), np.full(k, 3, np.uint64), 1, k,
                           sr=JU64)
    d = np.full((k, 1), 5, np.uint64)
    _, ok = jspmm.spmm_csr_dense_exact(j, JU64.from_numpy(d))
    assert not bool(ok)
    got, ok_t = spmm.spmm_csr_dense_exact(carry_csr(j, "cpu"), U64.from_numpy(d, device="cpu"))
    assert bool(ok_t)
    assert U64.to_numpy(got)[0, 0] == 15 * k
    f32 = carry_csr(JCSR.from_coo_host([0], [0], [1.0], 1, sr=JF32), "cpu")
    with pytest.raises(ValueError, match="u32/u64"):
        spmm.spmm_csr_dense_exact(f32, (torch.ones(1, 1),))


def test_value_guard_in_both_packages():
    j = JCSR.from_coo_host([0, 1], [1, 0], np.array([1 << 24, 1], np.uint64), 2, sr=JU64)
    with pytest.raises(ValueError, match="2\\^24"):
        jspmm.prepare_spmm_operand(j)
    with pytest.raises(ValueError, match="2\\^24"):
        spmm.prepare_spmm_operand(carry_csr(j, "cpu"))
    with pytest.raises(ValueError, match="n_chunks"):
        spmm.prepare_spmm_operand(carry_csr(j, "cpu"), n_chunks=0)
