"""The port's column-chunked SpGEMM (sparsetpu_torch.ops.colchunk) against
the JAX package's (sparsetpu.ops.colchunk), and against the C++ oracle.

Tolerance: exact, the whole CSR bit for bit (u64).  The slot budgets are
tests/test_colchunk.py's, small enough that K >= 2 chunks engage the
per-chunk slab plans and the row interleave (on smaller graphs than its ER and
power-law ones: fewer chunks, the same paths); one budget lets a single
chunk delegate to ``spgemm_slab``.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from sparsetpu import U64 as JU64
from sparsetpu.csr import SparseCSR as JCSR
from sparsetpu.graphs import datasets as jdata, generate as jgen
from sparsetpu.ops import colchunk as jcc

from sparsetpu_torch import native
from sparsetpu_torch.interop import sparse_csr_from_jax
from sparsetpu_torch.ops import colchunk


def _jcsr(rows, cols, vals, n, m=None):
    return JCSR.from_coo_host(np.asarray(rows), np.asarray(cols), np.asarray(vals), n,
                              m if m is not None else n, sr=JU64)


def _carry(j: JCSR, device="cpu"):
    return sparse_csr_from_jax(j.row_ptr, j.col_idx, [np.asarray(x) for x in j.values],
                               j.nnz, j.n_rows, j.n_cols, j.sr_name, device)


def _rectangular():
    rng = np.random.default_rng(11)
    n, kk, m = 80, 50, 120
    ja = _jcsr(rng.integers(0, n, 400), rng.integers(0, kk, 400),
               rng.integers(1, 1000, 400).astype(np.uint64), n, kk)
    jb = _jcsr(rng.integers(0, kk, 500), rng.integers(0, m, 500),
               rng.integers(1, 1000, 500).astype(np.uint64), kk, m)
    return ja, jb


def _hub():
    # one hub row whose products in a chunk overfill a block: the wide pass
    rng = np.random.default_rng(2)
    n = 600
    hub_cols = np.arange(1, n, 2)
    rows = np.concatenate([np.zeros(len(hub_cols), np.int64), rng.integers(0, n, 800)])
    cols = np.concatenate([hub_cols, rng.integers(0, n, 800)])
    ja = _jcsr(rows, cols, np.ones(len(rows), np.uint64), n)
    return ja, ja


def _square(make):
    def build():
        ja = _jcsr(*make())
        return ja, ja
    return build


# name -> (operands, slot_budget, l, chunks)
CASES = {
    "er": (_square(lambda: jgen.random_graph(150, 1200, seed=7)), 4096, 1 << 15, 9),
    "single-chunk": (_square(lambda: jgen.random_graph(60, 240, seed=3)), 1 << 22, 1 << 15, 1),
    "rectangular-values": (_rectangular, 2048, 1 << 15, 8),
    "powerlaw": (_square(lambda: jdata.power_law(200, 4, seed=5)), 8192, 1 << 15, 10),
    "wide-hub-rows": (_hub, 4096, 1024, 2),
}


@pytest.mark.parametrize("name", list(CASES))
def test_colchunk_matches_jax_and_oracle(name):
    make, budget, l, chunks = CASES[name]
    ja, jb = make()
    a, b = _carry(ja), _carry(jb)
    bnd, fk = colchunk.plan_chunks(a, b, budget)
    jbnd, jfk = jcc.plan_chunks(ja, jb, budget)
    np.testing.assert_array_equal(bnd, jbnd)
    np.testing.assert_array_equal(fk, jfk)
    assert len(bnd) - 1 == chunks
    got = colchunk.spgemm_colchunk(a, b, slot_budget=budget, l=l).check()
    want = jcc.spgemm_colchunk(ja, jb, slot_budget=budget, l=l)
    assert int(got.nnz) == int(want.nnz) and got.capacity == want.capacity
    np.testing.assert_array_equal(got.row_ptr.numpy(), np.asarray(want.row_ptr))
    np.testing.assert_array_equal(got.col_idx.numpy(), np.asarray(want.col_idx))
    for g, w in zip(got.values, want.values):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int64))
    if a.shape != b.shape or a.n_rows != a.n_cols:
        # the oracle takes square operands; small values: the dense product is exact
        want = a.to_dense_numpy() @ b.to_dense_numpy()
        np.testing.assert_array_equal(got.to_dense_numpy(), want)
        return
    oracle = native.spgemm(native.as_host_csr(*a.to_numpy()),
                           native.as_host_csr(*b.to_numpy()), a.n_rows)
    for g, w in zip(got.to_numpy(), oracle):
        np.testing.assert_array_equal(np.asarray(g).astype(np.int64), w.astype(np.int64))


def test_col_flops_count_in_int64():
    ja, jb = _rectangular()
    got = colchunk._col_flops(_carry(ja), _carry(jb))
    assert got.dtype == torch.int64  # JAX's int32 wraps past 2^31 a column
    np.testing.assert_array_equal(got.numpy(), np.asarray(jcc._col_flops(ja, jb)))


def test_poison_propagates():
    ja = _jcsr(*jgen.random_graph(60, 240, seed=3)[:3], 60)
    a = _carry(ja)
    bad = dataclasses.replace(a, nnz=torch.tensor(-1))
    jbad = dataclasses.replace(ja, nnz=jnp.asarray(-1, jnp.int32))
    for x, y in ((a, bad), (bad, a)):
        out = colchunk.spgemm_colchunk(x, y, slot_budget=1024)
        assert int(out.nnz) == -1
        with pytest.raises(ValueError):
            out.check()
    assert int(jcc.spgemm_colchunk(ja, jbad, slot_budget=1024).nnz) < 0


@pytest.mark.cuda
def test_cuda_colchunk_matches_jax():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ja, jb = _hub()
    got = colchunk.spgemm_colchunk(_carry(ja, "cuda"), _carry(jb, "cuda"), slot_budget=4096,
                                   l=1024)
    want = jcc.spgemm_colchunk(ja, jb, slot_budget=4096, l=1024)
    assert int(got.nnz) == int(want.nnz)
    np.testing.assert_array_equal(got.col_idx.cpu().numpy(), np.asarray(want.col_idx))
    for g, w in zip(got.values, want.values):
        np.testing.assert_array_equal(g.cpu().numpy(), np.asarray(w).astype(np.int64))
