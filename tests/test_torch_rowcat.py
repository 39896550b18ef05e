"""The port's row-categorized SpGEMM (sparsetpu_torch.ops.rowcat) against
the JAX package's (sparsetpu.ops.rowcat), on operands carried across from
JAX's CSR with ``interop.sparse_csr_from_jax``.

Each JAX product is computed once per graph.  Tolerances: u64 bit for bit;
f32 1e-5 relative (the packages add a column's products in different
orders).  The overflow hub row (past every slab threshold) is held against
JAX's plan and an exact numpy product, as tests/test_rowcat.py holds JAX's.
"""

import functools

import numpy as np
import pytest
import torch

from sparsetpu import F32SR as JF32, U64 as JU64
from sparsetpu.csr import SparseCSR as JCSR
from sparsetpu.graphs import datasets as jdata, generate as jgen
from sparsetpu.ops import rowcat as jrc

from sparsetpu_torch.csr import SparseCSR
from sparsetpu_torch.interop import sparse_csr_from_jax
from sparsetpu_torch.kernels import sortmerge
from sparsetpu_torch.ops import rowcat as prc
from sparsetpu_torch.ops.spgemm import spgemm, symbolic_flops_exact
from sparsetpu_torch.semiring import U64


def _jcsr(rows, cols, vals, n, m=None, sr=JU64):
    return JCSR.from_coo_host(np.asarray(rows), np.asarray(cols), np.asarray(vals), n,
                              m if m is not None else n, sr=sr)


def _carry(j: JCSR, device="cpu") -> SparseCSR:
    return sparse_csr_from_jax(j.row_ptr, j.col_idx, [np.asarray(x) for x in j.values],
                               j.nnz, j.n_rows, j.n_cols, j.sr_name, device)


def _rect():
    rng = np.random.default_rng(5)
    a = _jcsr(rng.integers(0, 30, 90), rng.integers(0, 50, 90),
              rng.integers(1, 4, 90).astype(np.uint64), 30, 50)
    b = _jcsr(rng.integers(0, 50, 80), rng.integers(0, 20, 80),
              rng.integers(1, 4, 80).astype(np.uint64), 50, 20)
    return a, b


def _f32():
    rng = np.random.default_rng(7)
    a = _jcsr(rng.integers(0, 20, 60), rng.integers(0, 20, 60),
              rng.standard_normal(60).astype(np.float32), 20, sr=JF32)
    return a, a


def _saturating():
    big = np.uint64((1 << 63) + 11)
    a = _jcsr([0, 0, 1], [0, 1, 0], np.array([big, 7, 3], np.uint64), 2)
    return a, a


GRAPHS = {
    "random60x300": lambda: (lambda a: (a, a))(_jcsr(*jgen.random_graph(60, 300, seed=0)[:3], 60)),
    "powerlaw400": lambda: (lambda a: (a, a))(_jcsr(*jdata.power_law(400, 6, seed=3)[:3], 400)),
    "rectangular": _rect,
    "saturating": _saturating,
    "f32": _f32,
}


@functools.lru_cache(maxsize=None)
def _jax_product(graph):
    """(JAX operands, JAX's rowcat product): computed once per graph."""
    a, b = GRAPHS[graph]()
    return a, b, jrc.spgemm_rowcat(a, b).check()


def _assert_same(got: SparseCSR, want: JCSR, rtol=0.0):
    assert int(got.check().nnz) == int(want.nnz)
    pr, pc, pv = got.to_numpy()
    jr, jc, jv = want.to_numpy()
    np.testing.assert_array_equal(pr, jr)
    np.testing.assert_array_equal(pc, jc)
    if rtol:
        np.testing.assert_allclose(pv, jv, rtol=rtol, atol=1e-6)
    else:
        np.testing.assert_array_equal(pv, jv)


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("graph", list(GRAPHS))
def test_rowcat_matches_jax(graph, use_kernel):
    ja, jb, want = _jax_product(graph)
    got = prc.spgemm_rowcat(_carry(ja), _carry(jb), use_kernel=use_kernel)
    _assert_same(got, want, rtol=1e-5 if graph == "f32" else 0.0)
    if graph == "f32":
        dense = ja.to_dense_numpy().astype(np.float64)
        np.testing.assert_allclose(got.to_dense_numpy(), dense @ dense, rtol=1e-5, atol=1e-6)


def test_plan_matches_jax_on_power_law():
    ja, _, _ = _jax_product("powerlaw400")
    a = _carry(ja)
    got = prc.plan(a, a)
    want = jrc.plan(ja, ja)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int((got[3][:, 0] > 0).sum()) >= 2, "power-law must fill several categories"
    cats = prc.rowcat_config(a, a)[3]
    assert [L for L, *_ in cats] == [L for L, *_ in jrc.rowcat_config(ja, ja)[3]]


def test_thinned_chain_matches_jax():
    rows, cols, vals, n = jgen.thin(jgen.lattice([5, 5], torus=True), 0.4, seed=1)
    ja = _jcsr(rows, cols, vals, n)
    j1 = jrc.spgemm_rowcat(ja, ja).check()
    j2 = jrc.spgemm_rowcat(j1, ja).check()
    a = _carry(ja)
    c1 = prc.spgemm_rowcat(a, a)
    _assert_same(c1, j1)
    _assert_same(prc.spgemm_rowcat(c1, a), j2)


def test_identity_matches_jax():
    eye = SparseCSR.identity(12, device="cpu")
    j = JCSR.identity(12)
    np.testing.assert_array_equal(eye.row_ptr.numpy(), np.asarray(j.row_ptr))
    np.testing.assert_array_equal(eye.col_idx.numpy(), np.asarray(j.col_idx))
    for p, w in zip(eye.values, j.values):
        np.testing.assert_array_equal(p.numpy(), np.asarray(w))
    got = prc.spgemm_rowcat(eye, eye)
    assert int(got.check().nnz) == 12
    np.testing.assert_array_equal(got.to_dense_numpy(), np.eye(12, dtype=np.uint64))


def test_overflow_hub_row_takes_esc_and_spadd():
    """A hub row past the largest slab threshold goes through _esc_rows and
    is merged with spadd: JAX's plan, then the exact product.  Row 0 reaches
    300 rows of 260 entries each (78,000 products); their columns are empty
    rows, so no other row leaves the first category."""
    rng = np.random.default_rng(11)
    n = 700
    hub_cols = np.arange(1, 301)
    rows = [np.zeros(300, np.int64)] + [np.full(260, k, np.int64) for k in hub_cols]
    cols = [hub_cols.astype(np.int64)] + [rng.choice(np.arange(301, n), 260, replace=False)
                                          for _ in hub_cols]
    r, c = np.concatenate(rows), np.concatenate(cols)
    ja = _jcsr(r, c, np.ones(len(r), np.uint64), n)
    a = _carry(ja)
    got_plan, want_plan = prc.plan(a, a), jrc.plan(ja, ja)
    for g, w in zip(got_plan, want_plan):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got_plan[3][-1, 0]) >= 1
    assert prc.rowcat_config(a, a)[4] > 0  # the overflow capacity
    got = prc.spgemm_rowcat(a, a).check()
    ad = ja.to_dense_numpy().astype(np.int64)
    np.testing.assert_array_equal(got.to_dense_numpy().astype(np.int64), ad @ ad)
    flops = symbolic_flops_exact(a, a)
    esc = spgemm(a, a, 1 << (flops - 1).bit_length())
    np.testing.assert_array_equal(got.to_dense_numpy(), esc.to_dense_numpy())


def test_kernel_route_and_routes_by_shape():
    assert prc.kernel_route(16384, 2, True) and not prc.kernel_route(65536, 2, True)
    assert not prc.kernel_route(64, 1, False)
    cats = ((64, 8, 5, 0), (65536, 8, 1, 5))
    a = SparseCSR.identity(4, sr=U64, device="cpu")
    assert prc.category_routes(a, cats) == [(64, 5, "sortmerge_rows"), (65536, 1, "batched")]
    assert prc.category_routes(a, cats, use_kernel=False)[0][2] == "batched"


def test_shape_mismatch_raises():
    a = SparseCSR.identity(4, device="cpu")
    with pytest.raises(ValueError):
        prc.spgemm_rowcat(a, SparseCSR.identity(5, device="cpu"))


@pytest.mark.cuda
def test_cuda_rowcat_kernel_route_matches_batched():
    """On the card: the sort-merge kernel route against the batched route
    and the CPU result, on a power-law graph with several categories."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    ja, _, want = _jax_product("powerlaw400")
    a = _carry(ja, "cuda")
    before = sortmerge.LAUNCHES
    got = prc.spgemm_rowcat(a, a, use_kernel=True)
    assert sortmerge.LAUNCHES > before
    _assert_same(got, want)
    _assert_same(prc.spgemm_rowcat(a, a, use_kernel=False), want)
