"""The port's dense-accumulator and dense-dense SpGEMM
(sparsetpu_torch.ops.denseacc) against the JAX package's
(sparsetpu.ops.denseacc), on the CPU: the JAX dense accumulator runs its
Pallas kernel in interpret mode, as its own tests run it, and the port its
kernel's plain version.

Tolerance: the integer semirings bit for bit, the whole CSR (capacity and
padded tail included); the f32 semiring on random non-integer values within
rtol 1e-5 (the summation order differs), its pattern and row offsets
exactly.  The JAX calls are shared through module fixtures; the graphs are
those of tests/test_denseacc.py.  The port's panel sweeps run many panels
(any width >= 1) where JAX's run one (its widths are multiples of 1024).
"""

import numpy as np
import pytest
import torch

from sparsetpu import F32SR as JF32, U32 as JU32, U64 as JU64
from sparsetpu.csr import SparseCSR as JCSR
from sparsetpu.graphs.generate import lattice, random_graph
from sparsetpu.ops import denseacc as jd

from sparsetpu_torch.interop import carry_csr
from sparsetpu_torch.kernels import spmm as kspmm
from sparsetpu_torch.ops import denseacc as td

JSR = {"u64": JU64, "u32": JU32, "f32": JF32}
GRAPHS = {
    "torus555": lambda: lattice((5, 5, 5), True),
    "er100": lambda: random_graph(100, 700, seed=3),
    "er123": lambda: random_graph(123, 700, seed=4),
}


def _pair(coo, sr="u64", vals=None):
    r, c, v, n = coo
    j = JCSR.from_coo_host(r, c, v if vals is None else vals, n, sr=JSR[sr])
    return j, carry_csr(j, "cpu")


def _assert_same(got, want, rtol=0.0):
    assert int(got.nnz) == int(want.nnz)
    assert got.capacity == want.capacity
    np.testing.assert_array_equal(got.row_ptr.numpy(), np.asarray(want.row_ptr))
    np.testing.assert_array_equal(got.col_idx.numpy(), np.asarray(want.col_idx))
    for g, w in zip(got.values, want.values):
        g = g.numpy()
        if rtol:
            np.testing.assert_allclose(g, np.asarray(w), rtol=rtol, atol=0)
        else:
            np.testing.assert_array_equal(g, np.asarray(w).astype(g.dtype))


@pytest.fixture(scope="module", params=list(GRAPHS))
def square(request):
    j, a = _pair(GRAPHS[request.param]())
    return j, a, jd.spgemm_dense_acc(j, j)


def test_dense_acc_matches_jax(square):
    j, a, want = square
    _assert_same(td.spgemm_dense_acc(a, a), want)


def test_dense_dense_matches_jax(square):
    j, a, _ = square
    _assert_same(td.spgemm_dense_dense(a, a), jd.spgemm_dense_dense(j, j))


def test_dense_acc_pair_and_undersized_cap_poisons():
    ja, a = _pair(random_graph(64, 300, seed=5))
    jb, b = _pair(random_graph(64, 500, seed=6))
    _assert_same(td.spgemm_dense_acc(a, b), jd.spgemm_dense_acc(ja, jb))
    got, want = td.spgemm_dense_acc(a, b, out_cap=64), jd.spgemm_dense_acc(ja, jb, out_cap=64)
    assert int(got.nnz) == int(want.nnz) == -1
    with pytest.raises(ValueError):
        got.check()
    with pytest.raises(ValueError, match="chain"):
        td.spgemm_dense_acc(a, carry_csr(JCSR.from_coo_host([0], [0], [1], 3, sr=JU64), "cpu"))


@pytest.fixture(scope="module")
def er100_tiled():
    j, a = _pair(GRAPHS["er100"]())
    return j, a, jd.spgemm_dense_acc_tiled(j, j, panel_cols=1024)


@pytest.mark.parametrize("panel_cols", [1, 17, 100, 4096])
def test_dense_acc_tiled_panels_match_jax(er100_tiled, panel_cols):
    j, a, want = er100_tiled
    _assert_same(td.spgemm_dense_acc_tiled(a, a, panel_cols=panel_cols), want)


def test_dense_acc_tiled_pair_rectangular():
    rng = np.random.default_rng(8)
    r1, c1 = rng.integers(0, 60, 400), rng.integers(0, 80, 400)
    r2, c2 = rng.integers(0, 80, 300), rng.integers(0, 50, 300)
    one = np.ones(400, np.uint64)
    ja = JCSR.from_coo_host(r1, c1, one, 60, 80, sr=JU64)
    jb = JCSR.from_coo_host(r2, c2, one[:300], 80, 50, sr=JU64)
    a, b = carry_csr(ja, "cpu"), carry_csr(jb, "cpu")
    _assert_same(td.spgemm_dense_acc_tiled(a, b, panel_cols=7),
                 jd.spgemm_dense_acc_tiled(ja, jb, panel_cols=1024))


@pytest.mark.parametrize("sr", ["u32", "f32"])
def test_dense_acc_u32_f32_semirings(sr):
    r, c, v, n = random_graph(100, 700, seed=11)
    vals = v if sr == "u32" else np.random.default_rng(12).uniform(0.1, 3, len(v)).astype(
        np.float32)
    j, a = _pair((r, c, v, n), sr, vals)
    rtol = 1e-5 if sr == "f32" else 0.0
    _assert_same(td.spgemm_dense_acc(a, a), jd.spgemm_dense_acc(j, j), rtol)
    _assert_same(td.spgemm_dense_acc_tiled(a, a, panel_cols=13),
                 jd.spgemm_dense_acc_tiled(j, j, panel_cols=1024), rtol)
    _assert_same(td.spgemm_dense_dense_tiled(a, a, panel_cols=13),
                 jd.spgemm_dense_dense_tiled(j, j, panel_cols=1024), rtol)
    _assert_same(td.spgemm_dense_dense(a, a), jd.spgemm_dense_dense(j, j), rtol)


def test_dense_acc_value_guard_and_output_bound_poisons():
    """A value of 2^24 (or a u64 hi limb) cannot ride the f32 carrier: the
    plan raises in both packages.  Outputs reaching 2^24 poison nnz."""
    for big in (1 << 24, 1 << 33):
        j, a = _pair(([0, 1], [1, 0], np.array([big, 1], np.uint64), 2))
        with pytest.raises(ValueError):
            jd.spgemm_dense_acc(j, j)
        with pytest.raises(ValueError, match="2\\^24"):
            td.spgemm_dense_acc(a, a)
    j, a = _pair(([0, 0, 1], [0, 1, 0], np.array([1 << 12, 1 << 12, 1], np.uint64), 2))
    want = jd.spgemm_dense_acc(j, j)
    for got in (td.spgemm_dense_acc(a, a), td.spgemm_dense_acc_tiled(a, a, panel_cols=1)):
        assert int(got.nnz) == int(want.nnz) == -1


def test_dense_dense_value_bounds_poison_in_both_tiers():
    """f32 tier: an input of 2^16, or outputs of 2^24, poison; the wide
    tier takes both (outputs < 2^30), and poisons past 2^30 by its f32
    companion, on inputs of 2^31 and on a u64 hi limb."""
    cases = {
        "input 2^16": (([0, 1], [1, 0], [1 << 16, 3]), (True, False)),
        "output 2^24": (([0, 0, 1], [0, 1, 0], [1 << 12, 1 << 12, 1]), (True, False)),
        "output 2^30 (companion)": (([0, 0, 1, 1], [0, 1, 0, 1], [1 << 16] * 4), (True, True)),
        "input 2^31": (([0, 1], [1, 0], [1 << 31, 1]), (True, True)),
        "hi limb": (([0, 1], [1, 0], [1 << 32, 1]), (True, True)),
    }
    for name, ((r, c, v), (f32_poisons, wide_poisons)) in cases.items():
        j, a = _pair((np.array(r), np.array(c), np.array(v, np.uint64), 2))
        for wide, poisons in ((False, f32_poisons), (True, wide_poisons)):
            got = td.spgemm_dense_dense(a, a, wide=wide)
            want = jd.spgemm_dense_dense(j, j, wide=wide)
            assert (int(got.nnz) == -1) == poisons == (int(want.nnz) == -1), (name, wide)
            if not poisons:
                _assert_same(got, want)
        got = td.spgemm_dense_dense_tiled(a, a, panel_cols=1)
        assert (int(got.nnz) == -1) == f32_poisons, name


def test_dense_dense_wide_tier_matches_jax():
    """Outputs in [2^24, 2^30): the f32 tier poisons, the wide tier (one
    fp64 product) equals JAX's int32 tier bit for bit."""
    r, c, v, n = random_graph(150, 900, seed=41)
    v2 = (v.astype(np.uint64) % 7 + 1) * 1200
    for sr in ("u64", "u32"):
        j, a = _pair((r, c, v2, n), sr)
        assert int(td.spgemm_dense_dense(a, a).nnz) == -1
        want = jd.spgemm_dense_dense(j, j, wide=True)
        assert int(want.nnz) > 0
        _assert_same(td.spgemm_dense_dense(a, a, wide=True), want)
    with pytest.raises(ValueError, match="u32/u64"):
        td.densedense_numeric_i32(*[_pair(([0], [0], [1.0], 1), "f32")[1]] * 2, 1)


def test_dense_dense_tiled_matches_jax(square):
    j, a, _ = square
    want = jd.spgemm_dense_dense_tiled(j, j, panel_cols=1024)
    for w in (1, 9, 64):
        _assert_same(td.spgemm_dense_dense_tiled(a, a, panel_cols=w), want)


def test_panel_rules_and_tf32_guard(monkeypatch):
    for n, k in ((100, 100), (27000, 27000), (38000, 38000), (5000, 20000)):
        assert td.densedense_tiled_panel_cols(n, k) == jd.densedense_tiled_panel_cols(n, k)
        assert td.densedense_fits(n, k, n) == jd.densedense_fits(n, k, n)
    _, a = _pair(random_graph(40, 100, seed=1))
    with pytest.raises(ValueError, match="panel_cols"):
        td.spgemm_dense_acc_tiled(a, a, panel_cols=0)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    assert kspmm.tf32_enabled()
    for fn in (lambda: td.spgemm_dense_dense(a, a), lambda: td.spgemm_dense_dense(a, a, True),
               lambda: td.spgemm_dense_dense_tiled(a, a, 8)):
        with pytest.raises(RuntimeError, match="TF32"):
            fn()


def test_pack_has_no_dense_index_grid():
    """The pack's slots: row-major nonzeros, sentinel tail, per-row counts,
    and nonzeros past the capacity dropped with nnz poisoned."""
    d = torch.tensor([[0.0, 2.0, 0.0, 1.0], [0.0, 0.0, 0.0, 0.0], [5.0, 0.0, 0.0, 7.0]])
    c = td._dense_to_csr_lanesort(d, "u64", 8)
    assert int(c.nnz) == 4 and c.row_ptr.tolist() == [0, 2, 2, 4]
    assert c.col_idx.tolist() == [1, 3, 0, 3] + [td.INT32_SENTINEL] * 4
    assert c.values[0].tolist() == [2, 1, 5, 7, 0, 0, 0, 0]
    assert int(td._dense_to_csr_lanesort(d, "u64", 2).nnz) == -1


@pytest.mark.cuda
def test_cuda_dense_acc_routes_launch_the_kernel():
    """On the card every dense-accumulator route launches spmm_dense_acc and
    equals the CPU plain version's product bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    j, a = _pair(random_graph(300, 2000, seed=21))
    ag = carry_csr(j, "cuda")
    for fn, launches in ((lambda x: td.spgemm_dense_acc(x, x), 1),
                         (lambda x: td.spgemm_dense_acc_tiled(x, x, panel_cols=64), 10)):
        before = kspmm.LAUNCHES
        got = fn(ag)
        assert kspmm.LAUNCHES - before == launches
        want = fn(a)
        for g, w in zip((got.row_ptr, got.col_idx, *got.values),
                        (want.row_ptr, want.col_idx, *want.values)):
            assert torch.equal(g.cpu(), w)
