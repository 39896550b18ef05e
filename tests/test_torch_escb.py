"""The port's blocked ESC SpGEMM (sparsetpu_torch.ops.escb) against the JAX
package's (sparsetpu.ops.escb), on operands carried across from JAX's CSR.

u64 throughout, bit for bit: ``pack_rows``, ``spgemm_blocked`` (several
blocks, and wide rows that take the second lane width), the narrow one-limb
mode, ``merge_disjoint_rows``, and the n * m < 2^31 guard in both packages.
"""

import numpy as np
import pytest
import torch

from sparsetpu import U64 as JU64
from sparsetpu.csr import SparseCSR as JCSR
from sparsetpu.graphs import datasets as jdata, generate as jgen
from sparsetpu.ops import escb as jescb

from sparsetpu_torch.csr import SparseCSR
from sparsetpu_torch.interop import sparse_csr_from_jax
from sparsetpu_torch.ops import escb as pescb


def _jcsr(rows, cols, vals, n, m=None):
    return JCSR.from_coo_host(np.asarray(rows), np.asarray(cols), np.asarray(vals), n,
                              m if m is not None else n, sr=JU64)


def _carry(j: JCSR, device="cpu") -> SparseCSR:
    return sparse_csr_from_jax(j.row_ptr, j.col_idx, [np.asarray(x) for x in j.values],
                               j.nnz, j.n_rows, j.n_cols, j.sr_name, device)


def _assert_same(got: SparseCSR, want: JCSR):
    assert int(got.check().nnz) == int(want.nnz)
    for g, w in zip(got.to_numpy(), want.to_numpy()):
        np.testing.assert_array_equal(g, w)


GRAPHS = {
    "torus": lambda: jgen.thin(jgen.lattice([5, 5, 5], torus=True), 0.4, seed=3),
    "er": lambda: jgen.random_graph(400, 3200, seed=11),
    "powerlaw": lambda: jdata.power_law(400, 6, seed=5),
}


@pytest.mark.parametrize("L", [64, 256, 1000])
def test_pack_rows_matches_jax(L):
    rng = np.random.default_rng(L)
    fr = rng.integers(0, min(L, 300), 500).astype(np.int64)
    fr[::7] = 0
    fr = fr[fr > 0]
    got, want = pescb.pack_rows(fr, L), jescb.pack_rows(fr, L)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_blocked_matches_jax(graph):
    rows, cols, vals, n = GRAPHS[graph]()
    ja = _jcsr(rows, cols, vals, n)
    a = _carry(ja)
    # L = 256: several blocks, and (power-law, ER) rows wider than a block
    plan = pescb.blocked_config(a, a, L=256)
    if graph == "powerlaw":
        assert len(plan.packs) == 2, "wide rows must take the second lane width"
    want = jescb.spgemm_blocked(ja, ja, L=256).check()
    _assert_same(pescb.spgemm_blocked(a, a, L=256), want)
    _assert_same(pescb.blocked_numeric(a, a, plan), want)
    np.testing.assert_array_equal(pescb.row_flops(a, a).numpy(),
                                  np.asarray(jescb.row_flops(ja, ja)))


def test_narrow_mode_matches_jax():
    rng = np.random.default_rng(31)
    n = 250
    # distinct (row, col) pairs with values below 2^16: every product fits
    # 32 bits, and the sums of several pass 2^32
    keys = np.unique(rng.integers(0, n * n, 3000))
    r, c = keys // n, keys % n
    v = rng.integers(1, 1 << 16, len(keys)).astype(np.uint64)
    ja = _jcsr(r, c, v, n)
    a = _carry(ja)
    assert pescb.blocked_config(a, a).narrow
    got = pescb.spgemm_blocked(a, a)
    _assert_same(got, jescb.spgemm_blocked(ja, ja).check())
    assert int(got.to_dense_numpy().max()) > (1 << 32)  # hi limbs rebuilt from carries


def test_merge_disjoint_rows_matches_jax():
    n = 6
    j1 = _jcsr([0, 0, 2], [1, 3, 2], np.array([7, 8, 9], np.uint64), n)
    j2 = _jcsr([1, 5], [0, 5], np.array([3, 4], np.uint64), n)
    want = jescb.merge_disjoint_rows(j1, j2, out_cap=8).check()
    got = pescb.merge_disjoint_rows(_carry(j1), _carry(j2), out_cap=8)
    _assert_same(got, want)
    assert int(pescb.merge_disjoint_rows(_carry(j1), _carry(j2), out_cap=4).nnz) == -1


def test_empty_and_identity():
    eye = SparseCSR.identity(8, device="cpu")
    c = pescb.spgemm_blocked(eye, eye, L=16)
    np.testing.assert_array_equal(c.to_dense_numpy(), np.eye(8, dtype=np.uint64))
    empty = SparseCSR.empty(5, 5, 4, eye.sr, device="cpu")
    assert int(pescb.spgemm_blocked(empty, empty).check().nnz) == 0


def test_key_width_guard_raises_in_both_packages():
    rows, cols = np.array([0, 65535]), np.array([0, 0])
    ja = _jcsr(rows, cols, np.ones(2, np.uint64), 65536, 1)
    jb = _jcsr(np.array([0]), np.array([65535]), np.ones(1, np.uint64), 1, 65536)
    with pytest.raises(ValueError, match="2\\^31"):
        jescb.spgemm_blocked(ja, jb)
    with pytest.raises(ValueError, match="2\\^31"):
        pescb.spgemm_blocked(_carry(ja), _carry(jb))


@pytest.mark.cuda
def test_cuda_blocked_matches_jax():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rows, cols, vals, n = GRAPHS["powerlaw"]()
    ja = _jcsr(rows, cols, vals, n)
    _assert_same(pescb.spgemm_blocked(_carry(ja, "cuda"), _carry(ja, "cuda"), L=256),
                 jescb.spgemm_blocked(ja, ja, L=256).check())
