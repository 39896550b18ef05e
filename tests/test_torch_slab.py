"""The port's slab ESC SpGEMM (sparsetpu_torch.ops.slab) against the JAX
package's (sparsetpu.ops.slab), on operands carried across from JAX's CSR,
and against the C++ oracle.

Tolerance: exact throughout.  The whole CSR is compared bit for bit,
capacity and padded tail included: u64 (narrow one-limb and two-limb), u32,
and f32 on integer values (every order of the sums is exact).  The cases
mirror tests/test_slab.py: torus, ER and power-law, small L and C that force
many blocks and wide rows, rectangular operands, the n * m > 2^31 key case,
empty operands and poison.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from sparsetpu import F32SR as JF32, U32 as JU32, U64 as JU64
from sparsetpu.csr import SparseCSR as JCSR
from sparsetpu.graphs import datasets as jdata, generate as jgen
from sparsetpu.ops import slab as jslab

from sparsetpu_torch import native
from sparsetpu_torch.csr import SparseCSR
from sparsetpu_torch.interop import sparse_csr_from_jax
from sparsetpu_torch.ops import slab
from sparsetpu_torch.semiring import U64

JSR = {"u64": JU64, "u32": JU32, "f32": JF32}


def _jcsr(rows, cols, vals, n, m=None, sr="u64"):
    return JCSR.from_coo_host(np.asarray(rows), np.asarray(cols), np.asarray(vals), n,
                              m if m is not None else n, sr=JSR[sr])


def _carry(j: JCSR, device="cpu") -> SparseCSR:
    return sparse_csr_from_jax(j.row_ptr, j.col_idx, [np.asarray(x) for x in j.values],
                               j.nnz, j.n_rows, j.n_cols, j.sr_name, device)


def _assert_same(got: SparseCSR, want: JCSR):
    """The whole CSR: nnz, row_ptr, and every slot of col_idx and the limbs."""
    assert int(got.nnz) == int(want.nnz)
    assert got.capacity == want.capacity
    np.testing.assert_array_equal(got.row_ptr.cpu().numpy(), np.asarray(want.row_ptr))
    np.testing.assert_array_equal(got.col_idx.cpu().numpy(), np.asarray(want.col_idx))
    for g, w in zip(got.values, want.values):
        g = g.cpu().numpy()
        np.testing.assert_array_equal(g, np.asarray(w).astype(g.dtype))


def _assert_oracle(got: SparseCSR, a: SparseCSR, b: SparseCSR):
    """u64 products against the C++ oracle's CSR."""
    ha, hb = (native.as_host_csr(*x.to_numpy()) for x in (a, b))
    want = native.spgemm(ha, hb, a.n_rows)
    for g, w in zip(got.to_numpy(), want):
        np.testing.assert_array_equal(np.asarray(g).astype(np.int64), w.astype(np.int64))


GRAPHS = {
    "torus": lambda: jgen.thin(jgen.lattice([5, 5, 5], torus=True), 0.4, seed=3),
    "er": lambda: jgen.random_graph(400, 3200, seed=11),
    "powerlaw": lambda: jdata.power_law(400, 6, seed=5),
}


@pytest.mark.parametrize("lc", [16, 128, 1000])
def test_pack_rows_ordered_matches_jax(lc):
    rng = np.random.default_rng(lc)
    rc = rng.integers(0, min(lc, 300) + 1, 600).astype(np.int64)
    rc[::7] = 0
    rc[5] = rc[400] = lc + 3  # rows past a block: each gets one of its own
    rc[0] = 2 * lc if lc == 16 else rc[0]  # and the first row may be one
    got, want = slab.pack_rows_ordered(rc, lc), jslab.pack_rows_ordered(rc, lc)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].dtype == want[0].dtype and got[1].dtype == want[1].dtype
    assert got[2] == want[2]
    assert slab.pack_rows_ordered(np.zeros(5, np.int64), lc)[2] == 1


def test_plan_device_and_chunk_tables_match_jax():
    rows, cols, vals, n = GRAPHS["powerlaw"]()
    ja = _jcsr(rows, cols, vals, n)
    a = _carry(ja)
    for c in (4, 8):
        for g, w in zip(slab.plan_device(a, a, c), jslab.plan_device(ja, ja, c)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        ncc = int(slab.plan_device(a, a, c)[1])
        got, want = slab._chunk_tables(a, c, ncc), jslab._chunk_tables(ja, c, ncc)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        for g, w in zip(got[1], want[1]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_slab_matches_jax_and_oracle(graph):
    rows, cols, vals, n = GRAPHS[graph]()
    ja = _jcsr(rows, cols, vals, n)
    a = _carry(ja)
    got = slab.spgemm_slab(a, a)
    _assert_same(got, jslab.spgemm_slab(ja, ja))
    _assert_oracle(got, a, a)
    assert slab.slab_config(a, a).narrow  # values 1: one limb through the sort


def test_small_L_forces_many_blocks_and_wide_rows():
    rows, cols, vals, n = jdata.power_law(300, 5, seed=7)
    ja = _jcsr(rows, cols, vals, n)
    a = _carry(ja)
    plan = slab.slab_config(a, a, L=256, C=4)
    assert len(plan.packs) == 2 and plan.packs[0][3] > 1, "many blocks, then wide rows"
    got = slab.slab_numeric(a, a, plan)
    _assert_same(got, jslab.spgemm_slab(ja, ja, L=256, C=4))
    _assert_oracle(got, a, a)


def test_two_limb_values_and_saturation():
    big = 1 << 40
    rows = np.array([0, 0, 1, 2, 2, 2, 3, 3])
    cols = np.array([1, 2, 0, 0, 1, 2, 3, 0])
    vals = np.array([big, 3, big, 5, big * 2, 7, (1 << 63) + 5, 1 << 62], np.uint64)
    ja = _jcsr(rows, cols, vals, 4)
    a = _carry(ja)
    assert not slab.slab_config(a, a).narrow
    got = slab.spgemm_slab(a, a)
    _assert_same(got, jslab.spgemm_slab(ja, ja))
    _assert_oracle(got, a, a)
    assert int(got.to_dense_numpy().max()) == (1 << 64) - 1  # saturated


def test_narrow_sums_past_2_32():
    rng = np.random.default_rng(31)
    n = 120
    keys = np.unique(rng.integers(0, n * n, 1500))
    vals = rng.integers(1, 1 << 16, len(keys)).astype(np.uint64)
    ja = _jcsr(keys // n, keys % n, vals, n)
    a = _carry(ja)
    assert slab.slab_config(a, a).narrow
    got = slab.spgemm_slab(a, a)
    _assert_same(got, jslab.spgemm_slab(ja, ja))
    assert int(got.to_dense_numpy().max()) > (1 << 32)  # hi limbs rebuilt from carries


@pytest.mark.parametrize("sr", ["u32", "f32"])
def test_u32_and_f32_match_jax(sr):
    rows, cols, vals, n = jgen.random_graph(200, 1400, seed=2)
    vals = (vals.astype(np.uint64) * 3_000_000_000) if sr == "u32" else (vals % 7 + 1)
    ja = _jcsr(rows, cols, vals.astype(np.float32) if sr == "f32" else vals, n, sr=sr)
    got = slab.spgemm_slab(_carry(ja), _carry(ja))
    _assert_same(got, jslab.spgemm_slab(ja, ja))


def test_rectangular():
    ja = _jcsr([0, 0, 1, 3], [5, 1, 0, 2], np.array([2, 3, 4, 5], np.uint64), 4, 6)
    jb = _jcsr([0, 1, 2, 5], [1, 2, 0, 2], np.array([7, 1, 9, 11], np.uint64), 6, 3)
    got = slab.spgemm_slab(_carry(ja), _carry(jb))
    _assert_same(got, jslab.spgemm_slab(ja, jb))
    assert got.shape == (4, 3)


def test_large_nm_keys():
    # n * m > 2^31: a fused int32 r * m + j key would wrap
    n = 70000
    rows = np.array([0, 1, 69999, 69999, 35000])
    cols = np.array([69999, 0, 69998, 0, 35000])
    ja = _jcsr(rows, cols, np.array([3, 5, 7, 11, 13], np.uint64), n)
    a = _carry(ja)
    got = slab.spgemm_slab(a, a)
    _assert_same(got, jslab.spgemm_slab(ja, ja))
    _assert_oracle(got, a, a)


def test_empty_and_poison():
    e = SparseCSR.empty(5, 5, 4, U64, device="cpu")
    assert int(slab.spgemm_slab(e, e).check().nnz) == 0
    rows, cols, vals, n = jgen.random_graph(100, 800, seed=4)
    ja = _jcsr(rows, cols, vals, n)
    a = _carry(ja)
    bad = slab.spgemm_slab(a, a, out_cap=16)  # undersized out_cap poisons
    assert int(bad.nnz) == int(jslab.spgemm_slab(ja, ja, out_cap=16).nnz) == -1
    with pytest.raises(ValueError):
        bad.check()
    poisoned = dataclasses.replace(a, nnz=torch.tensor(-1))
    jpoisoned = dataclasses.replace(ja, nnz=jnp.asarray(-1, jnp.int32))
    for x, y, jx, jy in ((poisoned, a, jpoisoned, ja), (a, poisoned, ja, jpoisoned)):
        assert int(slab.spgemm_slab(x, y).nnz) == int(jslab.spgemm_slab(jx, jy).nnz) == -1


@pytest.mark.cuda
def test_cuda_slab_matches_jax():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rows, cols, vals, n = jdata.power_law(300, 5, seed=7)
    ja = _jcsr(rows, cols, vals, n)
    a = _carry(ja, "cuda")
    _assert_same(slab.spgemm_slab(a, a, L=256, C=4), jslab.spgemm_slab(ja, ja, L=256, C=4))
