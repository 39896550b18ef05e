"""The port's block-band product (sparsetpu_torch.kernels.bandmm) against the
JAX package's (sparsetpu.kernels.bandmm), on the CPU.

Tolerance: exact.  Band data are integer counts below 2^24 in f32, where
every order of the fp32 sums is exact, so the port's band matrices equal
JAX's element for element; CSR extractions are compared whole.  The graphs
are those of tests/test_band.py.  The JAX package's p_limbs / a_limbs (bf16
limb planes) change its cost, not its result; the port ignores them, which
these tests hold against JAX's limb path.
"""

import numpy as np
import pytest
import torch

from sparsetpu import U64 as JU64
from sparsetpu.bench import chain as jchain
from sparsetpu.csr import SparseCSR as JCSR
from sparsetpu.graphs import generate as jgen
from sparsetpu.kernels import bandmm as jb

from sparsetpu_torch.bench import chain as tchain
from sparsetpu_torch.csr import HostCSR
from sparsetpu_torch.interop import carry_csr
from sparsetpu_torch.kernels import bandmm as tb
from sparsetpu_torch.semiring import U64


def _both(coo):
    rows, cols, vals, n = coo
    j = JCSR.from_coo(rows, cols, vals, n, sr=JU64)
    return j, carry_csr(j, "cpu")


def _assert_band(got: tb.BandMatrix, want):
    assert (got.n, got.block, got.half_width_blocks, got.cyclic) == \
        (want.n, want.block, want.half_width_blocks, want.cyclic)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))


def _assert_csr(got, want):
    assert int(got.nnz) == int(want.nnz) and got.capacity == want.capacity
    for g, w in zip(got.to_numpy(), want.to_numpy()):
        np.testing.assert_array_equal(g.astype(np.int64), np.asarray(w).astype(np.int64))


SPLITS = {
    "path24 linear": (lambda: jgen.lattice([24], torus=False), 1, 8, False),
    "ring24 cyclic": (lambda: jgen.lattice([24], torus=True), 1, 8, True),
    "ring64 linear (2 outliers)": (lambda: jgen.lattice([64], torus=True), 1, 8, False),
    "torus4^3 cyclic": (lambda: jgen.lattice([4, 4, 4], torus=True), 21, 8, True),
}


@pytest.mark.parametrize("name", list(SPLITS))
def test_split_and_extract_match_jax(name):
    make, hw, block, cyclic = SPLITS[name]
    j, a = _both(make())
    band, out = tb.csr_band_split(a, half_width=hw, block=block, cyclic=cyclic)
    jband, jout = jb.csr_band_split(j, half_width=hw, block=block, cyclic=cyclic)
    _assert_band(band, jband)
    _assert_csr(out, jout)
    _assert_csr(tb.band_to_csr(band, sr=U64), jb.band_to_csr(jband, sr=JU64))
    assert int(band.nnz()) == int(jband.nnz()) and band.memory_bytes() == jband.memory_bytes()
    dense = a.to_dense_numpy().astype(np.int64)
    dense[out.to_dense_numpy() != 0] = 0  # the outliers are not in the band
    np.testing.assert_array_equal(tb.band_to_dense(band).numpy().astype(np.int64), dense)


@pytest.mark.parametrize("name", ["path24 linear", "ring24 cyclic", "torus4^3 cyclic"])
def test_band_matmul_matches_jax(name):
    make, hw, block, cyclic = SPLITS[name]
    j, a = _both(make())
    band, _ = tb.csr_band_split(a, half_width=hw, block=block, cyclic=cyclic)
    jband, _ = jb.csr_band_split(j, half_width=hw, block=block, cyclic=cyclic)
    c = tb.band_matmul(band, band)
    _assert_band(c, jb.band_matmul(jband, jband))
    want = a.to_dense_numpy().astype(np.int64)
    np.testing.assert_array_equal(tb.band_to_dense(c).numpy(), want @ want)


def test_limbs_change_nothing_and_fold_matches_jax():
    """4^3 torus: A^2's band (Kbc = 13 > nb = 8) folds; squaring it with
    JAX's 2-limb path and the port's ignored limbs gives one band."""
    j, a = _both(jgen.lattice([4, 4, 4], torus=True))
    band, _ = tb.csr_band_split(a, half_width=21, block=8, cyclic=True)
    jband, _ = jb.csr_band_split(j, half_width=21, block=8, cyclic=True)
    c = tb.band_matmul(band, band)
    jc = jb.band_matmul(jband, jband)
    assert c.half_width_blocks == 0 and c.k_blocks == c.nb  # folded
    c2 = tb.band_matmul(c, c, p_limbs=2, a_limbs=2)
    _assert_band(c2, jb.band_matmul(jc, jc, p_limbs=2, a_limbs=2))
    _assert_band(c2, tb.band_matmul(c, c))
    raw = tb._band_matmul_data(band.data, band.data, 3, 3, True)
    np.testing.assert_array_equal(tb.fold_cyclic(raw, 6, 8).numpy(),
                                  np.asarray(jb.fold_cyclic(np.asarray(raw.numpy()), 6, 8)))
    for v in (1, 255, 256, 70000, 1 << 24):
        assert tb.limbs_for_max(v) == jb.limbs_for_max(v)


def test_chain_power4_and_row_offset():
    """The thinned 4^3 torus: A^2..A^4 through the band product, each equal
    to JAX's band and to the dense power; a row shard of P (row_offset)
    gives its rows of the product."""
    j, a = _both(jgen.thin(jgen.lattice([4, 4, 4], torus=True), 0.5, seed=9))
    band, _ = tb.csr_band_split(a, half_width=21, block=8, cyclic=True)
    jband, _ = jb.csr_band_split(j, half_width=21, block=8, cyclic=True)
    ad = a.to_dense_numpy().astype(np.int64)
    cur, jcur, want = band, jband, ad
    for _ in range(3):
        cur, jcur, want = tb.band_matmul(cur, band), jb.band_matmul(jcur, jband), want @ ad
        _assert_band(cur, jcur)
        np.testing.assert_array_equal(tb.band_to_dense(cur).numpy(), want)
    shard = tb._band_matmul_data(band.data[2:5], band.data, 3, 3, True, row_offset=2)
    full = tb._band_matmul_data(band.data, band.data, 3, 3, True)
    np.testing.assert_array_equal(shard.numpy(), full[2:5].numpy())


@pytest.mark.parametrize("dims", [(4, 4, 4), (12, 12, 12), (30, 30, 30)])
def test_cyclic_bandwidth_and_params_match_jax(dims):
    jh = jchain.build_torus_host(dims=dims)
    th = tchain.build_torus_host(dims)
    want = jb.cyclic_bandwidth(jh.to_device()) if dims != (30, 30, 30) else 1799
    assert tb.cyclic_bandwidth(th) == want
    assert tb.cyclic_bandwidth(tchain.sparse_operand(th, "cpu")) == want
    n = th.n_rows
    block = tchain.BAND_BLOCKS.get(n, 8)
    assert tb.band_params(n, want, block, True) == jb.band_params(n, want, block, True)
    assert tb.band_params(n + 1, want, block, False) == jb.band_params(n + 1, want, block,
                                                                       False)
    with pytest.raises(ValueError, match="block \\| n"):
        tb.band_params(n + 1, want, block, True)


def test_guards():
    _, a = _both(jgen.lattice([4, 4, 4], torus=True))
    band, _ = tb.csr_band_split(a, half_width=21, block=8, cyclic=True)
    lin, _ = tb.csr_band_split(a, half_width=21, block=8, cyclic=False)
    with pytest.raises(ValueError, match="wrap mode"):
        tb.band_matmul(band, lin)
    rect = carry_csr(JCSR.from_coo_host([0], [1], [1], 2, 3, sr=JU64), "cpu")
    with pytest.raises(ValueError, match="square"):
        tb.csr_band_split(rect, 1, 2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
        with pytest.raises(RuntimeError, match="TF32"):
            tb.band_matmul(band, band)
    h = HostCSR.from_coo([0, 1], [1, 0], [1, 1], 2)
    assert tb.cyclic_bandwidth(h) == 1
