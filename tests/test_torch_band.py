"""The port's fold-band SpMM (sparsetpu_torch.kernels.bandplanes) against the
JAX package's (sparsetpu.kernels.bandplanes, Pallas in interpret mode).

The same folded A and the same band P (numpy, fixed seed) go through both.
Tolerance: exact equality (``assert_array_equal``, ``==``): values are
integers below 2^24 carried in f32, where every order of summation is exact,
and layouts are integer arrays.

On the CPU the wrapper runs the plain PyTorch version; the hand-written CUDA
kernel is compared with it only where a card is present (marker ``cuda``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparsetpu import U64, SparseCSR
from sparsetpu.graphs import generate as jgen
from sparsetpu.kernels import bandplanes as jbp

from sparsetpu_torch.csr import HostCSR
from sparsetpu_torch.interop import band_from_jax_planes, csr_from_jax_host
from sparsetpu_torch.kernels import bandplanes as tbp
from sparsetpu_torch.kernels import spmm


def _port_csr(a: SparseCSR) -> HostCSR:
    return csr_from_jax_host(np.asarray(a.row_ptr), np.asarray(a.col_idx),
                             [np.asarray(l) for l in a.values], int(a.nnz),
                             a.n_rows, a.n_cols, a.sr_name)


def _folded(dims, density, seed):
    """A thinned torus folded by fold_perm, as a JAX SparseCSR, and its
    half-width."""
    rows, cols, vals, n = jgen.thin(jgen.lattice(list(dims), torus=True), density, seed=seed)
    perm = jbp.fold_perm(dims)
    rf, cf = perm[rows], perm[cols]
    return SparseCSR.from_coo_host(rf, cf, vals, n, sr=U64), jbp.band_halfwidth(rf, cf)


def _random_band(n, h, seed):
    """A random band matrix of half-width h (values 1..4) as a JAX SparseCSR."""
    rng = np.random.default_rng(seed)
    i = np.repeat(np.arange(n), 2 * h + 1)
    j = i + np.tile(np.arange(-h, h + 1), n)
    keep = (j >= 0) & (j < n)
    i, j = i[keep], j[keep]
    return SparseCSR.from_coo_host(i, j, rng.integers(1, 5, len(i)), n, sr=U64)


@pytest.mark.parametrize("dims", [[6, 6, 6], [5, 5, 3], [7], [4, 9], [30, 30, 30]])
def test_fold_perm_and_halfwidth_match_jax(dims):
    perm = tbp.fold_perm(dims)
    np.testing.assert_array_equal(perm, jbp.fold_perm(dims))
    assert perm.dtype == jbp.fold_perm(dims).dtype
    rows, cols, _, n = jgen.lattice(dims, torus=True)
    assert sorted(perm) == list(range(n))
    for r, c in ((rows, cols), (perm[rows], perm[cols])):
        assert tbp.band_halfwidth(r, c) == jbp.band_halfwidth(r, c)
    assert tbp.band_halfwidth(np.array([]), np.array([])) == jbp.band_halfwidth([], []) == 0


@pytest.mark.parametrize("n,h,total_planes", [
    (512, 37, 16), (216, 86, 8), (3072, 130, 24), (6144, 130, 48), (6144, 260, 48),
    (27000, 1862, 216), (27000, 5586, 216), (27000, 13034, 216),
])
def test_band_layout_at_1024_matches_jax(n, h, total_planes):
    jb, js = jbp.band_layout(n, h, total_planes)
    tb, tw = tbp.band_layout(n, h, total_planes * 128, quantum=1024)
    np.testing.assert_array_equal(tb.astype(np.int64), jb.astype(np.int64) * 128)
    assert tw == js * 128 and tb.dtype == np.int32


def test_band_layout_gpu_quantum_and_broken_layouts():
    n, q = 27000, tbp.QUANTUM
    total = -(-n // q) * q
    prev = 0
    for k in range(1, 8):
        base, w = tbp.band_layout(n, k * 1862, total)
        assert (base % q == 0).all() and w % q == 0 and w >= prev
        assert base.min() >= 0 and int(base.max()) + w <= total
        assert (np.diff(base.astype(np.int64)) >= 0).all()
        prev = w
    # rows cannot fit when the row is wider than the columns: both raise
    with pytest.raises(AssertionError):
        jbp.band_layout(256, 10, 1)
    with pytest.raises(ValueError):
        tbp.band_layout(256, 10, 128, quantum=q)
    with pytest.raises(ValueError):
        tbp.band_layout(64, 3, 100, quantum=q)  # total not a multiple of q


BAND_CASES = {
    # the 6^3 case of tests/test_bandplanes.py: the window is the full width
    "torus6x6x6": ([6, 6, 6], 0.7, 8, False),
    # 96 x 64 2-D torus: windows narrower than the full width, in and out
    "torus96x64": ([96, 64], 0.6, 64, True),
}


@pytest.mark.parametrize("name", list(BAND_CASES))
def test_band_step_matches_jax(name):
    dims, density, rpt, narrow = BAND_CASES[name]
    a, h = _folded(dims, density, seed=3)
    n = a.n_rows
    p_in = _random_band(n, h, seed=0)

    # JAX: one step from the half-width-h layout to the 2h one, with the
    # chaining slack of run_chain_foldband
    total = -(-(-(-n // 128)) // 8) * 8
    b_in, s_in = jbp.band_layout(n, h, total)
    b_out, s_out = jbp.band_layout(n, 2 * h, total, min_s=s_in + 8 * (2 * h // 1024 + 1))
    assert narrow == (s_out < total)
    pb = jbp.csr_to_band(p_in, b_in, s_in)
    cnt, src, dst, vv = jbp.tile_band_operand(a, b_in, s_in, b_out, s_out, rpt, nbuf=4)
    c = jbp.spmm_band(cnt, src, dst, vv, pb, s_in=s_in, s_out=s_out,
                      rows_per_tile=rpt, nbuf=4)
    want = np.asarray(jax.device_get(jbp.band_to_planes(c, jnp.asarray(b_out), n)))
    want = want.reshape(n, -1)[:, :n]
    dense = a.to_dense_numpy().astype(np.float64) @ p_in.to_dense_numpy().astype(np.float64)
    np.testing.assert_array_equal(want, dense.astype(np.float32))

    # the port in its GPU layout: 32-column quantum, no chaining slack
    op = spmm.prepare_sparse_operand(_port_csr(a), "cpu")
    tt = -(-n // tbp.QUANTUM) * tbp.QUANTUM
    tb_in, tw_in = tbp.band_layout(n, h, tt)
    tb_out, tw_out = tbp.band_layout(n, 2 * h, tt)
    assert narrow == (tw_out < tt)
    p_t = tbp.csr_to_band(spmm.prepare_sparse_operand(_port_csr(p_in), "cpu"), tb_in, tw_in)
    bop = tbp.prepare_band_operand(op, tb_in, tw_in, tb_out, tw_out, h)
    got = tbp.band_to_dense(tbp.spmm_band(bop, p_t), tb_out, n)
    np.testing.assert_array_equal(got.numpy(), want)

    # the port on JAX's own layout, read through interop: window by window
    p_planes, base_in = band_from_jax_planes(jax.device_get(pb), b_in)
    want_planes, base_out = band_from_jax_planes(jax.device_get(c), b_out)
    bop = tbp.prepare_band_operand(op, base_in, s_in * 128, base_out, s_out * 128, h)
    got = tbp.spmm_band(bop, torch.from_numpy(p_planes.copy()))
    np.testing.assert_array_equal(got.numpy(), want_planes)


def test_band_guards_raise_in_both_packages():
    # values >= 2^24: JAX's tile_band_operand and the port's operand prep
    big = SparseCSR.from_coo([0], [0], [1 << 24], 8, 8, sr=U64)
    base = np.zeros(8, np.int32)
    with pytest.raises(ValueError):
        jbp.tile_band_operand(big, base, 8, base, 8, 8, 4)
    with pytest.raises(ValueError):
        spmm.prepare_sparse_operand(_port_csr(big), "cpu")

    # a band whose every entry sits h columns right of the diagonal
    n, h = 4096, 10
    rows = np.arange(n - h)
    a = SparseCSR.from_coo_host(rows, rows + h, np.ones(n - h, np.uint64), n, sr=U64)
    op = spmm.prepare_sparse_operand(_port_csr(a), "cpu")
    # sources laid out for half-width 5h start left of outputs laid out for h
    j_in, s_in = jbp.band_layout(n, 5 * h, 32)
    j_out, s_out = jbp.band_layout(n, h, 32)
    with pytest.raises(AssertionError):
        jbp.tile_band_operand(a, j_in, s_in, j_out, s_out, 8, 4)
    t_in, w_in = tbp.band_layout(n, 5 * h, n, quantum=1)
    t_out, w_out = tbp.band_layout(n, h, n, quantum=1)
    with pytest.raises(ValueError, match="dp < 0"):
        tbp.prepare_band_operand(op, t_in, w_in, t_out, w_out, 5 * h)
    # the window does not fit: A x P of half-width h needs outputs of 2h
    with pytest.raises(ValueError, match="support"):
        tbp.prepare_band_operand(op, t_out, w_out, t_out, w_out, h)
    j_wide, s_wide = jbp.band_layout(n, 2000, 32)
    with pytest.raises(AssertionError):
        jbp.tile_band_operand(a, j_wide, s_wide, j_out, s_out, 8, 4)
    t_out2, w_out2 = tbp.band_layout(n, 2 * h, n, quantum=1)
    tbp.prepare_band_operand(op, t_out, w_out, t_out2, w_out2, h)  # the right layout passes


def test_csr_to_band_and_band_to_dense_round_trip():
    a, h = _folded([6, 6, 6], 0.7, seed=3)
    n = a.n_rows
    op = spmm.prepare_sparse_operand(_port_csr(a), "cpu")
    for q in (tbp.QUANTUM, 1, 1024):
        tt = -(-n // q) * q
        base, w = tbp.band_layout(n, h, tt, quantum=q)
        band = tbp.csr_to_band(op, base, w)
        assert band.shape == (n, w)
        np.testing.assert_array_equal(tbp.band_to_dense(band, base, n).numpy(),
                                      spmm.densify(op).numpy())
    # JAX's band planes of the same A read through interop give the same rows
    jb, js = jbp.band_layout(n, h, 8)
    planes, base = band_from_jax_planes(jax.device_get(jbp.csr_to_band(a, jb, js)), jb)
    np.testing.assert_array_equal(
        tbp.band_to_dense(torch.from_numpy(planes.copy()), base, n).numpy(),
        spmm.densify(op).numpy())
    with pytest.raises(ValueError, match="outside"):
        tbp.csr_to_band(op, np.full(n, 4 * tbp.QUANTUM, np.int32), tbp.QUANTUM)


def test_spmm_band_checks_and_out_buffer():
    a, h = _folded([6, 6, 6], 0.7, seed=3)
    n = a.n_rows
    op = spmm.prepare_sparse_operand(_port_csr(a), "cpu")
    b_in, w_in = tbp.band_layout(n, h, n + 8, quantum=8)
    b_out, w_out = tbp.band_layout(n, 2 * h, n + 8, quantum=8)
    bop = tbp.prepare_band_operand(op, b_in, w_in, b_out, w_out, h)
    p = tbp.csr_to_band(op, b_in, w_in)
    out = torch.full((n, w_out), -1.0)
    assert tbp.spmm_band(bop, p, out=out) is out
    np.testing.assert_array_equal(out.numpy(), tbp.spmm_band_reference(bop, p).numpy())
    before = tbp.LAUNCHES
    for kw in (dict(p=p.double()), dict(p=p[:, :-1]), dict(p=torch.zeros(n + 1, w_in)),
               dict(p=p, out=torch.zeros(n, w_out - 1)), dict(p=p, out=p)):
        with pytest.raises(ValueError):
            tbp.spmm_band(bop, **kw)
    with pytest.raises(ValueError):
        tbp.prepare_band_operand(op, b_in[:-1], w_in, b_out, w_out, h)
    assert tbp.LAUNCHES == before  # the CPU path never counts a launch


@pytest.mark.cuda
def test_cuda_band_kernel_matches_plain_version():
    """The hand-written kernel against the plain version on the card: the GPU
    quantum (float4 path), an unaligned quantum (scalar path) and JAX's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    a, h = _folded([12, 12, 12], 0.4, seed=5)
    n = a.n_rows
    op = spmm.prepare_sparse_operand(_port_csr(a), dev)
    for q in (tbp.QUANTUM, 1, 1024):
        tt = -(-n // q) * q
        b_in, w_in = tbp.band_layout(n, 2 * h, tt, quantum=q)
        b_out, w_out = tbp.band_layout(n, 3 * h, tt, quantum=q)
        bop = tbp.prepare_band_operand(op, b_in, w_in, b_out, w_out, 2 * h)
        p = torch.randint(0, 5, (n, w_in), generator=gen, device=dev, dtype=torch.float32)
        before = tbp.LAUNCHES
        got = tbp.spmm_band(bop, p)
        assert tbp.LAUNCHES == before + 1
        torch.testing.assert_close(got, tbp.spmm_band_reference(bop, p), rtol=0, atol=0)
