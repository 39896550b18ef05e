"""The port's dense-accumulator SpMM (sparsetpu_torch.kernels.spmm) against the
JAX package's Pallas kernel (sparsetpu.kernels.spmm_pallas, interpret mode).

The same A (a JAX ``SparseCSR``, carried across by ``interop``) and the same
P (numpy, fixed seed) go through both.  Tolerance: exact equality
(``assert_array_equal``): every value is an integer below 2^24 carried in
f32, where every order of summation is exact.

On the CPU the wrapper runs the plain PyTorch version; the hand-written CUDA
kernel is compared with it only where a card is present (marker ``cuda``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparsetpu import U64, SparseCSR
from sparsetpu.bench.chain import tuple_to_f32_dense
from sparsetpu.graphs import generate as jgen
from sparsetpu.kernels import spmm_pallas as sp

from sparsetpu_torch.csr import HostCSR
from sparsetpu_torch.interop import csr_from_jax_host, dense_from_row_planes
from sparsetpu_torch.kernels import spmm


def _torus(dims, density, seed):
    rows, cols, vals, n = jgen.thin(jgen.lattice(list(dims), torus=True), density, seed=seed)
    return SparseCSR.from_coo_host(rows, cols, vals, n, sr=U64)


def _random(n, m, seed):
    rows, cols, vals, n = jgen.random_graph(n, m, seed=seed)
    return SparseCSR.from_coo_host(rows, cols, vals, n, sr=U64)


def _port_csr(a: SparseCSR) -> HostCSR:
    return csr_from_jax_host(np.asarray(a.row_ptr), np.asarray(a.col_idx),
                             [np.asarray(l) for l in a.values], int(a.nnz),
                             a.n_rows, a.n_cols, a.sr_name)


CASES = {
    "torus4x4x4": (lambda: _torus([4, 4, 4], 0.4, seed=4), 8),
    "torus8x8": (lambda: _torus([8, 8], 0.4, seed=8), 16),
    "torus4x4": (lambda: _torus([4, 4], 0.4, seed=4), 8),
    # not symmetric: catches P x A computed in place of A x P
    "random64x200": (lambda: _random(64, 200, seed=5), 8),
}


@pytest.mark.parametrize("name", list(CASES))
def test_spmm_matches_pallas(name):
    make, rpt = CASES[name]
    a = make()
    n = a.n_rows
    rng = np.random.default_rng(0)
    p_np = rng.integers(0, 5, size=(n, n)).astype(np.float32)

    cnt, cols, lrow, vals, _ = sp.tile_sparse_operand(a, rows_per_tile=rpt)
    c = sp.spmm_pallas(cnt, cols, lrow, vals, sp.to_row_planes(jnp.asarray(p_np)),
                       rows_per_tile=rpt)
    want = dense_from_row_planes(jax.device_get(c), n)

    op = spmm.prepare_sparse_operand(_port_csr(a), "cpu")
    got = spmm.spmm_dense_acc(op, torch.from_numpy(p_np))
    np.testing.assert_array_equal(got.numpy(), want)
    dense_a = a.to_dense_numpy().astype(np.float64)
    np.testing.assert_array_equal(got.numpy(), (dense_a @ p_np).astype(np.float32))


def test_random_graph_is_not_symmetric():
    d = _random(64, 200, seed=5).to_dense_numpy()
    assert not np.array_equal(d, d.T)


def test_value_guard_in_both_packages():
    a = SparseCSR.from_coo([0], [0], [1 << 24], 8, 8, sr=U64)
    with pytest.raises(ValueError):
        sp.tile_sparse_operand(a, rows_per_tile=8)
    with pytest.raises(ValueError):
        spmm.prepare_sparse_operand(_port_csr(a), "cpu")
    # just below the bound is fine, and the f32 semiring has no bound
    ok = SparseCSR.from_coo([0], [0], [(1 << 24) - 1], 8, 8, sr=U64)
    spmm.prepare_sparse_operand(_port_csr(ok), "cpu")
    spmm.prepare_sparse_operand(HostCSR.from_coo([0], [0], [2.0**30], 8, sr_name="f32"), "cpu")


def test_densify_matches_jax():
    a = _random(64, 200, seed=5)
    want = np.asarray(jax.device_get(tuple_to_f32_dense(a)))
    got = spmm.densify(spmm.prepare_sparse_operand(_port_csr(a), "cpu"))
    np.testing.assert_array_equal(got.numpy(), want)


def test_rectangular_and_row_slice():
    rng = np.random.default_rng(3)
    rows, cols = rng.integers(0, 5, 12), rng.integers(0, 7, 12)
    h = HostCSR.from_coo(rows, cols, rng.integers(1, 4, 12), 5, 7)
    op = spmm.prepare_sparse_operand(h, "cpu")
    p = torch.from_numpy(rng.integers(0, 9, (7, 3)).astype(np.float32))
    dense_a = np.zeros((5, 7))
    np.add.at(dense_a, (h.rows(), h.col_idx), h.vals.astype(np.float64))
    want = (dense_a @ p.numpy()).astype(np.float32)
    np.testing.assert_array_equal(spmm.spmm_dense_acc(op, p).numpy(), want)
    part = spmm.row_slice(op, 1, 4)
    np.testing.assert_array_equal(spmm.spmm_dense_acc(part, p).numpy(), want[1:4])
    with pytest.raises(ValueError):
        spmm.row_slice(op, 3, 6)


def test_out_buffer_and_checks():
    h = HostCSR.from_coo([0, 1, 2], [1, 2, 0], [1, 2, 3], 3)
    op = spmm.prepare_sparse_operand(h, "cpu")
    p = torch.arange(9, dtype=torch.float32).reshape(3, 3)
    out = torch.full((3, 3), -1.0)
    assert spmm.spmm_dense_acc(op, p, out=out) is out
    np.testing.assert_array_equal(out.numpy(), [[3, 4, 5], [12, 14, 16], [0, 3, 6]])
    before = spmm.LAUNCHES
    bad = [
        dict(p=p.double()),                       # dtype
        dict(p=p.t()),                            # not contiguous
        dict(p=torch.zeros(4, 3)),                # rows != A's columns
        dict(p=p, out=torch.zeros(3, 2)),         # out shape
        dict(p=p, out=torch.zeros(3, 3, dtype=torch.float64)),
        dict(p=p, out=p),                         # out aliases P
    ]
    for kw in bad:
        with pytest.raises(ValueError):
            spmm.spmm_dense_acc(op, **kw)
    assert spmm.LAUNCHES == before  # the CPU path never counts a launch


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """The hand-written kernel against the plain version on the card, at a
    float4-aligned width, a ragged width and a rectangular row slice."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for a in (_torus([4, 4, 4], 0.4, seed=4), _random(75, 300, seed=2)):
        op = spmm.prepare_sparse_operand(_port_csr(a), dev)
        for m in (a.n_cols, 1030, 3):
            p = torch.randint(0, 5, (a.n_cols, m), generator=gen, device=dev,
                              dtype=torch.float32)
            before = spmm.LAUNCHES
            got = spmm.spmm_dense_acc(op, p)
            assert spmm.LAUNCHES == before + 1
            torch.testing.assert_close(got, spmm.spmm_dense_acc_reference(op, p),
                                       rtol=0, atol=0)
            part = spmm.row_slice(op, 5, 20)
            out = torch.full((15, m), -1.0, device=dev)
            spmm.spmm_dense_acc(part, p, out=out)
            torch.testing.assert_close(out, got[5:20], rtol=0, atol=0)
