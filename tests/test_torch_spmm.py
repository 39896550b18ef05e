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
from sparsetpu_torch.kernels import _build, spmm


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
    # rows of ~32 entries, as the sweep's ER x 32 operand
    "random128x4096": (lambda: _random(128, 128 * 32, seed=6), 8),
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


def _rows_of(lens, n_cols, seed) -> HostCSR:
    """A host CSR whose row i has lens[i] distinct random columns of
    [0, n_cols) and values in 1..3."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(len(lens)), lens)
    cols = np.concatenate([rng.choice(n_cols, size=k, replace=False) for k in lens])
    return HostCSR.from_coo(rows, cols, rng.integers(1, 4, rows.size), len(lens), n_cols)


def _hub_graph() -> HostCSR:
    """600 rows of 0-5 entries, every 7th empty, and row 300 a hub of 2,000."""
    lens = np.random.default_rng(11).integers(0, 6, 600)
    lens[::7] = 0
    lens[300] = 2000
    return _rows_of(lens, 2500, seed=12)


def test_row_shapes_of_the_kernel_cases():
    """The cuda-marked cases below reach what they claim: rows of 32-64
    entries, a hub row of 2,000 among short and empty rows."""
    many = np.diff(_port_csr(_random(512, 512 * 32, seed=7)).row_ptr)
    assert 28 <= many.mean() <= 36 and many.max() >= 48
    hub = np.diff(_hub_graph().row_ptr)
    assert hub.max() == 2000 and (hub == 0).sum() >= 86 and np.sort(hub)[-2] <= 5
    h = _hub_graph()
    op = spmm.prepare_sparse_operand(h, "cpu")
    p = torch.from_numpy(np.random.default_rng(1).integers(0, 5, (2500, 9)).astype(np.float32))
    dense_a = np.zeros((600, 2500))
    np.add.at(dense_a, (h.rows(), h.col_idx), h.vals.astype(np.float64))
    np.testing.assert_array_equal(spmm.spmm_dense_acc(op, p).numpy(),
                                  (dense_a @ p.numpy()).astype(np.float32))


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """The hand-written kernel against the plain version on the card, exact:
    at float4-aligned and ragged widths with a rectangular row slice into
    an ``out`` buffer; on rows of 32-64 entries and on a hub row of 2,000
    (split across a block's warps) among short and empty rows, at m below
    one column panel, one panel plus 3 and several panels; and at an n
    whose panel narrows below 1,024 columns to fit the L2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    panel = _build.load().spmm_dense_acc_panel_cols

    def check(op, m, lo, hi):
        p = torch.randint(0, 5, (op.n_cols, m), generator=gen, device=dev,
                          dtype=torch.float32)
        before = spmm.LAUNCHES
        got = spmm.spmm_dense_acc(op, p)
        assert spmm.LAUNCHES == before + 1
        torch.testing.assert_close(got, spmm.spmm_dense_acc_reference(op, p),
                                   rtol=0, atol=0)
        out = torch.full((hi - lo, m), -1.0, device=dev)
        spmm.spmm_dense_acc(spmm.row_slice(op, lo, hi), p, out=out)
        torch.testing.assert_close(out, got[lo:hi], rtol=0, atol=0)

    for a in (_torus([4, 4, 4], 0.4, seed=4), _random(75, 300, seed=2)):
        op = spmm.prepare_sparse_operand(_port_csr(a), dev)
        for m in (a.n_cols, 1030, 3):
            check(op, m, 5, 20)
    assert panel(600, 100) == 128 and panel(600, 1027) == 1024 and panel(600, 3000) == 1024
    for h in (_port_csr(_random(512, 512 * 32, seed=7)), _hub_graph()):
        op = spmm.prepare_sparse_operand(h, dev)
        for m in (100, 1027, 3000, 1026):  # 1026: the ragged (scalar) path
            check(op, m, 290, 310)
    big = spmm.prepare_sparse_operand(_rows_of(np.full(8192, 8), 8192, seed=13), dev)
    assert panel(8192, 2051) < 1024
    check(big, 2051, 4000, 4100)


@pytest.mark.cuda
def test_cuda_kernel_is_deterministic():
    """Non-integer f32 values (uniform in [0, 1)) on rows of ~32 entries and
    on the hub graph: two runs are bit-equal (fixed summation order, no
    float atomics).  On the ~32-entry rows the plain version (products
    rounded, then added by index_add_ in any order) agrees within rtol 1e-6:
    each order of ~32-55 positive terms is within ~5e-7 of the exact sum.
    The hub row, 2,000 terms split 8 ways, is held against a float64 sum
    within rtol 1e-5 (the f32 rounding of 250-term runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    for h, m in ((_port_csr(_random(512, 512 * 32, seed=7)), 260),
                 (_port_csr(_random(512, 512 * 32, seed=7)), 1024), (_hub_graph(), 1024)):
        op = spmm.prepare_sparse_operand(h, dev)
        op = spmm.SparseOperand(op.row_ptr, op.col_idx,
                                torch.rand(op.vals.numel(), generator=gen, device=dev),
                                op.n_rows, op.n_cols)
        p = torch.rand(op.n_cols, m, generator=gen, device=dev)
        first = spmm.spmm_dense_acc(op, p)
        assert torch.equal(first, spmm.spmm_dense_acc(op, p))
        if h.n_rows == 512:
            torch.testing.assert_close(first, spmm.spmm_dense_acc_reference(op, p),
                                       rtol=1e-6, atol=0)
        else:
            rows = spmm._entry_rows(op)
            want = torch.zeros(op.n_rows, m, dtype=torch.float64, device=dev).index_add_(
                0, rows, op.vals.double()[:, None] * p.double()[op.col_idx.long()])
            torch.testing.assert_close(first.double(), want, rtol=1e-5, atol=0)
