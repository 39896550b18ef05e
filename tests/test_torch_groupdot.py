"""The port's group-dot SpMM (sparsetpu_torch.kernels.groupdot) against the JAX
package's MXU kernel (sparsetpu.kernels.spmm_pallas.spmm_pallas_mxu,
interpret mode).

The same A (a JAX ``SparseCSR``, carried across by ``interop``) and the same
P (numpy, fixed seed) go through both.  Tolerance: exact equality
(``assert_array_equal``): A's values are below 2^8 and every value an
integer below 2^24 carried in f32, where every order of summation is exact.
The plain version contracts with ``torch.bmm``, which on the CPU has no TF32
mode; on the card TF32 is switched off before it runs
(``torch.backends.cuda.matmul.allow_tf32 = False``).

On the CPU the wrapper runs the plain limb version (u8 limbs of P, integer
batched products, the kernel's arithmetic), held equal here to the f32
version, to ``dense_a @ p`` and to JAX, on P that fills one limb and on P
that spans all three (values up to (2^24 - 1) / A's largest row sum, so
every C < 2^24).  The hand-written CUDA kernel is compared with both plain
versions only where a card is present (marker ``cuda``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparsetpu import U64, SparseCSR
from sparsetpu.graphs import generate as jgen
from sparsetpu.kernels import spmm_pallas as sp

from sparsetpu_torch.csr import HostCSR
from sparsetpu_torch.interop import csr_from_jax_host, dense_from_row_planes
from sparsetpu_torch.kernels import groupdot


def _port_csr(a: SparseCSR) -> HostCSR:
    return csr_from_jax_host(np.asarray(a.row_ptr), np.asarray(a.col_idx),
                             [np.asarray(l) for l in a.values], int(a.nnz),
                             a.n_rows, a.n_cols, a.sr_name)


def _torus(dims, density, seed):
    rows, cols, vals, n = jgen.thin(jgen.lattice(list(dims), torus=True), density, seed=seed)
    return SparseCSR.from_coo(rows, cols, vals, n, sr=U64)


def _random(n, m, seed):
    rows, cols, vals, n = jgen.random_graph(n, m, seed=seed)
    return SparseCSR.from_coo_host(rows, cols, vals, n, sr=U64)


def _three_limb_top(dense_a) -> int:
    """The largest P value with which every C = A x P stays below 2^24."""
    return (2**24 - 1) // max(int(dense_a.sum(axis=1).max()), 1)


def _p(n_rows, n_cols, seed, three_limbs, dense_a=None):
    """P of small integers (limb 0 only), or spanning all three limbs."""
    rng = np.random.default_rng(seed)
    top = _three_limb_top(dense_a) if three_limbs else 4
    p = rng.integers(0, top + 1, size=(n_rows, n_cols))
    if three_limbs:  # make sure the top limb is reached
        assert p.max() >= 1 << 16
    return p.astype(np.float32)


CASES = {
    # the shapes of tests/test_spmm_pallas.py::test_spmm_mxu_matches_numpy
    "torus4x4x4-R8-G4": (lambda: _torus([4, 4, 4], 0.4, seed=5), 8, 4, False),
    "torus8x8-R16-G8": (lambda: _torus([8, 8], 0.4, seed=9), 16, 8, False),
    "torus4x4x4-R8-G32": (lambda: _torus([4, 4, 4], 0.4, seed=5), 8, 32, False),
    # not symmetric: catches P x A computed in place of A x P
    "random64x200-R8-G8": (lambda: _random(64, 200, seed=5), 8, 8, False),
    # P spanning all three u8 limbs
    "torus4x4x4-R8-G32-three-limbs": (lambda: _torus([4, 4, 4], 0.4, seed=5), 8, 32, True),
}


@pytest.mark.parametrize("name", list(CASES))
def test_group_dot_matches_jax_mxu(name):
    make, r, g, three_limbs = CASES[name]
    a = make()
    n = a.n_rows
    p_np = _p(n, n, 1, three_limbs, a.to_dense_numpy().astype(np.float64))

    cnt, cols, m, meta = sp.tile_sparse_operand_mxu(a, rows_per_tile=r, g=g)
    c = sp.spmm_pallas_mxu(cnt, cols, m, sp.to_row_planes(jnp.asarray(p_np)),
                           rows_per_tile=r, g=g)
    want = dense_from_row_planes(jax.device_get(c), n)

    gop = groupdot.prepare_group_operand(_port_csr(a), "cpu", rows_per_tile=r, g=g)
    # the same groups: JAX's padded (T, ngmax * R, G) blocks hold the port's
    # ragged groups tile by tile, and its columns are pre-scaled by S
    ptr = gop.group_ptr.numpy()
    np.testing.assert_array_equal(np.diff(ptr) * g, np.asarray(cnt))
    m_j, cols_j = np.asarray(m), np.asarray(cols)[:, 0, :] // meta["s_planes"]
    for t in range(gop.n_tiles):
        q0, q1 = ptr[t], ptr[t + 1]
        np.testing.assert_array_equal(gop.m[q0:q1].numpy().reshape(-1, g),
                                      m_j[t, :(q1 - q0) * r])
        np.testing.assert_array_equal(gop.cols[q0 * g:q1 * g].numpy(),
                                      cols_j[t, :(q1 - q0) * g])
    got = groupdot.spmm_group_dot(gop, torch.from_numpy(p_np))
    np.testing.assert_array_equal(got.numpy(), want)
    dense_a = a.to_dense_numpy().astype(np.float64)
    np.testing.assert_array_equal(got.numpy(), (dense_a @ p_np).astype(np.float32))


@pytest.mark.parametrize("r,g", [(8, 4), (40, 32), (16, 33)])
@pytest.mark.parametrize("three_limbs", [False, True])
def test_limbs_version_equals_f32_version(r, g, three_limbs):
    """The limb version (the kernel's arithmetic) against the f32 version and
    the float64 dense product, on the non-symmetric random graph."""
    rows, cols, vals, n = jgen.random_graph(75, 300, seed=2)
    h = HostCSR.from_coo(rows, cols, vals, n)
    dense_a = np.zeros((n, n))
    np.add.at(dense_a, (h.rows(), h.col_idx), h.vals.astype(np.float64))
    p = torch.from_numpy(_p(n, 37, 4, three_limbs, dense_a))
    gop = groupdot.prepare_group_operand(h, "cpu", rows_per_tile=r, g=g)
    got = groupdot.spmm_group_dot_limbs_reference(gop, p)
    np.testing.assert_array_equal(got.numpy(), groupdot.spmm_group_dot_reference(gop, p).numpy())
    np.testing.assert_array_equal(got.numpy(), (dense_a @ p.numpy()).astype(np.float32))
    np.testing.assert_array_equal(groupdot.spmm_group_dot(gop, p).numpy(), got.numpy())


@pytest.mark.parametrize("bad", [2.0**24, -1.0, 0.5, float("nan"), float("inf")])
def test_cpu_wrapper_rejects_p_outside_the_limb_domain(bad):
    h = HostCSR.from_coo([0, 1, 2], [1, 2, 0], [1, 2, 3], 3)
    gop = groupdot.prepare_group_operand(h, "cpu", rows_per_tile=8, g=4)
    p = torch.arange(9, dtype=torch.float32).reshape(3, 3)
    p[2, 1] = bad
    for fn in (groupdot.spmm_group_dot, groupdot.spmm_group_dot_limbs_reference):
        with pytest.raises(ValueError, match="2\\^24"):
            fn(gop, p)
    # the f32 version takes any P
    assert groupdot.spmm_group_dot_reference(gop, p).shape == (3, 3)
    # the largest value of the domain, and -0.0, are inside it
    p[2, 1] = 2.0**24 - 1
    p[0, 0] = -0.0
    np.testing.assert_array_equal(groupdot.spmm_group_dot(gop, p).numpy(),
                                  groupdot.spmm_group_dot_reference(gop, p).numpy())


def test_value_guards_in_both_packages():
    # 2^8: the tile matrix must hold small integers
    a = SparseCSR.from_coo([0], [0], [300], 8, 8, sr=U64)
    with pytest.raises(ValueError, match="2\\^8"):
        sp.tile_sparse_operand_mxu(a, rows_per_tile=8)
    with pytest.raises(ValueError, match="2\\^8"):
        groupdot.prepare_group_operand(_port_csr(a), "cpu", rows_per_tile=8)
    # 2^24: the f32 carrier
    a = SparseCSR.from_coo([0], [0], [1 << 24], 8, 8, sr=U64)
    with pytest.raises(ValueError, match="2\\^24"):
        sp.tile_sparse_operand_mxu(a, rows_per_tile=8)
    with pytest.raises(ValueError, match="2\\^24"):
        groupdot.prepare_group_operand(_port_csr(a), "cpu", rows_per_tile=8)
    # just below 2^8 is fine in both
    a = SparseCSR.from_coo([0], [0], [255], 8, 8, sr=U64)
    sp.tile_sparse_operand_mxu(a, rows_per_tile=8)
    groupdot.prepare_group_operand(_port_csr(a), "cpu", rows_per_tile=8)


def test_partial_last_tile_and_padding():
    """n = 75 rows at R = 40: the last tile is partial (JAX's pad_rows), and
    every tile holds a nonzero multiple of 2G slots, padded with column 0
    and value 0."""
    rows, cols, vals, n = jgen.thin(jgen.lattice([5, 5, 3], torus=True), 0.6, seed=2)
    h = HostCSR.from_coo(rows, cols, vals, n)
    gop = groupdot.prepare_group_operand(h, "cpu")
    assert (gop.rows_per_tile, gop.g, gop.n_tiles) == (40, 32, 2)
    slots = np.diff(gop.group_ptr.numpy()) * gop.g
    assert ((slots > 0) & (slots % 64 == 0)).all()
    assert int((gop.m != 0).sum()) == h.nnz and float(gop.m.sum()) == float(h.vals.sum())
    # the kernel's forms: M as u8 with its slots zero-padded to 32, and the
    # real entries (the leading slots) of every tile
    assert gop.m8.dtype == torch.uint8 and gop.m8.shape == (gop.n_groups, 40, 32)
    np.testing.assert_array_equal(gop.m8.numpy(), gop.m.numpy())
    np.testing.assert_array_equal(gop.count.numpy(), np.bincount(h.rows() // 40, minlength=2))
    g4 = groupdot.prepare_group_operand(h, "cpu", rows_per_tile=8, g=4)
    assert g4.m8.shape == (g4.n_groups, 8, 32) and not g4.m8[:, :, 4:].any()
    np.testing.assert_array_equal(g4.m8[:, :, :4].numpy(), g4.m.numpy())
    p = torch.from_numpy(np.random.default_rng(3).integers(0, 5, (n, 7)).astype(np.float32))
    dense_a = np.zeros((n, n))
    np.add.at(dense_a, (h.rows(), h.col_idx), h.vals.astype(np.float64))
    want = (dense_a @ p.numpy()).astype(np.float32)
    np.testing.assert_array_equal(groupdot.spmm_group_dot(gop, p).numpy(), want)
    # padded tiles match JAX's pad_rows prep
    a = SparseCSR.from_coo_host(rows, cols, vals, n, sr=U64)
    cnt, _, m, _ = sp.tile_sparse_operand_mxu(a, rows_per_tile=40, pad_rows=True)
    np.testing.assert_array_equal(slots, np.asarray(cnt))


def test_checks_and_out_buffer():
    h = HostCSR.from_coo([0, 1, 2], [1, 2, 0], [1, 2, 3], 3)
    gop = groupdot.prepare_group_operand(h, "cpu", rows_per_tile=8, g=4)
    p = torch.arange(9, dtype=torch.float32).reshape(3, 3)
    out = torch.full((3, 3), -1.0)
    assert groupdot.spmm_group_dot(gop, p, out=out) is out
    np.testing.assert_array_equal(out.numpy(), [[3, 4, 5], [12, 14, 16], [0, 3, 6]])
    before = groupdot.LAUNCHES
    for kw in (dict(p=p.double()), dict(p=p.t()), dict(p=torch.zeros(4, 3)),
               dict(p=p, out=torch.zeros(3, 2)), dict(p=p, out=p)):
        with pytest.raises(ValueError):
            groupdot.spmm_group_dot(gop, **kw)
    for r, g in ((12, 32), (72, 32), (40, 0), (40, 129)):
        with pytest.raises(ValueError, match="rows_per_tile"):
            groupdot.prepare_group_operand(h, "cpu", rows_per_tile=r, g=g)
    assert groupdot.LAUNCHES == before  # the CPU path never counts a launch


@pytest.mark.cuda
def test_cuda_group_dot_kernel_matches_plain_version():
    """The hand-written kernel against both plain versions on the card: an
    even width (16-byte copies), an odd one (4-byte copies), every compiled
    R, G of 4, 8 and 32, a partial last tile, and P filling one limb or all
    three."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for a in (_torus([4, 4, 4], 0.4, seed=4), _random(75, 300, seed=2)):
        h = _port_csr(a)
        top = _three_limb_top(a.to_dense_numpy().astype(np.float64))
        for r in range(8, 65, 8):
            for g in {4, 32, 32 if r % 16 else 8}:
                gop = groupdot.prepare_group_operand(h, dev, rows_per_tile=r, g=g)
                for m in (a.n_cols, 1030, 3):
                    for hi in (5, top + 1):
                        p = torch.randint(0, hi, (a.n_cols, m), generator=gen, device=dev,
                                          dtype=torch.float32)
                        before = groupdot.LAUNCHES
                        got = groupdot.spmm_group_dot(gop, p)
                        assert groupdot.LAUNCHES == before + 1
                        for plain in (groupdot.spmm_group_dot_reference,
                                      groupdot.spmm_group_dot_limbs_reference):
                            torch.testing.assert_close(got, plain(gop, p), rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_group_dot_poisons_out_of_domain_p():
    """A P value outside [0, 2^24) or not an integer turns the output tile
    of the warp that staged it (the tile's R rows x 16 columns) into NaN;
    every entry outside those columns equals the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    h = _port_csr(_torus([4, 4, 4], 0.4, seed=4))
    gop = groupdot.prepare_group_operand(h, dev, rows_per_tile=8, g=32)
    w = groupdot.POISON_COLS
    for bad in (2.0**24, -1.0, 0.5, float("nan"), float("inf")):
        p = torch.randint(0, 5, (h.n_cols, 200), device=dev, dtype=torch.float32)
        want = groupdot.spmm_group_dot_reference(gop, p)
        p[int(h.col_idx[0]), 37] = bad  # a P row that row 0's first entry reads
        got = groupdot.spmm_group_dot(gop, p)
        j0 = 37 // w * w
        assert bool(got[:8, j0:j0 + w].isnan().all())
        outside = torch.ones(200, dtype=torch.bool, device=dev)
        outside[j0:j0 + w] = False
        torch.testing.assert_close(got[:, outside], want[:, outside], rtol=0, atol=0)
