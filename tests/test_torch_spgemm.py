"""The port's ESC SpGEMM and SpAdd (sparsetpu_torch.ops.spgemm) against the
JAX package's (sparsetpu.ops.spgemm), and both against an exact dense
product.

Operands: the 5x5x3 Moore torus and the non-symmetric random_graph(300,
900), with values drawn from a fixed seed per semiring (large enough to
saturate u32 and u64, small enough for the narrow u64 expansion where that
is tested).  Tolerances: u32/u64 bit for bit; f32 1e-5 relative, since the
two packages add each output's products in different orders.
"""

import numpy as np
import pytest
import torch

from sparsetpu import semiring as jsr
from sparsetpu.csr import SparseCSR as JCSR
from sparsetpu.graphs import generate as jgen
from sparsetpu.ops import spgemm as jsp

from sparsetpu_torch import semiring as psr
from sparsetpu_torch.csr import SparseCSR
from sparsetpu_torch.ops import spgemm as psp

GRAPHS = {
    "torus5x5x3": lambda: jgen.lattice([5, 5, 3], torus=True),
    "random300x900": lambda: jgen.random_graph(300, 900, seed=1),
}
# (semiring, narrow, value range): narrow needs max(A)^2 < 2^32
MODES = {
    "u32": ("u32", False, 1 << 20),
    "u64": ("u64", False, 1 << 40),
    "u64-narrow": ("u64", True, 1 << 15),
    "f32": ("f32", False, None),
}


def _operands(graph, mode):
    rows, cols, _, n = GRAPHS[graph]()
    sr_name, narrow, top = MODES[mode]
    rng = np.random.default_rng(len(graph) + len(mode))
    if sr_name == "f32":
        vals = rng.standard_normal(len(rows)).astype(np.float32)
    else:
        vals = rng.integers(1, top, len(rows)).astype(np.uint64)
    ja = JCSR.from_coo_host(rows, cols, vals, n, sr=jsr.by_name(sr_name))
    pa = SparseCSR.from_coo_host(rows, cols, vals, n, sr=psr.by_name(sr_name), device="cpu")
    return ja, pa, narrow


def _dense_exact(a_np, b_np, sr_name):
    """Saturating product in python ints (f32: float64)."""
    if sr_name == "f32":
        return (a_np.astype(np.float64) @ b_np.astype(np.float64)).astype(np.float32)
    top = (1 << 64) - 1 if sr_name == "u64" else (1 << 32) - 1
    prod = a_np.astype(object).dot(b_np.astype(object))
    return np.minimum(prod, top).astype(np.uint64)


def _assert_close(got, want, sr_name):
    if sr_name == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("graph", list(GRAPHS))
def test_spgemm_matches_jax(graph, mode):
    ja, pa, narrow = _operands(graph, mode)
    flops = int(jsp.symbolic_flops(ja, ja))
    assert psp.symbolic_flops_exact(pa, pa) == flops == jsp.symbolic_flops_exact(ja, ja)
    if narrow:
        assert psp.narrow_u64_ok(pa, pa) and jsp.narrow_u64_ok(ja, ja)
    cap = 1 << (flops - 1).bit_length()
    want = jsp.spgemm(ja, ja, cap, narrow=narrow)
    got = psp.spgemm(pa, pa, cap, narrow=narrow)
    assert int(got.check().nnz) == int(want.nnz)
    assert got.capacity == want.capacity
    sr_name = pa.sr_name
    pr, pc, pv = got.to_numpy()
    jr, jc, jv = want.to_numpy()
    np.testing.assert_array_equal(pr, jr)
    np.testing.assert_array_equal(pc, jc)
    _assert_close(pv, jv, sr_name)
    a_np = pa.to_dense_numpy()
    _assert_close(got.to_dense_numpy(), _dense_exact(a_np, a_np, sr_name), sr_name)


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_spadd_matches_jax(graph):
    ja, pa, _ = _operands(graph, "u64")
    jb, pb, _ = _operands(graph, "u64-narrow")  # other values, same pattern
    want = jsp.spadd(ja, jb)
    got = psp.spadd(pa, pb)
    assert int(got.nnz) == int(want.nnz)
    np.testing.assert_array_equal(got.to_dense_numpy(), want.to_dense_numpy())
    top = (1 << 64) - 1
    exact = np.minimum(pa.to_dense_numpy().astype(object) + pb.to_dense_numpy().astype(object),
                       top).astype(np.uint64)
    np.testing.assert_array_equal(got.to_dense_numpy(), exact)


def test_spadd_saturates_and_symbolic_flops_on_random_graph():
    rows, cols, _, n = GRAPHS["random300x900"]()
    vals = np.full(len(rows), (1 << 64) - 5, np.uint64)
    a = SparseCSR.from_coo_host(rows, cols, vals, n, sr=psr.U64, device="cpu")
    s = psp.spadd(a, a)
    assert set(s.to_numpy()[2].tolist()) == {(1 << 64) - 1}
    # the flop count is sum over A's entries of row_nnz(A)[col]: a per-row
    # count of B, so it differs for A x A^T and the graph is not symmetric
    dense = a.to_dense_numpy() != 0
    assert int(psp.symbolic_flops(a, a)) == int((dense.sum(axis=0) * dense.sum(axis=1)).sum())
    assert not np.array_equal(dense, dense.T)


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_undersized_expand_cap_poisons(graph):
    ja, pa, _ = _operands(graph, "u64")
    flops = int(psp.symbolic_flops(pa, pa))
    got = psp.spgemm(pa, pa, flops // 2)
    assert int(got.nnz) == -1 == int(jsp.spgemm(ja, ja, flops // 2).nnz)
    with pytest.raises(ValueError, match="capacity overflow"):
        got.check()
    # an output capacity below nnz(C) poisons too
    small_out = psp.spgemm(pa, pa, flops, out_cap=4)
    assert int(small_out.nnz) == -1


def test_shape_and_option_checks():
    _, pa, _ = _operands("torus5x5x3", "f32")
    b = SparseCSR.empty(pa.n_cols + 1, 3, 4, psr.F32SR, device="cpu")
    with pytest.raises(ValueError):
        psp.spgemm(pa, b, 16)
    with pytest.raises(ValueError):
        psp.spgemm(pa, pa, 16, narrow=True)
    with pytest.raises(ValueError):
        psp.spgemm(pa, pa, 0)
    assert not psp.narrow_u64_ok(pa, pa)
    assert psp.max_value(pa) == 0
