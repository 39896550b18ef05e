"""The port's elementwise ops (sparsetpu_torch.ops.elementwise: spmul,
patterns_equal) against the JAX package's (sparsetpu.ops.elementwise), on
the CPU.

Tolerance: bit for bit, the whole CSR (capacity and padded tail included),
on u64 (saturating products past 2^64 included), u32 and f32.
"""

import numpy as np
import pytest

from sparsetpu import F32SR as JF32, U32 as JU32, U64 as JU64
from sparsetpu.csr import SparseCSR as JCSR
from sparsetpu.graphs.generate import random_graph
from sparsetpu.ops import elementwise as jel

from sparsetpu_torch.interop import carry_csr
from sparsetpu_torch.ops import elementwise as el

JSR = {"u64": JU64, "u32": JU32, "f32": JF32}


def _operands(sr):
    rng = np.random.default_rng(5)
    out = []
    for seed in (1, 2):
        r, c, v, n = random_graph(120, 900, seed=seed)
        if sr == "u64":
            v = rng.integers(1, 1 << 40, len(r), dtype=np.uint64)
        elif sr == "u32":
            v = rng.integers(1, 1 << 20, len(r), dtype=np.uint64)
        else:
            v = rng.uniform(-2, 2, len(r)).astype(np.float32)
        j = JCSR.from_coo_host(r, c, v, n, sr=JSR[sr], capacity=1024 + 128 * seed)
        out.append((j, carry_csr(j, "cpu")))
    return out


def _assert_same(got, want):
    assert int(got.nnz) == int(want.nnz) and got.capacity == want.capacity
    np.testing.assert_array_equal(got.row_ptr.numpy(), np.asarray(want.row_ptr))
    np.testing.assert_array_equal(got.col_idx.numpy(), np.asarray(want.col_idx))
    for g, w in zip(got.values, want.values):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(g.numpy().dtype))


@pytest.mark.parametrize("sr", ["u64", "u32", "f32"])
def test_spmul_matches_jax(sr):
    (ja, a), (jb, b) = _operands(sr)
    want = jel.spmul(ja, jb)
    assert int(want.nnz) > 0
    _assert_same(el.spmul(a, b), want)
    _assert_same(el.spmul(a, a), jel.spmul(ja, ja))  # every entry pairs with itself


def test_spmul_clamps_at_out_cap_as_jax():
    (ja, a), (jb, b) = _operands("u64")
    want = jel.spmul(ja, jb, out_cap=8)
    assert int(want.nnz) == 8
    _assert_same(el.spmul(a, b, out_cap=8), want)
    with pytest.raises(ValueError, match="equal shapes"):
        el.spmul(a, carry_csr(JCSR.from_coo_host([0], [0], [1], 3, sr=JU64), "cpu"))


def test_patterns_equal_matches_jax():
    (ja, a), (jb, b) = _operands("u64")
    pairs = [((ja, a), (ja, a)), ((ja, a), (jb, b)),
             ((ja, a), (ja.with_capacity(2048), a.with_capacity(2048))),
             ((ja, a), (jel.spmul(ja, ja), el.spmul(a, a)))]
    got = [bool(el.patterns_equal(t1, t2)) for (_, t1), (_, t2) in pairs]
    assert got == [bool(jel.patterns_equal(j1, j2)) for (j1, _), (j2, _) in pairs]
    assert got == [True, False, True, True]
    small = JCSR.from_coo_host([0], [0], [1], 3, sr=JU64)
    assert not bool(el.patterns_equal(a, carry_csr(small, "cpu")))
    assert not bool(jel.patterns_equal(ja, small))
