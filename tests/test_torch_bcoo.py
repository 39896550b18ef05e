"""The port's torch.sparse comparator (sparsetpu_torch.utils.bcoo) against
the JAX package's BCOO comparator (sparsetpu.utils.bcoo), on the CPU.

Tolerance: bit for bit, the whole CSR: the values are integer counts (or
f32 values that are exact binary fractions) far below 2^24, where f32 sums
are exact in any order.
"""

import numpy as np
import pytest
import torch

from sparsetpu import F32SR as JF32, U64 as JU64
from sparsetpu.csr import SparseCSR as JCSR
from sparsetpu.graphs.generate import lattice, random_graph
from sparsetpu.utils import bcoo as jbcoo

from sparsetpu_torch import native
from sparsetpu_torch.interop import carry_csr
from sparsetpu_torch.semiring import F32SR, U64
from sparsetpu_torch.utils import bcoo


def _assert_same(got, want):
    assert int(got.nnz) == int(want.nnz) and got.capacity == want.capacity
    np.testing.assert_array_equal(got.row_ptr.numpy(), np.asarray(want.row_ptr))
    np.testing.assert_array_equal(got.col_idx.numpy(), np.asarray(want.col_idx))
    for g, w in zip(got.values, want.values):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(g.numpy().dtype))


@pytest.mark.parametrize("name,coo", [("torus555", lattice((5, 5, 5), True)),
                                      ("er100", random_graph(100, 700, seed=3))])
def test_spgemm_bcoo_matches_jax_and_oracle(name, coo):
    r, c, v, n = coo
    j = JCSR.from_coo_host(r, c, v, n, sr=JU64)
    a = carry_csr(j, "cpu")
    got = bcoo.spgemm_bcoo(a, a)
    _assert_same(got, jbcoo.spgemm_bcoo(j, j))
    h = native.as_host_csr(*a.to_numpy())
    for g, w in zip(got.to_numpy(), native.spgemm(h, h, n)):
        np.testing.assert_array_equal(g.astype(np.int64), w.astype(np.int64))


def test_round_trip_and_f32_match_jax():
    r, c, v, n = random_graph(80, 400, seed=5)
    vf = (v % 7 + 1).astype(np.float32) * 0.25
    j = JCSR.from_coo_host(r, c, vf, n, sr=JF32)
    a = carry_csr(j, "cpu")
    m = bcoo.csr_to_bcoo(a)
    jm = jbcoo.csr_to_bcoo(j)
    np.testing.assert_array_equal(m.indices().numpy().T, np.asarray(jm.indices))
    np.testing.assert_array_equal(m.values().numpy(), np.asarray(jm.data))
    _assert_same(bcoo.bcoo_to_csr(m, sr=F32SR), jbcoo.bcoo_to_csr(jm, sr=JF32))
    _assert_same(bcoo.spgemm_bcoo(a, a), jbcoo.spgemm_bcoo(j, j))


def test_u64_hi_limb_rides_the_float_and_shape_check():
    j = JCSR.from_coo_host([0, 1], [1, 0], np.array([(1 << 32) + 3, 2], np.uint64), 2, sr=JU64)
    a = carry_csr(j, "cpu")
    m = bcoo.csr_to_bcoo(a, dtype=torch.float64)
    assert m.values().tolist() == [float((1 << 32) + 3), 2.0]
    assert U64.to_numpy(bcoo.bcoo_to_csr(m).values).tolist() == [(1 << 32) + 3, 2]
    with pytest.raises(ValueError, match="chain"):
        bcoo.spgemm_bcoo(a, carry_csr(JCSR.from_coo_host([0], [0], [1], 3, sr=JU64), "cpu"))
