"""The port's sharded block-band product (sparsetpu_torch.dist.band) against
the JAX package's (sparsetpu.dist.band), on the CPU: the counterparts of
tests/test_dist_band.py's three cases, at 2 and 4 shards.

The port side runs as one gloo world a size for the module, every case in
one spawn; the JAX side on conftest's virtual devices.  Tolerance: exact
(integer counts below 2^24 in f32: every order of the sums is exact).  The
ranks' block rows, stacked in rank order, equal JAX's sharded product, the
port's unsharded ``band_matmul`` and JAX's unsharded one, bit for bit.
"""

import jax
import numpy as np
import pytest

from sparsetpu import U64 as JU64
from sparsetpu import SparseCSR as JCSR
from sparsetpu.dist import band as jdband
from sparsetpu.dist import shard as jdist
from sparsetpu.graphs import generate as jgen
from sparsetpu.kernels import bandmm as jb

from sparsetpu_torch.dist import programs, run_local
from sparsetpu_torch.interop import carry_csr
from sparsetpu_torch.kernels import bandmm as tb

SIZES = (2, 4)
# name: (graph, half-width, block, cyclic, the (p_limbs, a_limbs) of each step)
CASES = {
    "cyclic chain": (lambda: jgen.thin(jgen.lattice([4, 4, 4], torus=True), 0.5, seed=2),
                     21, 8, True, [(0, 0), (2, 1)]),
    "noncyclic": (lambda: jgen.lattice([64], torus=False), 7, 8, False, [(0, 0)]),
    "fold cyclic": (lambda: jgen.lattice([4, 4, 4], torus=True), 21, 8, True, [(0, 0)]),
}


@pytest.fixture(scope="module")
def port():
    cases = [{"a": programs.coo_arrays(g()), "half_width": hw, "block": b, "cyclic": cyc,
              "limbs": limbs} for g, hw, b, cyc, limbs in CASES.values()]
    out = {}
    for nd in SIZES:
        ranks = run_local(programs.band_cases, nd, cases, device="cpu", verbose=False)
        # each step's product: every rank's block rows, in rank order
        out[nd] = {name: [[r[i][k] for r in ranks] for k in range(len(CASES[name][4]))]
                   for i, name in enumerate(CASES)}
    return out


@pytest.mark.parametrize("nd", SIZES)
@pytest.mark.parametrize("name", list(CASES))
def test_sharded_band_matches_jax_and_single(port, nd, name):
    make, hw, block, cyclic, limbs = CASES[name]
    rows, cols, vals, n = make()
    ja = JCSR.from_coo(rows, cols, vals, n, sr=JU64)
    jband, jout = jb.csr_band_split(ja, half_width=hw, block=block, cyclic=cyclic)
    assert int(jout.nnz) == 0
    tband, _ = tb.csr_band_split(carry_csr(ja, "cpu"), half_width=hw, block=block,
                                 cyclic=cyclic)
    mesh = jdist.default_mesh(nd)
    p_sh, single, t_single = jdband.shard_band(jband, mesh=mesh), jband, tband
    for k, (pl, al) in enumerate(limbs):
        p_sh = jdband.band_matmul_sharded(p_sh, jband, p_limbs=pl, a_limbs=al, mesh=mesh)
        single = jb.band_matmul(single, jband, p_limbs=pl, a_limbs=al)
        t_single = tb.band_matmul(t_single, tband, p_limbs=pl, a_limbs=al)
        blocks = port[nd][name][k]
        # the product stays sharded: each rank holds nb / nd block rows
        assert [b.shape[0] for b in blocks] == [jband.nb // nd] * nd
        got = np.concatenate(blocks)
        np.testing.assert_array_equal(got, np.asarray(jax.device_get(p_sh.data)))
        np.testing.assert_array_equal(got, np.asarray(jax.device_get(single.data)))
        np.testing.assert_array_equal(got, t_single.data.numpy())
    if name == "fold cyclic":  # the product is wider than the matrix: folded
        assert 2 * (2 * jband.half_width_blocks) + 1 > jband.nb
        assert single.half_width_blocks == 0 and got.shape[1] == jband.nb
