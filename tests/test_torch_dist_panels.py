"""The port's B-panel ring (sparsetpu_torch.dist.panels) against the JAX
package's (sparsetpu.dist.panels), on the CPU: the counterparts of
tests/test_dist_panels.py's six cases, at 2 and 4 shards, and the ring's
order of work (the counterpart of tests/test_ring_hlo.py).

The port side runs as one gloo world a size for the module
(``dist.multihost.run_local``, every case in one spawn); the JAX side on
conftest's virtual devices.  Tolerance: exact.  The ring's shards equal
JAX's ring shards bit for bit (valid prefix and capacity) on the thinned
4^3 torus at both sizes; JAX's ring compiles for ~20 s a size here, so the
other cases hold the port's whole product against numpy's int64 product
(exact at this scale), its shards against its own replicated-B product,
and its panel flops against JAX's.
"""

import jax
import numpy as np
import pytest

from sparsetpu import U64 as JU64
from sparsetpu import SparseCSR as JCSR
from sparsetpu.dist import panels as jpanels
from sparsetpu.dist import shard as jdist
from sparsetpu.graphs import generate as jgen

from sparsetpu_torch.dist import programs, run_local

from test_torch_dist import assert_shard, whole_dense

SIZES = (2, 4)


def _coo_dense(coo):
    rows, cols, vals, n = coo
    a = np.zeros((n, n), np.int64)
    np.add.at(a, (rows, cols), vals.astype(np.int64))
    return a


def _jax_csr(coo):
    rows, cols, vals, n = coo
    return JCSR.from_coo(rows, cols, vals, n, sr=JU64)


def _overflow_operands():
    """B: every entry in rows 0-1 (panel 0); A: every row points at column
    0.  Each rank's expansion lies in its one panel-0 step."""
    n = 16
    b = (np.array([0, 0, 0, 1, 1, 1]), np.array([2, 5, 9, 3, 7, 11]), np.ones(6, np.uint64), n)
    a = (np.arange(n), np.zeros(n, np.int64), np.ones(n, np.uint64), n)
    return a, b


GRAPHS = {
    "product": lambda: jgen.thin(jgen.lattice([4, 4, 4], torus=True), 0.3, seed=1),
    "squaring": lambda: jgen.thin(jgen.lattice([4, 4, 4], torus=True), 0.4, seed=9),
    "rectangular": lambda: jgen.random_graph(21, 70, seed=5),
    "step_cap_1": lambda: jgen.lattice([4, 4], torus=True),
}


def _per_step_cap(nd):
    """JAX's test's step_cap: one under the largest (rank, panel) count."""
    a, b = (_jax_csr(x) for x in _overflow_operands())
    mesh = jdist.default_mesh(nd)
    per_panel = np.asarray(jax.device_get(jpanels.symbolic_flops_panels(
        jdist.shard(a, nd, mesh=mesh), jdist.shard(b, nd, mesh=mesh), mesh=mesh)))
    return int(per_panel.max()) - 1, per_panel


def _cases(nd):
    arrays = {k: programs.coo_arrays(g()) for k, g in GRAPHS.items()}
    a, b = (programs.coo_arrays(x) for x in _overflow_operands())
    return {
        "product": {"a": arrays["product"], "b": arrays["product"]},
        "squaring": {"a": arrays["squaring"], "b": arrays["squaring"], "square": True},
        "rectangular": {"a": arrays["rectangular"], "b": arrays["rectangular"]},
        "step_cap_1": {"a": arrays["step_cap_1"], "b": arrays["step_cap_1"], "step_cap": 1},
        "per_step": {"a": a, "b": b, "step_cap": _per_step_cap(nd)[0]},
    }


@pytest.fixture(scope="module")
def port():
    """{nd: ({case: every rank's record}, every rank's ring call order)}."""
    out = {}
    for nd in SIZES:
        cases = _cases(nd)
        ranks = run_local(programs.run_all, nd,
                          [("ring_cases", (list(cases.values()),)),
                           ("ring_call_order", (programs.coo_arrays(GRAPHS["product"]()),))],
                          device="cpu", verbose=False)
        out[nd] = ({name: [r[0][i] for r in ranks] for i, name in enumerate(cases)},
                   [r[1] for r in ranks])
    return out


def _whole(rec, k=0):
    return rec["whole"][k]


@pytest.mark.parametrize("nd", SIZES)
def test_panel_flops_match_replicated(port, nd):
    """flops[d, s] against B-panel s equal JAX's; each rank's row sum is
    its replicated-B count, which also equals JAX's."""
    ranks = port[nd][0]["product"]
    a = _jax_csr(GRAPHS["product"]())
    mesh = jdist.default_mesh(nd)
    s = jdist.shard(a, nd, mesh=mesh)
    want = np.asarray(jax.device_get(jpanels.symbolic_flops_panels(s, s, mesh=mesh)))
    want_rep = np.asarray(jax.device_get(jdist.symbolic_flops_sharded(s, a, mesh=mesh)))
    for rec in ranks:
        assert rec["flops_panels"].shape == (nd, nd)
        np.testing.assert_array_equal(rec["flops_panels"], want.astype(np.int64))
        np.testing.assert_array_equal(rec["flops_panels"].sum(axis=1), rec["flops_sharded"])
        np.testing.assert_array_equal(rec["flops_sharded"], want_rep.astype(np.int64))


@pytest.mark.parametrize("nd", SIZES)
def test_panel_spgemm_matches_single(port, nd):
    """The ring's shards equal JAX's ring shards bit for bit, its whole
    product A^2."""
    ranks = port[nd][0]["product"]
    a = _jax_csr(GRAPHS["product"]())
    mesh = jdist.default_mesh(nd)
    s = jdist.shard(a, nd, mesh=mesh)
    c = jpanels.spgemm_panels_auto(s, s, mesh=mesh)
    dense = _coo_dense(GRAPHS["product"]())
    for d, rec in enumerate(ranks):
        assert_shard(rec["shards"][0], c, d)
        np.testing.assert_array_equal(whole_dense(_whole(rec), 64), dense @ dense)
    assert int(c.total_nnz()) == sum(int(rec["shards"][0][-1]) for rec in ranks)


@pytest.mark.parametrize("nd", SIZES)
def test_panel_chain_squaring(port, nd):
    """C = P x P with P = A^2 itself ring-made: both operands the large
    sharded matrix, the case the ring is for."""
    ranks = port[nd][0]["squaring"]
    ad = _coo_dense(GRAPHS["squaring"]())
    p = ad @ ad
    for rec in ranks:
        np.testing.assert_array_equal(whole_dense(_whole(rec, 0), 64), p)
        np.testing.assert_array_equal(whole_dense(_whole(rec, 1), 64), p @ p)


@pytest.mark.parametrize("nd", SIZES)
@pytest.mark.parametrize("case", ["product", "squaring", "rectangular"])
def test_ring_shards_equal_the_replicated_product(port, nd, case):
    """With B replicated or B's panels on the ring, every shard of A x B is
    the same, bit for bit (capacity included: the ring's out_cap is the
    power of two of a rank's total flops, the replicated product's too)."""
    for rec in port[nd][0][case]:
        rp, ci, *limbs, nnz = rec["shards"][0]
        erp, eci, *elimbs, ennz = rec["esc_shard"]
        k = int(nnz)
        assert k == int(ennz) >= 0 and ci.shape == eci.shape
        np.testing.assert_array_equal(rp, erp)
        np.testing.assert_array_equal(ci[:k], eci[:k])
        for l, el in zip(limbs, elimbs):
            np.testing.assert_array_equal(l[:k], el[:k])


@pytest.mark.parametrize("nd", SIZES)
def test_panel_rectangular_padding(port, nd):
    """21 rows over 2 or 4 shards: padded tail rows take no panel rows."""
    ranks = port[nd][0]["rectangular"]
    ad = _coo_dense(GRAPHS["rectangular"]())
    for rec in ranks:
        np.testing.assert_array_equal(whole_dense(_whole(rec), 21), ad @ ad)


@pytest.mark.parametrize("nd", SIZES)
def test_panel_step_cap_overflow_poisons(port, nd):
    for rec in port[nd][0]["step_cap_1"]:
        assert _whole(rec).startswith("ValueError") and "poisoned" in _whole(rec)


@pytest.mark.parametrize("nd", SIZES)
def test_panel_per_step_overflow_poisons(port, nd):
    """One ring step over step_cap poisons even when the total over the
    steps stays under nd * step_cap (products are dropped per step)."""
    step_cap, per_panel = _per_step_cap(nd)
    assert per_panel.sum(axis=1).max() <= nd * step_cap
    ranks = port[nd][0]["per_step"]
    np.testing.assert_array_equal(ranks[0]["flops_panels"], per_panel.astype(np.int64))
    nnz = [int(rec["shards"][0][-1]) for rec in ranks]
    assert nnz[0] == -1  # rank 0's panel-0 step overflowed
    for rec in ranks:
        assert _whole(rec).startswith("ValueError") and "poisoned" in _whole(rec)


@pytest.mark.parametrize("nd", SIZES)
def test_ring_posts_its_transfer_before_its_expansion(port, nd):
    """The port's counterpart of test_ring_hlo.py: every step but the last
    posts the next panel's send/receive before it expands the held panel,
    so the transfer can overlap the expansion; the last step posts none."""
    for events in port[nd][1]:
        assert events == ["post", "expand"] * (nd - 1) + ["expand"]
