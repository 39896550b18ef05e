"""The port's graph algorithms (``sparsetpu_torch.graphs.algos``) against the
JAX package's (``sparsetpu.graphs.algos``), on the CPU.

The graphs of ``tests/test_graphs.py`` (a directed chain, a 16-chain with
its identity, two triangles, an isolated-node graph, a scrambled 12 x 4
lattice, a directed cycle, a weakly connected directed graph, a 9-chain, a
5 x 5 torus) and two seeded random graphs go through both, every algorithm
with ``dense="never"``, ``"always"`` and ``"auto"`` where it takes the
option.  Tolerance: bit for bit (u64): whole CSRs (row offsets, columns,
values, nnz), loop counts, labels, permutations and diameters.
"""

import numpy as np
import pytest

from sparsetpu import U64 as JU64
from sparsetpu.csr import SparseCSR as JCSR
from sparsetpu.graphs import algos as jalgos
from sparsetpu.graphs import generate as jgen

from sparsetpu_torch.graphs import algos, patterns
from sparsetpu_torch.interop import carry_csr

DENSE = ("never", "always", "auto")


def _pair(coo):
    r, c, v, n = coo
    j = JCSR.from_coo_host(r, c, v, n, sr=JU64)
    return j, carry_csr(j, "cpu")


def _random(n, e, seed, undirected):
    rng = np.random.default_rng(seed)
    r, c = rng.integers(0, n, e), rng.integers(0, n, e)
    keep = r != c
    return jgen.from_edges(n, list(zip(r[keep].tolist(), c[keep].tolist())), undirected)


G = {
    "chain4_directed": _pair(jgen.from_edges(4, [(0, 1), (1, 2), (2, 3)])),
    "chain16": _pair(jgen.from_edges(16, [(i, i + 1) for i in range(15)], undirected=True)),
    "triangles": _pair(jgen.from_edges(6, [(0, 1), (1, 2), (2, 0), (3, 4), (4, 5), (5, 3)],
                                       undirected=True)),
    "isolated": _pair(jgen.from_edges(5, [(0, 1)], undirected=True)),
    "lattice12x4": _pair(jgen.lattice([12, 4], torus=False)),
    "cycle_directed": _pair(jgen.from_edges(5, [(0, 1), (1, 2), (2, 3), (3, 4), (4, 0),
                                                (0, 3)])),
    "weak_directed": _pair(jgen.from_edges(6, [(0, 3), (3, 5), (1, 2)])),
    "chain9": _pair(jgen.from_edges(9, [(i, i + 1) for i in range(8)], undirected=True)),
    "torus5x5": _pair(jgen.lattice([5, 5], torus=True)),
    "random12": _pair(_random(12, 20, 7, undirected=False)),
    "random30u": _pair(_random(30, 45, 8, undirected=True)),
}


def _same_csr(got, want):
    assert int(got.nnz) == int(want.nnz) and got.shape == want.shape
    gr, gc, gv = got.to_numpy()
    wr, wc, wv = want.to_numpy()
    np.testing.assert_array_equal(gr, wr)
    np.testing.assert_array_equal(gc, wc)
    np.testing.assert_array_equal(gv, wv)


def _with_identity(name):
    j, a = G[name]
    n = a.n_rows
    return (jalgos.add(j, JCSR.identity(n, sr=JU64)),
            algos.add(a, type(a).identity(n, sr=a.sr, device="cpu")))


@pytest.fixture(scope="module")
def jax_results():
    """JAX's answers, computed once: name -> value."""
    out = {}
    for dense in DENSE:
        out["reach", dense] = jalgos.reachability_sum(G["random12"][0], pattern=True,
                                                      dense=dense)
        out["pus", dense] = jalgos.power_until_stable(_with_identity("random30u")[0],
                                                      pattern=True, dense=dense)
        out["ccc", dense] = jalgos.connected_components_closure(G["triangles"][0],
                                                                dense=dense)
        for name in ("chain9", "torus5x5"):
            out["diameter", name, dense] = jalgos.diameter(G[name][0], dense=dense)
    out["reach_counts"] = jalgos.reachability_sum(G["chain4_directed"][0])
    out["pus_counts"] = jalgos.power_until_stable(_with_identity("chain16")[0])
    for name in G:
        out["cc", name] = jalgos.connected_components(G[name][0])
    return out


@pytest.mark.parametrize("dense", DENSE)
def test_reachability_sum_matches_jax(dense, jax_results):
    got, k = algos.reachability_sum(G["random12"][1], pattern=True, dense=dense)
    want, jk = jax_results["reach", dense]
    _same_csr(got, want)
    assert k == jk
    assert algos.reachability_nnz(G["random12"][1], dense=dense) == (int(want.nnz), jk)


def test_reachability_counts_paths_as_jax(jax_results):
    """pattern=False: the sum of the powers' path counts (the sparse route)."""
    got, k = algos.reachability_sum(G["chain4_directed"][1])
    want, jk = jax_results["reach_counts"]
    _same_csr(got, want)
    assert k == jk
    np.testing.assert_array_equal(got.to_dense_numpy() > 0,
                                  np.triu(np.ones((4, 4), bool), 1))


@pytest.mark.parametrize("dense", DENSE)
def test_power_until_stable_matches_jax(dense, jax_results):
    got, k = algos.power_until_stable(_with_identity("random30u")[1], pattern=True,
                                      dense=dense)
    want, jk = jax_results["pus", dense]
    _same_csr(got, want)
    assert k == jk


def test_power_until_stable_counts_as_jax(jax_results):
    got, k = algos.power_until_stable(_with_identity("chain16")[1])
    want, jk = jax_results["pus_counts"]
    _same_csr(got, want)
    assert k == jk <= 5


@pytest.mark.parametrize("dense", DENSE)
def test_components_closure_matches_jax(dense, jax_results):
    got = algos.connected_components_closure(G["triangles"][1], dense=dense)
    np.testing.assert_array_equal(got, jax_results["ccc", dense])
    np.testing.assert_array_equal(got, [0, 0, 0, 1, 1, 1])
    np.testing.assert_array_equal(got, algos.connected_components(G["triangles"][1]))


@pytest.mark.parametrize("name", sorted(G))
def test_connected_components_matches_jax(name, jax_results):
    """Min-label propagation on the undirected view, directed and weakly
    connected graphs included."""
    got = algos.connected_components(G[name][1])
    np.testing.assert_array_equal(got, jax_results["cc", name])
    assert algos.num_components(G[name][1]) == jalgos.num_components(G[name][0])


def test_connected_components_stops_at_max_iters_as_jax():
    """Neither raises when the labels have not settled."""
    j, a = G["chain16"]
    np.testing.assert_array_equal(algos.connected_components(a, max_iters=1),
                                  jalgos.connected_components(j, max_iters=1))


@pytest.mark.parametrize("name,dense", [(n, d) for n in ("chain9", "torus5x5") for d in DENSE])
def test_diameter_matches_jax(name, dense, jax_results):
    got = algos.diameter(G[name][1], dense=dense)
    assert got == jax_results["diameter", name, dense] == {"chain9": 8, "torus5x5": 2}[name]


def test_bandwidth_stats_match_jax():
    j, a = _pair(jgen.from_edges(10, [(0, 9), (1, 2)], undirected=True))
    assert algos.bandwidth_stats(a) == jalgos.bandwidth_stats(j) == (9, 5.0)
    for name in ("lattice12x4", "random12"):
        assert algos.bandwidth_stats(G[name][1]) == jalgos.bandwidth_stats(G[name][0])


@pytest.mark.parametrize("name", ["lattice12x4_scrambled", "cycle_directed", "weak_directed",
                                  "random30u"])
def test_rcm_permute_unpermute_match_jax(name):
    """The same permutation bit for bit, the permuted matrices equal, and
    the round trip back to the input."""
    if name == "lattice12x4_scrambled":
        shuf = np.random.default_rng(11).permutation(48)
        j, a = G["lattice12x4"]
        j, a = jalgos.permute(j, shuf), algos.permute(a, shuf)
        _same_csr(a, j)
    else:
        j, a = G[name]
    (got, perm), (want, jperm) = algos.rcm(a), jalgos.rcm(j)
    np.testing.assert_array_equal(perm, jperm)
    assert sorted(perm.tolist()) == list(range(a.n_rows))
    _same_csr(got, want)
    _same_csr(algos.unpermute(got, perm), jalgos.unpermute(want, jperm))
    np.testing.assert_array_equal(algos.unpermute(got, perm).to_dense_numpy(),
                                  a.to_dense_numpy())
    if name == "lattice12x4_scrambled":
        assert algos.bandwidth_stats(got)[0] < algos.bandwidth_stats(a)[0]


def test_pattern_matmul_add_match_jax():
    j, a = G["random30u"]
    _same_csr(algos._pattern(algos.matmul(a, a)), jalgos._pattern(jalgos.matmul(j, j)))
    got, want = algos.add(a, a), jalgos.add(j, j)
    _same_csr(got, want)
    assert got.capacity == want.capacity
    p = algos._pattern(got)
    assert set(p.to_numpy()[2].tolist()) == {1}
    assert not any(l[int(p.nnz):].any() for l in p.values)  # padding stays zero


def test_route_dense():
    assert algos._route_dense(30, "auto") and algos._route_dense(30, "always")
    assert not algos._route_dense(30, "never")
    assert algos._route_dense(65755, "auto")  # the card's frame cap admits nell
    assert not algos._route_dense(169343, "auto")
    with pytest.raises(ValueError):
        algos._route_dense(169343, "always")
    with pytest.raises(ValueError):
        algos._route_dense(30, "sometimes")
    assert patterns.fits(30)
