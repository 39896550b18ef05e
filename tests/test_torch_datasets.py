"""The port's numpy copy of the graph datasets (sparsetpu_torch.graphs.datasets)
against the JAX package's (sparsetpu.graphs.datasets): bit-identical graphs
for the same seed, and the same statistics and checks."""

import numpy as np
import pytest

from sparsetpu.graphs import datasets as jdata

from sparsetpu_torch.graphs import datasets as pdata


def _assert_same_coo(got, want):
    assert got[3] == want[3]
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", [0, 3, 17])
@pytest.mark.parametrize("n,m", [(300, 8), (400, 6), (50, 1)])
def test_power_law_matches_jax(n, m, seed):
    got, want = pdata.power_law(n, m, seed=seed), jdata.power_law(n, m, seed=seed)
    _assert_same_coo(got, want)
    assert pdata.degree_stats(got) == jdata.degree_stats(want)


@pytest.mark.parametrize("seed", [1, 2, 5])
def test_power_law_target_edges_matches_jax(seed):
    kw = dict(m_per_node=2, seed=seed, target_directed_edges=10556)
    got, want = pdata.power_law(2708, **kw), jdata.power_law(2708, **kw)
    _assert_same_coo(got, want)
    assert abs(len(got[0]) - 10556) < 0.05 * 10556


def test_check_substitute_agrees_with_jax():
    good = pdata.power_law(2708, 2, seed=0, target_directed_edges=10556)
    want = jdata.check_substitute("cora", good)
    assert pdata.check_substitute("cora", good) == want
    wrong = pdata.power_law(500, 3, seed=0)
    with pytest.raises(AssertionError):
        jdata.check_substitute("cora", wrong)
    with pytest.raises(AssertionError, match="cora"):
        pdata.check_substitute("cora", wrong)
    assert pdata.PUBLISHED_STATS == jdata.PUBLISHED_STATS


@pytest.mark.parametrize("undirected", [False, True])
def test_load_edges_matches_jax(tmp_path, undirected):
    path = tmp_path / "g.edges"
    path.write_text("# a comment\n0 1\n1 2\n\n2 0\n1 2\n4 3\n")
    _assert_same_coo(pdata.load_edges(str(path), undirected),
                     jdata.load_edges(str(path), undirected))


def test_power_law_rejects_bad_sizes():
    with pytest.raises(ValueError):
        pdata.power_law(3, 3)
