"""The frozen generators give the port's arrays bit for bit, the torus is
the reference's matrix, and the seed only renames nodes."""

import json
import os

import numpy as np
import pytest

from sparsetpu_torch.graphs import generate
from sparsetpu_torch.utils import stdrng
from spbench import frozen, reference
from spbench.generators import moore_torus
from spbench.tests import toy


def _same(a, b):
    assert a[3] == b[3]
    for x, y in zip(a[:3], b[:3]):
        assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("dims,torus", [([6, 6, 6], True), ([5, 4], False), ([3, 2, 4], True),
                                        ([30, 30, 30], True)])
def test_lattice_is_the_ports(dims, torus):
    _same(frozen.lattice(dims, torus), generate.lattice(dims, torus))


SEEDS = [b"\x2a" * 32, bytes(range(32))]


@pytest.mark.parametrize("seed", SEEDS)
def test_stdrng_is_the_ports(seed):
    key = np.frombuffer(seed, "<u4").copy()
    assert np.array_equal(frozen.chacha12_words(key, 5, 3), stdrng.chacha12_words(key, 5, 3))
    got, want = frozen.StdRng(seed), stdrng.StdRng(seed)
    for count in (1, 7, 8, 33, 100):  # across blocks and the buffer's refill
        assert np.array_equal(got.next_u64(count), want.next_u64(count))
        assert np.array_equal(got.unit_f64(count), want.unit_f64(count))


def test_thin_reference_is_the_ports_and_gives_the_published_counts():
    """One [42; 32] stream thinning the 10^3, 15^3 and 20^3 tori in turn:
    the reference's committed 4,070 / 13,844 / 31,936 entries."""
    got_rng, want_rng = frozen.StdRng(), stdrng.StdRng()
    for side, nnz in ((10, 4070), (15, 13844), (20, 31936)):
        rows, cols, vals, _ = generate.lattice([side] * 3, torus=True)
        got = frozen.thin_reference(rows, cols, vals, 4 / 26, got_rng)
        want = stdrng.thin_reference(rows, cols, vals, 4 / 26, want_rng)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)
        assert len(got[0]) == nnz


def test_torus30_is_the_readmes_matrix():
    """The configuration's graph gives the README's per-step entry counts
    (README.md:39-46: 252k, 655k, 1.57M, ...) on every seed."""
    cfg = json.load(open(os.path.join(toy.SPBENCH, "configs", "torus30.json")))
    for seed in (0, 2**31 + 3):
        rows, cols, vals, n = moore_torus.build(cfg, seed)
        a = reference.from_coo(rows, cols, vals, n, "cpu")
        p, got = a, []
        for _ in range(3):
            p = reference.matmul(p, a)
            got.append(p.nnz)
        assert (n, a.nnz, got) == (27_000, 81_434, [251_590, 655_391, 1_574_848])
        assert [f"{round(got[0] / 1e3)}k", f"{round(got[1] / 1e3)}k", f"{got[2] / 1e6:.2f}M"] == \
            ["252k", "655k", "1.57M"]


def _dense(coo):
    r, c, v, n = coo
    d = np.zeros((n, n), np.int64)
    d[r, c] = v.astype(np.int64)
    return d


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 11])
def test_torus_symmetry_maps_the_lattice_onto_itself(seed):
    lat = frozen.lattice([5, 5, 5], True)
    perm = moore_torus.symmetry([5, 5, 5], seed)
    assert sorted(perm.tolist()) == list(range(125))
    assert np.array_equal(_dense(frozen.relabel(lat, perm)), _dense(lat))


@pytest.mark.parametrize("cfg", [{"dims": [6, 6, 6], "density": 3 / 26, "thin_seed": 42},
                                 {"dims": [5, 4, 3], "density": 0.3, "thin_seed": 7}])
def test_seeds_give_the_same_work_in_another_order(cfg):
    gen = moore_torus
    a, b = _dense(gen.build(cfg, 1)), _dense(gen.build(cfg, 2**31 + 5))
    assert not np.array_equal(a, b)
    for k in range(1, 4):  # the same entry counts and values at every power
        assert np.count_nonzero(a) == np.count_nonzero(b)
        assert np.array_equal(np.sort(a, axis=None), np.sort(b, axis=None))
        a, b = a @ _dense(gen.build(cfg, 1)), b @ _dense(gen.build(cfg, 2**31 + 5))
