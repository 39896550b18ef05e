"""The port's semirings (sparsetpu_torch.semiring) against the JAX package's
(sparsetpu.semiring): add and mul on u32, u64 and f32, bit for bit, at the
saturation edges and on random draws.

The port carries uint32 limbs in int64 tensors and the JAX package in uint32
arrays; both are read back as uint64 (f32 as float32) and compared exactly.
Every draw has the same length, so the JAX ops compile once.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from sparsetpu import semiring as jsr

from sparsetpu_torch import semiring as psr

N = 64
U32_MAX = (1 << 32) - 1
U64_MAX = (1 << 64) - 1
EDGES = {
    "u32": [0, 1, 2, 3, 0xFFFF, 0x10000, 0x10001, (1 << 31) - 1, 1 << 31, U32_MAX - 1,
            U32_MAX],
    "u64": [0, 1, 2, 0xFFFF, U32_MAX, 1 << 32, (1 << 32) + 1, (1 << 33) - 1, 1 << 62,
            (1 << 63) - 1, 1 << 63, U64_MAX - 1, U64_MAX],
}


def _ops(name, a, b):
    """(add, mul) from both packages, as numpy."""
    js, ps = jsr.by_name(name), psr.by_name(name)
    ja, jb = js.from_numpy(a), js.from_numpy(b)
    pa, pb = ps.from_numpy(a), ps.from_numpy(b)
    return ((js.to_numpy(js.add(ja, jb)), ps.to_numpy(ps.add(pa, pb))),
            (js.to_numpy(js.mul(ja, jb)), ps.to_numpy(ps.mul(pa, pb))))


def _exact(name, a, b):
    """Saturating add and mul in python ints."""
    top = U64_MAX if name == "u64" else U32_MAX
    add = [min(int(x) + int(y), top) for x, y in zip(a, b)]
    mul = [min(int(x) * int(y), top) for x, y in zip(a, b)]
    return np.array(add, np.uint64), np.array(mul, np.uint64)


@pytest.mark.parametrize("name", ["u32", "u64"])
def test_saturation_edges_all_pairs(name):
    edges = np.array(EDGES[name], np.uint64)
    a = np.repeat(edges, len(edges))
    b = np.tile(edges, len(edges))
    (ja, pa), (jm, pm) = _ops(name, a, b)
    np.testing.assert_array_equal(pa, ja)
    np.testing.assert_array_equal(pm, jm)
    want_add, want_mul = _exact(name, a, b)
    np.testing.assert_array_equal(pa, want_add)
    np.testing.assert_array_equal(pm, want_mul)


def test_u64_doctest_case():
    """2^63 * 2^63 saturates to u64::MAX (the JAX package's doctest), and
    products just under and at 2^64 split correctly."""
    a = np.array([1 << 63, U32_MAX, 1 << 32, (1 << 32) - 1], np.uint64)
    b = np.array([1 << 63, (1 << 32) + 1, 1 << 32, (1 << 32) + 1], np.uint64)
    (_, _), (jm, pm) = _ops("u64", a, b)
    np.testing.assert_array_equal(pm, jm)
    assert int(pm[0]) == U64_MAX
    assert int(pm[1]) == U32_MAX * ((1 << 32) + 1)  # 2^64 - 1 exactly, no saturation
    assert int(pm[2]) == U64_MAX                    # 2^64 saturates
    assert int(pm[3]) == U32_MAX * ((1 << 32) + 1)


def _draw(bits):
    return st.lists(st.integers(0, (1 << bits) - 1), min_size=N, max_size=N)


@settings(max_examples=40, deadline=None)
@given(a=_draw(32), b=_draw(32))
def test_u32_random(a, b):
    a, b = np.array(a, np.uint64), np.array(b, np.uint64)
    (ja, pa), (jm, pm) = _ops("u32", a, b)
    np.testing.assert_array_equal(pa, ja)
    np.testing.assert_array_equal(pm, jm)


@settings(max_examples=40, deadline=None)
@given(a=_draw(64), b=st.lists(st.integers(0, (1 << 33) - 1), min_size=N, max_size=N))
def test_u64_random(a, b):
    a, b = np.array(a, np.uint64), np.array(b, np.uint64)
    (ja, pa), (jm, pm) = _ops("u64", a, b)
    np.testing.assert_array_equal(pa, ja)
    np.testing.assert_array_equal(pm, jm)
    want_add, want_mul = _exact("u64", a, b)
    np.testing.assert_array_equal(pm, want_mul)
    np.testing.assert_array_equal(pa, want_add)


def test_f32_add_mul():
    rng = np.random.default_rng(0)
    a = (rng.standard_normal(N) * 1e3).astype(np.float32)
    b = rng.standard_normal(N).astype(np.float32)
    (ja, pa), (jm, pm) = _ops("f32", a, b)
    np.testing.assert_array_equal(pa, ja)
    np.testing.assert_array_equal(pm, jm)


def test_structure_and_construction():
    for name in ("u32", "u64", "f32"):
        ps = psr.by_name(name)
        z = ps.zeros((3,))
        o = ps.ones((3,))
        assert len(z) == len(o) == ps.nlimbs == jsr.by_name(name).nlimbs
        assert bool(ps.is_zero(z).all()) and not bool(ps.is_zero(o).any())
        np.testing.assert_array_equal(ps.to_numpy(ps.full((2,), 5)), [5, 5])
        picked = ps.where(torch.tensor([True, False, True]), o, z)
        np.testing.assert_array_equal(ps.to_numpy(picked), [1, 0, 1])
        assert bool(ps.equal(ps.gather(o, torch.tensor([0, 2])), ps.ones((2,))).all())
    with pytest.raises(ValueError):
        psr.U32.from_numpy(np.array([1 << 32], np.uint64))
    with pytest.raises(ValueError):
        psr.by_name("u16")
