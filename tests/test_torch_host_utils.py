"""The port's numpy copies of the JAX package's host utilities against the
originals: ``utils.stdrng`` (ChaCha12 ``StdRng``, ``thin_reference``),
``utils.oracle`` (the dict-of-coordinates oracle) and ``einsum.parser``.

Tolerance: exact equality everywhere (word streams, draws, COO arrays,
oracle dicts, parsed specs, and the ``InvalidSpec`` kind of every invalid
spec).
"""

import numpy as np
import pytest

from sparsetpu.einsum import parser as jparser
from sparsetpu.graphs import generate as jgen
from sparsetpu.utils import oracle as joracle
from sparsetpu.utils import stdrng as jstdrng

from sparsetpu_torch.einsum import parser
from sparsetpu_torch.graphs import generate
from sparsetpu_torch.utils import oracle, stdrng

SEEDS = [b"\x2a" * 32, bytes(range(32))]


@pytest.mark.parametrize("seed", SEEDS)
def test_stdrng_word_streams_match_jax(seed):
    key = np.frombuffer(seed, "<u4").copy()
    np.testing.assert_array_equal(stdrng.chacha12_words(key, 5, 3),
                                  jstdrng.chacha12_words(key, 5, 3))
    got, want = stdrng.StdRng(seed), jstdrng.StdRng(seed)
    # odd draw sizes cross block boundaries and the buffer's refill
    for count in (1, 7, 8, 33, 100):
        np.testing.assert_array_equal(got.next_u64(count), want.next_u64(count))
        np.testing.assert_array_equal(got.unit_f64(count), want.unit_f64(count))
    assert got.counter == want.counter


def test_thin_reference_matches_jax_and_the_published_nnz():
    """The reference's three thins of one stream (4,070 / 13,844 / 31,936
    entries, tests/test_stdrng.py) from the port's copy, each equal to the
    original's arrays."""
    got_rng, want_rng = stdrng.StdRng(), jstdrng.StdRng()
    for side, nnz in ((10, 4070), (15, 13844), (20, 31936)):
        rows, cols, vals, _ = generate.lattice([side] * 3, torus=True)
        got = stdrng.thin_reference(rows, cols, vals, 4.0 / 26.0, got_rng)
        want = jstdrng.thin_reference(rows, cols, vals, 4.0 / 26.0, want_rng)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert len(got[0]) == nnz


@pytest.mark.parametrize("sr", ["u64", "u32", "f32"])
def test_oracle_products_match_jax(sr):
    rng = np.random.default_rng(4)
    r, c, v, n = jgen.random_graph(40, 160, seed=2)
    if sr == "f32":
        v = rng.integers(1, 5, len(r)).astype(np.float32)
    else:
        top = (1 << 64) - 1 if sr == "u64" else (1 << 32) - 1
        v = rng.integers(1, 9, len(r)).astype(np.uint64)
        v[::11] = top  # saturating products and sums
    a = joracle.coo_to_dict((r, c, v, n))
    assert oracle.coo_to_dict((r, c, v, n)) == a
    b = oracle.coo_to_dict(generate.thin(generate.lattice([40], True), 0.7, seed=1))
    assert oracle.matmul(a, b, sr) == joracle.matmul(a, b, sr)
    assert oracle.matmul(a, a, sr) == joracle.matmul(a, a, sr)
    assert oracle.add(a, b, sr) == joracle.add(a, b, sr)
    np.testing.assert_array_equal(oracle.to_dense(a, n), joracle.to_dense(a, n))
    assert oracle.nnz(a) == joracle.nnz(a)
    assert oracle.sat_mul(1 << 40, 1 << 40, "u64") == joracle.sat_mul(1 << 40, 1 << 40, "u64")


def test_scipy_oracle_matches_jax():
    coo = jgen.thin(jgen.lattice([6, 6, 6], True), 0.5, seed=3)
    assert oracle.scipy_matmul_int(coo, coo) == joracle.scipy_matmul_int(coo, coo)


@pytest.mark.parametrize("spec", ["ab,bc->ac", "ab,bc->ac,ca", "ab->", "aab,bc->c",
                                  "abc,cd,de->abe", "a->a"])
def test_parse_spec_matches_jax(spec):
    got, want = parser.parse_spec(spec), jparser.parse_spec(spec)
    assert (got.inputs, got.outputs) == (want.inputs, want.outputs)
    assert (got.slots, got.free, got.contracted) == (want.slots, want.free, want.contracted)
    assert got.canonical() == want.canonical()


@pytest.mark.parametrize("spec,kind", [
    ("", "Empty"),
    ("ab,bc", "NoArrow"),
    ("ab->a->b", "MultipleArrows"),
    ("->a", "NoInputs"),
    ("ab,,bc->ac", "EmptyInput"),
    ("aB->a", "BadChar"),
    ("ab->aa", "RepeatedOutputIndex"),
    ("ab->ac", "OutputIndexNotInInput"),
])
def test_invalid_spec_kinds_match_jax(spec, kind):
    with pytest.raises(parser.InvalidSpec) as got:
        parser.parse_spec(spec)
    with pytest.raises(jparser.InvalidSpec) as want:
        jparser.parse_spec(spec)
    assert got.value.kind == want.value.kind == kind
    assert str(got.value) == str(want.value)
    assert isinstance(got.value, ValueError)


@pytest.mark.parametrize("shapes,kind", [
    ([(2, 3), (3, 4)], None),
    ([(2, 3)], "WrongOperandCount"),
    ([(2, 3, 1), (3, 4)], "RankMismatch"),
    ([(2, 3), (4, 2)], "DimMismatch"),
])
def test_validate_dims_matches_jax(shapes, kind):
    spec, jspec = parser.parse_spec("ab,bc->ac"), jparser.parse_spec("ab,bc->ac")
    if kind is None:
        assert parser.validate_dims(spec, shapes) == jparser.validate_dims(jspec, shapes)
        return
    with pytest.raises(parser.InvalidSpec) as got:
        parser.validate_dims(spec, shapes)
    with pytest.raises(jparser.InvalidSpec) as want:
        jparser.validate_dims(jspec, shapes)
    assert got.value.kind == want.value.kind == kind
