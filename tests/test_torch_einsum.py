"""The port's einsum engine (``sparsetpu_torch.einsum.engine``) against the
JAX package's (``sparsetpu.einsum.engine``), on the CPU.

- Every tier on f32, u32 and u64, with dense, CSR and GroupedCSR operands,
  dense and sparse outputs: the same numpy inputs (fixed seeds; u32/u64
  values that saturate) go through both engines, the tier each takes is
  read by spying on the ``_try_*`` functions of both (and on the dense and
  fallback tiers), and the results must be equal bit for bit (a sparse
  output: nnz, row offsets, columns and values), or both must raise the
  same ``InvalidSpec`` kind.
- Multi-output reuse, saturation near 2^64, every ``InvalidSpec`` kind and
  the "Unsupported" boundaries of the fallback and entry-driven guards.
- A seeded sample of 320 cases of the JAX package's differential sweep
  (``scripts/einsum_sweep.py``: its enumeration and shuffle, dims a=2, b=3,
  c=4, d=5, dense/CSR/GroupedCSR masks, u64 and small-integer f32), each
  bit for bit equal to the sweep's loop-nest oracle.  The sample is drawn
  from the sweep's first 120,000 cases, on which the JAX engine equals the
  same oracle with 0 mismatches (``reports/einsum_sweep_r5.txt``).

Tolerance: none.  f32 values are small integers, whose sums are exact in
any order.

The long differential run, outside Tier-1 (the port against the JAX engine
and the oracle, case by case, with the tier each takes)::

    JAX_PLATFORMS=cpu python tests/test_torch_einsum.py --cases 10000
"""

import argparse
import contextlib
import functools
import importlib.util
import os
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:  # run as a script
    sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from sparsetpu import semiring as jsr  # noqa: E402
from sparsetpu.csr import SparseCSR as JCSR  # noqa: E402
from sparsetpu.einsum import engine as jeng  # noqa: E402
from sparsetpu.einsum.parser import InvalidSpec as JInvalidSpec  # noqa: E402
from sparsetpu.grouped import GroupedCSR as JG  # noqa: E402

from sparsetpu_torch import semiring as psr  # noqa: E402
from sparsetpu_torch.csr import SparseCSR  # noqa: E402
from sparsetpu_torch.einsum import engine as peng  # noqa: E402
from sparsetpu_torch.einsum.parser import InvalidSpec  # noqa: E402
from sparsetpu_torch.grouped import GroupedCSR  # noqa: E402
from sparsetpu_torch.interop import carry_csr, dense_limbs_from_jax, grouped_from_jax  # noqa: E402

DIMS = {"a": 2, "b": 3, "c": 4, "d": 5}  # the sweep's letters and sizes
SRS = ("f32", "u32", "u64")
# the functions whose first non-None result is the tier a spec takes
TIERS = ("_try_grouped_matmul", "_try_spmm", "_try_sparse_chain", "_try_entry_driven",
         "_dense_exec", "_fallback_loop_nest")
SAMPLE = 320  # sweep cases in Tier-1
SWEEP_RECORD = 120_000  # the JAX engine's record: the sweep's first 120,000 cases


# ---------------------------------------------------------------------------
# operands: the same numpy values, built for both engines
# ---------------------------------------------------------------------------

def _values(shape, sr_name, rng, density=0.55):
    """Nonzeros in about ``density`` of ``shape``; f32 small integers, u32
    and u64 with a few values that saturate products and sums."""
    keep = rng.random(shape) < density
    vals = rng.integers(1, 40, shape).astype(np.uint64)
    if sr_name != "f32":
        big = rng.random(shape) < 0.15
        top = (1 << 31) + 7 if sr_name == "u32" else (1 << 63) + 11
        vals = np.where(big, np.uint64(top), vals)
    vals = np.where(keep, vals, np.uint64(0))
    return vals.astype(np.float32) if sr_name == "f32" else vals


def _build(ix, kind, vals, sr_name, csr_cap=32, grouped_cap=64):
    """(JAX operand, port operand) of numpy ``vals`` as ``kind``: the JAX
    one built by the JAX package, the port's carried over from it."""
    sr = jsr.by_name(sr_name)
    if kind == "dense":
        if sr_name == "f32":
            return vals, torch.from_numpy(vals)
        if sr_name == "u32":
            v32 = vals.astype(np.uint32)
            return v32, torch.from_numpy(v32.astype(np.int64))
        limbs = tuple(np.asarray(l) for l in sr.from_numpy(vals))
        return limbs, dense_limbs_from_jax(limbs, device="cpu")
    if kind == "csr":
        r, c = np.nonzero(vals)
        j = JCSR.from_coo_host(r, c, vals[r, c], vals.shape[0], n_cols=vals.shape[1], sr=sr,
                               capacity=csr_cap)
        return j, carry_csr(j, device="cpu")
    g, n, m = vals.shape
    b, r, c = np.nonzero(vals)
    flat = JCSR.from_coo_host(b * n + r, b * m + c, vals[b, r, c], g * n, n_cols=g * m,
                              sr=sr, capacity=grouped_cap)
    j = JG(flat=flat, g=g, n=n, m=m)
    p = grouped_from_jax(flat.row_ptr, flat.col_idx, [np.asarray(x) for x in flat.values],
                         flat.nnz, sr_name, g, n, m, device="cpu")
    return j, p


@contextlib.contextmanager
def _spy(module, log):
    """Record in ``log`` each tier function of ``module`` that returns a
    result (not None)."""
    saved = {name: getattr(module, name) for name in TIERS}

    def wrap(name, f):
        def call(*args, **kwargs):
            out = f(*args, **kwargs)
            if out is not None:
                log.append(name)
            return out
        return call

    for name, f in saved.items():
        setattr(module, name, wrap(name, f))
    try:
        yield
    finally:
        for name, f in saved.items():
            setattr(module, name, f)


def _run(module, spec, ops, sr, out_format):
    """(results or ("raises", kind), tiers taken) of one engine."""
    log = []
    with _spy(module, log):
        try:
            out = module.einsum(spec, ops, sr=sr, out_format=out_format)
        except (InvalidSpec, JInvalidSpec) as e:
            out = ("raises", e.kind)
    return out, log


def _as_numpy(x):
    """A result of either engine as numpy: a CSR as (nnz, row_ptr, cols,
    limbs cut at nnz), a dense value as its limbs (int64 for the integer
    semirings, whose JAX limbs are uint32)."""
    if isinstance(x, (JCSR, SparseCSR)):
        nnz = int(x.nnz)
        vals = [np.asarray(l)[:nnz] for l in x.values]
        return ("csr", nnz, np.asarray(x.row_ptr), np.asarray(x.col_idx)[:nnz],
                [v.astype(np.float32 if v.dtype.kind == "f" else np.int64) for v in vals])
    limbs = x if isinstance(x, tuple) else (x,)
    out = []
    for l in limbs:
        a = np.asarray(l)
        out.append(a.astype(np.float32 if a.dtype.kind == "f" else np.int64))
    return ("dense", out)


def _assert_same(got, want, what):
    if isinstance(want, tuple) and want and want[0] == "raises":
        assert got == want, what
        return
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        gn, wn = _as_numpy(g), _as_numpy(w)
        assert gn[0] == wn[0], what
        if gn[0] == "csr":
            assert gn[1] == wn[1], what
            for a, b in zip(gn[2:4], wn[2:4]):
                np.testing.assert_array_equal(a, b, err_msg=what)
            gn, wn = gn[4], wn[4]
        else:
            gn, wn = gn[1], wn[1]
        assert len(gn) == len(wn), what
        for a, b in zip(gn, wn):
            assert a.shape == b.shape, what
            np.testing.assert_array_equal(a, b, err_msg=what)


def _both(spec, kinds, sr_name, seed=0, out_formats=("dense", "sparse"), dims=DIMS,
          values=None):
    """Run ``spec`` on both engines, each output format; assert equal tiers
    and results.  Returns the tiers taken (of the dense format)."""
    from sparsetpu_torch.einsum.parser import parse_spec

    rng = np.random.default_rng(seed)
    jops, pops = [], []
    for k, (ix, kind) in enumerate(zip(parse_spec(spec).inputs, kinds)):
        shape = tuple(dims[ch] for ch in ix)
        vals = values[k] if values is not None else _values(shape, sr_name, rng)
        j, p = _build(ix, kind, vals, sr_name)
        jops.append(j)
        pops.append(p)
    tiers = None
    for fmt in out_formats:
        want, jt = _run(jeng, spec, jops, jsr.by_name(sr_name), fmt)
        got, pt = _run(peng, spec, pops, psr.by_name(sr_name), fmt)
        what = f"{spec} {kinds} {sr_name} {fmt}"
        assert pt == jt, f"{what}: tiers {pt} != JAX's {jt}"
        _assert_same(got, want, what)
        tiers = jt if tiers is None else tiers
    return tiers


# ---------------------------------------------------------------------------
# every tier, every semiring
# ---------------------------------------------------------------------------

# (spec, operand kinds, the tier JAX takes on f32, on u32/u64)
TIER_CASES = [
    # grouped: one block-diagonal SpGEMM (dense whatever the format)
    ("abc,acd->abd", ("grouped", "grouped"), "_try_grouped_matmul", "_try_grouped_matmul"),
    # SpMM: sparse x dense matmul and matvec, transposed variants
    ("ab,bc->ac", ("csr", "dense"), "_try_spmm", "_try_spmm"),
    ("ab,bc->ac", ("dense", "csr"), "_try_spmm", "_try_spmm"),
    ("ba,bc->ac", ("csr", "dense"), "_try_spmm", "_try_spmm"),
    ("ab,cb->ca", ("csr", "dense"), "_try_spmm", "_try_spmm"),
    ("ab,b->a", ("csr", "dense"), "_try_spmm", "_try_spmm"),
    ("a,ab->b", ("dense", "csr"), "_try_spmm", "_try_spmm"),
    # chain: pairwise spgemm_auto, CSR intermediates
    ("ab,bc->ac", ("csr", "csr"), "_try_sparse_chain", "_try_sparse_chain"),
    ("ab,cb->ca", ("csr", "csr"), "_try_sparse_chain", "_try_sparse_chain"),
    ("ab,bc,cd->ad", ("csr", "csr", "csr"), "_try_sparse_chain", "_try_sparse_chain"),
    ("cd,ab,bc->ad", ("csr", "dense", "csr"), "_try_sparse_chain", "_try_sparse_chain"),
    # entry-driven: traces, reductions, masks, dense partners, a driving GroupedCSR
    ("ab->a", ("csr",), "_try_entry_driven", "_try_entry_driven"),
    ("aa->", ("csr",), "_try_entry_driven", "_try_entry_driven"),
    ("ab,ab->ab", ("csr", "csr"), "_try_entry_driven", "_try_entry_driven"),
    ("ab,ba->", ("csr", "csr"), "_try_entry_driven", "_try_entry_driven"),
    ("abc,ab->ac", ("grouped", "csr"), "_try_entry_driven", "_try_entry_driven"),
    ("ab,bcd->acd", ("csr", "dense"), "_try_entry_driven", "_fallback_loop_nest"),
    ("ab,ac->abc", ("csr", "dense"), "_try_entry_driven", "_fallback_loop_nest"),
    ("ab,c->abc", ("csr", "dense"), "_try_entry_driven", "_fallback_loop_nest"),
    ("abc,cd->abd", ("grouped", "dense"), "_try_entry_driven", "_fallback_loop_nest"),
    # all dense: fp32 einsum on f32, the exact loop nest on u32/u64
    ("ab,bc->ac", ("dense", "dense"), "_dense_exec", "_fallback_loop_nest"),
    ("aab,bc->ca", ("dense", "dense"), "_dense_exec", "_fallback_loop_nest"),
    # fallback on every semiring: a dense diagonal beside a sparse operand
    ("aab,bc->ac", ("dense", "csr"), "_fallback_loop_nest", "_fallback_loop_nest"),
]


@pytest.mark.parametrize("sr_name", SRS)
@pytest.mark.parametrize("spec,kinds,tier_f32,tier_int", TIER_CASES,
                         ids=[f"{c[0]}-{'-'.join(c[1])}" for c in TIER_CASES])
def test_tier_and_result_match_jax(spec, kinds, tier_f32, tier_int, sr_name):
    tiers = _both(spec, kinds, sr_name, seed=len(spec))
    assert tiers == [tier_f32 if sr_name == "f32" else tier_int]


def test_multi_output_reuses_one_contraction():
    """``ab,bc->ac,ca`` runs one SpGEMM in each engine: the permuted sibling
    is a transpose, dense and sparse; identical outputs are shared."""
    import sparsetpu.ops.spgemm as jspg
    import sparsetpu_torch.ops.spgemm as pspg

    calls = {}
    real = {mod: mod.spgemm_auto for mod in (jspg, pspg)}

    def counting(mod):
        def call(a, b, *args, **kwargs):
            calls[mod] = calls.get(mod, 0) + 1
            return real[mod](a, b, *args, **kwargs)
        return call

    try:
        for mod in real:
            mod.spgemm_auto = counting(mod)
        for sr_name in SRS:
            calls.clear()
            tiers = _both("ab,bc->ac,ca", ("csr", "csr"), sr_name, seed=5)
            assert tiers == ["_try_sparse_chain"] and calls == {jspg: 2, pspg: 2}
    finally:
        for mod, f in real.items():
            mod.spgemm_auto = f
    _both("abc->abc,cab,bca", ("dense",), "f32", seed=6)
    _both("ab->ba,ba", ("dense",), "u64", seed=7)
    _both("ab,bc->ac,ca", ("csr", "dense"), "u64", seed=8)


def test_saturation_near_2_64():
    """Products and sums that pass 2^64 saturate to u64::MAX in every tier
    that sums (SpMM, chain, entry-driven, fallback), as in JAX."""
    big = np.array([[1 << 63, (1 << 62) + 3], [5, (1 << 64) - 1]], np.uint64)
    small = np.array([[3, 0], [(1 << 32) + 1, 2]], np.uint64)
    for spec, kinds in (("ab,bc->ac", ("csr", "dense")), ("ab,bc->ac", ("csr", "csr")),
                        ("ab,ab->", ("csr", "csr")), ("ab->a", ("csr",)),
                        ("ab,bc->ac", ("dense", "dense"))):
        vals = [big, small][:len(kinds)]
        _both(spec, kinds, "u64", dims={"a": 2, "b": 2, "c": 2}, values=vals)
    (got,) = peng.einsum("ab->", [SparseCSR.from_dense_numpy(big, psr.U64, device="cpu")],
                         sr=psr.U64)
    assert int(psr.U64.to_numpy(got)) == (1 << 64) - 1


@pytest.mark.parametrize("spec,shapes,kind", [
    ("", [(2, 3)], "Empty"),
    ("ab,bc", [(2, 3), (3, 4)], "NoArrow"),
    ("ab->a->b", [(2, 3)], "MultipleArrows"),
    ("->a", [(2, 3)], "NoInputs"),
    ("ab,,bc->ac", [(2, 3), (3, 4)], "EmptyInput"),
    ("aB->a", [(2, 3)], "BadChar"),
    ("ab->aa", [(2, 3)], "RepeatedOutputIndex"),
    ("ab->ac", [(2, 3)], "OutputIndexNotInInput"),
    ("ab,bc->ac", [(2, 3)], "WrongOperandCount"),
    ("abc->a", [(2, 3)], "RankMismatch"),
    ("ab,bc->ac", [(2, 3), (4, 2)], "DimMismatch"),
])
def test_invalid_spec_kinds_match_jax(spec, shapes, kind):
    ops = [np.ones(s, np.float32) for s in shapes]
    with pytest.raises(JInvalidSpec) as je:
        jeng.einsum(spec, ops)
    with pytest.raises(InvalidSpec) as pe:
        peng.einsum(spec, [torch.from_numpy(o) for o in ops])
    assert pe.value.kind == je.value.kind == kind


def test_non_tuple_u64_dense_operand_raises_type_error():
    x = np.ones((2, 3), np.uint64)
    with pytest.raises(TypeError):
        jeng.einsum("ab->a", [x], sr=jsr.U64)
    with pytest.raises(TypeError):
        peng.einsum("ab->a", [torch.ones(2, 3, dtype=torch.int64)], sr=psr.U64)


def test_unsupported_boundaries_match_jax():
    """The fallback's joint-space guard (2^22 elements: runs at the bound,
    raises "Unsupported" one column past it), a sparse output of a 1-D spec
    ("Unsupported" in both), and the entry-driven guard (capacity x unbound
    space 2^26: entry-driven at the bound, the fallback past it)."""
    for n_cols, ok in ((2048, True), (2049, False)):
        x = np.zeros((2048, n_cols), np.uint32)
        x[::7, ::5] = 3
        x[1, 1] = 0xFFFFFFF0
        want, jt = _run(jeng, "ab->a", [x], jsr.U32, "dense")
        got, pt = _run(peng, "ab->a", [torch.from_numpy(x.astype(np.int64))], psr.U32, "dense")
        assert pt == jt == (["_fallback_loop_nest"] if ok else [])
        _assert_same(got, want, f"ab->a (2048, {n_cols})")
        assert (got == ("raises", "Unsupported")) == (not ok)
    _both("ab,bc->c", ("csr", "dense"), "f32", out_formats=("sparse",))
    vals = [_values((2, 3), "f32", np.random.default_rng(1)),
            np.ones((128, 128), np.float32)]
    for cap, tier in ((1 << 12, "_try_entry_driven"), ((1 << 12) + 1, "_fallback_loop_nest")):
        r, c = np.nonzero(vals[0])
        j = JCSR.from_coo_host(r, c, vals[0][r, c], 2, n_cols=3, sr=jsr.F32SR, capacity=cap)
        want, jt = _run(jeng, "ab,cd->ac", [j, vals[1]], jsr.F32SR, "dense")
        got, pt = _run(peng, "ab,cd->ac", [carry_csr(j, "cpu"), torch.from_numpy(vals[1])],
                       psr.F32SR, "dense")
        assert pt == jt == [tier]
        _assert_same(got, want, f"ab,cd->ac capacity {cap}")


def test_entry_driven_exact_ok_window_matches_jax():
    """An output cell of 2^16 - 1 entries: JAX's 16-bit planes decline the
    exact entry-driven tier (``exact_ok`` False) and the loop nest answers;
    the port sums whole limbs but reports ``exact_ok`` the JAX way, so it
    falls back too, with the same result; one entry fewer stays
    entry-driven in both."""
    for n_cols, tier in ((0xFFFF, "_fallback_loop_nest"), (0xFFFE, "_try_entry_driven")):
        vals = np.full((1, n_cols), 0xFFFFFFFF, np.uint64)
        j = JCSR.from_dense_numpy(vals, jsr.U32)
        want, jt = _run(jeng, "ab->a", [j], jsr.U32, "dense")
        got, pt = _run(peng, "ab->a", [carry_csr(j, "cpu")], psr.U32, "dense")
        assert pt == jt == [tier]
        _assert_same(got, want, f"ab->a, a row of {n_cols}")


def test_spmm_row_window_matches_jax():
    """A sparse row of 2^16 - 1 entries declines the exact SpMM tier in
    both engines (JAX's plane window, kept), which go on to the next tier."""
    n = 0xFFFF
    a = np.ones((1, n), np.uint64)
    d = (np.arange(n, dtype=np.uint64) % 3)[:, None]
    ja = JCSR.from_dense_numpy(a, jsr.U32)
    want, jt = _run(jeng, "ab,bc->ac", [ja, d.astype(np.uint32)], jsr.U32, "dense")
    got, pt = _run(peng, "ab,bc->ac", [carry_csr(ja, "cpu"), torch.from_numpy(d.astype(np.int64))],
                   psr.U32, "dense")
    assert pt == jt and "_try_spmm" not in pt
    _assert_same(got, want, "ab,bc->ac, a row of 2^16 - 1")


def test_entry_points_default_to_the_card():
    """Numpy operands build on the card unless a device is given."""
    x = np.ones((2, 2), np.float32)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            peng.einsum("ab->a", [x])
    (got,) = peng.einsum("ab->a", [x], device="cpu")
    assert got.device.type == "cpu" and got.tolist() == [2.0, 2.0]


# ---------------------------------------------------------------------------
# the JAX package's differential sweep: a seeded sample in Tier-1, the
# long run as a script
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _sweep():
    """The JAX package's sweep script as a module (its enumeration, masks
    and oracle), imported by path; the compile-cache threshold it lowers is
    put back."""
    prev = jax.config.jax_persistent_cache_min_compile_time_secs
    spec = importlib.util.spec_from_file_location(
        "einsum_sweep", os.path.join(ROOT, "scripts", "einsum_sweep.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", prev)
    return mod


@functools.lru_cache(maxsize=2)
def sweep_cases(n_cases: int, seeds: int = 2):
    """The sweep's first ``n_cases`` cases, in its order (its spec
    enumeration, shuffled with its generator seed): (inputs, out, kinds,
    sr_name, seed)."""
    es = _sweep()
    specs = es.gen_specs()
    order = np.random.default_rng(20260820).permutation(len(specs))
    cases = []
    for si in order:
        inputs, out = specs[si]
        for kinds in es.mask_combos(inputs):
            for sr_name in ("u64", "f32"):
                for seed in range(seeds):
                    cases.append((inputs, out, kinds, sr_name, seed))
        if len(cases) >= n_cases:
            break
    return tuple(cases[:n_cases])


def port_operand(ix, kind, sr_name, rng):
    """The sweep's ``build_operand`` for the port: the same draws, the same
    capacities (CSR 32, GroupedCSR 64).  Returns (operand, dense values)."""
    shape = tuple(DIMS[ch] for ch in ix)
    vals = rng.integers(0, 40, shape)
    vals = np.where(rng.random(shape) < 0.45, 0, vals)
    sr = psr.by_name(sr_name)
    vals = vals.astype(np.uint64 if sr_name == "u64" else np.float32)
    if kind == "dense":
        return (sr.from_numpy(vals, device="cpu") if sr_name == "u64"
                else torch.from_numpy(vals)), vals
    if kind == "csr":
        r, c = np.nonzero(vals)
        return SparseCSR.from_coo_host(r, c, vals[r, c], shape[0], shape[1], sr=sr,
                                       capacity=32, device="cpu"), vals
    g, n, m = shape
    b, r, c = np.nonzero(vals)
    flat = SparseCSR.from_coo_host(b * n + r, b * m + c, vals[b, r, c], g * n, g * m, sr=sr,
                                   capacity=64, device="cpu")
    return GroupedCSR(flat, g, n, m), vals


def port_case(inputs, out, kinds, sr_name, seed):
    """One sweep case on the port: "ok", "unsupported" or a mismatch line."""
    rng = np.random.default_rng(seed)
    ops, dense_vals = [], []
    for ix, kind in zip(inputs, kinds):
        op, dv = port_operand(ix, kind, sr_name, rng)
        ops.append(op)
        dense_vals.append(dv)
    spec = ",".join(inputs) + "->" + out
    try:
        (got,) = peng.einsum(spec, ops, sr=psr.by_name(sr_name))
    except InvalidSpec:
        return "unsupported"
    want = _sweep().oracle(inputs, out, dense_vals, sr_name)
    if sr_name == "u64":
        okay = np.array_equal(psr.U64.to_numpy(got).astype(object), want)
    else:
        okay = np.array_equal(got.numpy().astype(np.float64), want)
    return "ok" if okay else f"MISMATCH {spec} {kinds} {sr_name} s{seed}"


@functools.lru_cache(maxsize=1)
def _sample():
    cases = sweep_cases(SWEEP_RECORD)
    pick = np.sort(np.random.default_rng(12).choice(len(cases), SAMPLE, replace=False))
    return [cases[i] for i in pick]


@pytest.mark.parametrize("k", range(SAMPLE))
def test_sweep_sample_matches_the_oracle(k):
    case = _sample()[k]
    assert port_case(*case) == "ok", case


def _jax_case(inputs, out, kinds, sr_name, seed):
    """One sweep case on both engines from the same draws (the JAX operand
    built by the sweep's ``build_operand``, the port's carried over): the
    port must take JAX's tier and give JAX's result, and JAX's must be the
    oracle's.  Returns the tier taken, "unsupported" or a mismatch line."""
    es = _sweep()
    rng = np.random.default_rng(seed)
    jops, pops, dense_vals = [], [], []
    for ix, kind in zip(inputs, kinds):
        j, dv = es.build_operand(ix, kind, sr_name, rng)
        if kind == "dense":
            p = dense_limbs_from_jax(j, "cpu") if sr_name == "u64" else torch.from_numpy(j)
        elif kind == "csr":
            p = carry_csr(j, "cpu")
        else:
            p = grouped_from_jax(j.flat.row_ptr, j.flat.col_idx,
                                 [np.asarray(x) for x in j.flat.values], j.flat.nnz,
                                 sr_name, j.g, j.n, j.m, device="cpu")
        jops.append(j)
        pops.append(p)
        dense_vals.append(dv)
    spec = ",".join(inputs) + "->" + out
    want, jt = _run(jeng, spec, jops, jsr.by_name(sr_name), "dense")
    got, pt = _run(peng, spec, pops, psr.by_name(sr_name), "dense")
    tag = f"{spec} {kinds} {sr_name} s{seed}"
    if pt != jt:
        return f"MISMATCH tier {pt} != JAX's {jt}: {tag}"
    try:
        _assert_same(got, want, tag)
    except AssertionError:
        return f"MISMATCH result != JAX's: {tag}"
    if want[0] == "raises":
        return "unsupported"
    oracle = es.oracle(inputs, out, dense_vals, sr_name)
    if sr_name == "u64":
        okay = np.array_equal(jsr.U64.to_numpy(want[0]).astype(object), oracle)
    else:
        okay = np.array_equal(np.asarray(want[0], np.float64), oracle)
    return jt[0] if okay else f"MISMATCH oracle: {tag}"


def main(argv=None):
    ap = argparse.ArgumentParser(description="The port's einsum engine against the JAX "
                                 "engine on the sweep of scripts/einsum_sweep.py")
    ap.add_argument("--cases", type=int, default=10_000)
    ap.add_argument("--out", default=os.path.join(ROOT, "reports", "einsum_sweep_torch.txt"))
    args = ap.parse_args(argv)
    cases = sweep_cases(args.cases)
    with open(args.out, "w") as log:
        def emit(s):
            print(s, flush=True)
            log.write(s + "\n")
            log.flush()

        emit(f"# the port's einsum engine against sparsetpu.einsum (and the sweep's oracle), "
             f"case by case, tier and result, on the CPU: the first {len(cases)} cases of "
             f"scripts/einsum_sweep.py's order, dims {DIMS}; "
             f"python tests/test_torch_einsum.py --cases {args.cases}")
        t0 = time.time()
        n_ok = n_unsup = 0
        tiers = dict.fromkeys(TIERS, 0)
        mismatches = []
        for i, case in enumerate(cases):
            if (i + 1) % 1000 == 0:
                jax.clear_caches()  # bound the live XLA:CPU executables, as the sweep does
            r = _jax_case(*case)
            if r in tiers:
                n_ok += 1
                tiers[r] += 1
            elif r == "unsupported":
                n_unsup += 1
            else:
                mismatches.append(r)
                emit(r)
            if (i + 1) % 1000 == 0:
                dt = time.time() - t0
                emit(f"progress {i + 1}/{len(cases)} ok={n_ok} unsupported={n_unsup} "
                     f"mismatches={len(mismatches)} {dt:.0f}s ({(i + 1) / dt:.1f} cases/s)")
        emit(f"DONE cases={len(cases)} ok={n_ok} unsupported={n_unsup} "
             f"mismatches={len(mismatches)} wall={time.time() - t0:.0f}s; tiers taken "
             f"(the same in both engines): {tiers}")
    return 1 if mismatches else 0


if __name__ == "__main__":
    sys.exit(main())
