"""The port's public SpGEMM router (sparsetpu_torch.ops.spgemm.spgemm_auto)
against the JAX package's (sparsetpu.ops.spgemm.spgemm_auto), on the CPU.

- Routes: ``auto_route`` against the calls JAX's cascade makes, recorded by
  replacing its route functions, over shapes and product counts that reach
  every branch (dense-dense tiers, the 2^19 ESC cut, colchunk, denseacc,
  denseacc_tiled, rowcat and the 2^31 guard);
- products: the cases JAX's own tests pin
  (``test_auto_routes_densedense_and_falls_back``,
  ``test_dense_dense_wide_i32_tier``) and every forced ``kernel=`` on one
  graph, each equal to JAX's product;
- the out-of-memory repairs: the dense-dense tiers and the colchunk
  fallback catch ``torch.cuda.OutOfMemoryError`` (injected here);
- the JAX package's doctest cases on ``device="cpu"``.

Tolerance: exact (integer semirings): nnz and the valid entries (row
offsets, columns, values) of every product.
"""

import numpy as np
import pytest
import torch

import sparsetpu.ops.spgemm as jspgemm
from sparsetpu import U64 as JU64
from sparsetpu.csr import SparseCSR as JCSR
from sparsetpu.graphs.generate import random_graph
from sparsetpu.ops import colchunk as jcolchunk, denseacc as jdenseacc, rowcat as jrowcat

from sparsetpu_torch import SparseCSR, U64, spadd, spgemm_auto
from sparsetpu_torch.interop import carry_csr
from sparsetpu_torch.ops import colchunk, denseacc, spgemm as tspgemm


def _assert_product(got, want):
    assert int(got.nnz) == int(want.nnz)
    for g, w in zip(got.to_numpy(), want.to_numpy()):
        np.testing.assert_array_equal(g.astype(np.int64), np.asarray(w).astype(np.int64))


class _Called(Exception):
    pass


def _jax_route(monkeypatch, n, flops):
    """The route calls JAX's spgemm_auto makes for an empty n x n operand
    whose product count reads ``flops``: [("densedense", wide)...] then the
    route, each recorded; a dense-dense tier "poisons" so the cascade goes
    on."""
    calls = []

    class Poisoned:
        def check(self):
            raise ValueError("poisoned")

    def record(name):
        def fn(a, b, *args, **kw):
            calls.append(name)
            raise _Called
        return fn

    def dd(a, b, out_cap=None, wide=False):
        calls.append(("densedense", wide))
        return Poisoned()

    monkeypatch.setattr(jspgemm, "symbolic_flops_exact", lambda a, b: flops)
    monkeypatch.setattr(jdenseacc, "spgemm_dense_dense", dd)
    monkeypatch.setattr(jdenseacc, "spgemm_dense_acc", record("denseacc"))
    monkeypatch.setattr(jdenseacc, "spgemm_dense_acc_tiled", record("denseacc_tiled"))
    monkeypatch.setattr(jcolchunk, "spgemm_colchunk", record("colchunk"))
    monkeypatch.setattr(jrowcat, "spgemm_rowcat", record("rowcat"))
    monkeypatch.setattr(jspgemm, "spgemm", record("esc"))
    a = JCSR.empty(n, n, 1, JU64)
    try:
        jspgemm.spgemm_auto(a, a)
    except _Called:
        pass
    except ValueError:  # the 2^31 guard
        calls.append("ValueError")
    return calls


ROUTE_CASES = [(200, 10_000), (8000, 1 << 18), (8000, 1 << 22), (27000, 1 << 18),
               (27000, 1 << 22), (27000, 1 << 29), (65000, 1 << 22), (65000, 1 << 29),
               (400_000, 1 << 29), (400_000, 1 << 31)]


@pytest.mark.parametrize("n,flops", ROUTE_CASES)
def test_auto_route_matches_jax_cascade(monkeypatch, n, flops):
    want = _jax_route(monkeypatch, n, flops)
    a = SparseCSR.empty(n, n, 1, U64, device="cpu")
    tiers, route = tspgemm.auto_route(a, a, flops)
    got = [("densedense", w) for w in tiers]
    if flops >= 1 << 31 and route in ("esc", "rowcat"):
        got.append("ValueError")
        monkeypatch.setattr(tspgemm, "symbolic_flops_exact", lambda a, b: flops)
        with pytest.raises(ValueError, match="cannot be materialized"):
            spgemm_auto(a, a)
    else:
        got.append(route)
    assert got == want


@pytest.fixture(scope="module")
def jax_pinned():
    """The two graphs of JAX's pinned auto tests and JAX's products."""
    r, c, v, n = random_graph(200, 4000, seed=31)
    out = {}
    for name, vals in (("small", v), ("wide_inputs", v.astype(np.uint64) * (1 << 20))):
        j = JCSR.from_coo_host(r, c, vals, n)
        out[name] = (j, jspgemm.spgemm_auto(j, j))
    r, c, v, n = random_graph(150, 900, seed=41)
    j = JCSR.from_coo_host(r, c, (v.astype(np.uint64) % 7 + 1) * 1200, n)
    out["wide_outputs"] = (j, jspgemm.spgemm_auto(j, j))
    return out


@pytest.mark.parametrize("name,tiers", [("small", [False, True]), ("wide_inputs", [True]),
                                        ("wide_outputs", [False, True])])
def test_pinned_cases_route_and_match_jax(jax_pinned, name, tiers):
    """random_graph(200, 4000) takes the f32 dense-dense tier; its values
    times 2^20 skip it and poison the wide tier, so the sort path answers;
    random_graph(150, 900) times 1200 poisons the f32 tier and the wide
    tier answers (JAX's test_dense_dense_wide_i32_tier)."""
    j, want = jax_pinned[name]
    a = carry_csr(j, "cpu")
    got_tiers, _ = tspgemm.auto_route(a, a, tspgemm.symbolic_flops_exact(a, a))
    assert got_tiers == tiers
    _assert_product(spgemm_auto(a, a), want)


FORCED = ("esc", "rowcat", "denseacc", "denseacc_tiled", "densedense", "colchunk", "slab",
          "escb")


@pytest.fixture(scope="module")
def er300():
    j = JCSR.from_coo_host(*random_graph(300, 1500, seed=2))
    return j, carry_csr(j, "cpu")


@pytest.mark.parametrize("kernel", FORCED)
def test_forced_kernels_match_jax(er300, kernel):
    j, a = er300
    _assert_product(spgemm_auto(a, a, kernel=kernel), jspgemm.spgemm_auto(j, j, kernel=kernel))


def test_fallbacks_and_guards(er300, monkeypatch):
    """denseacc on a value past the f32 carrier falls back to rowcat (as
    JAX); an unknown kernel and mismatched shapes raise."""
    rows = np.array([0, 1, 2])
    big = np.array([1 << 30, 3, 1 << 30], np.uint64)
    j = JCSR.from_coo_host(rows, [1, 2, 0], big, 3)
    a = carry_csr(j, "cpu")
    for kernel in ("denseacc", "denseacc_tiled"):
        _assert_product(spgemm_auto(a, a, kernel=kernel), jspgemm.spgemm_auto(j, j,
                                                                              kernel=kernel))
    with pytest.raises(ValueError, match="unknown kernel"):
        spgemm_auto(a, a, kernel="pallas")
    with pytest.raises(ValueError, match="chain"):
        spgemm_auto(a, er300[1])


def _oom(*args, **kw):
    raise torch.cuda.OutOfMemoryError("CUDA out of memory (injected)")


def test_colchunk_fallback_catches_oom(er300, monkeypatch):
    """JAX's colchunk fallback catches ValueError only; the port's also
    catches a CUDA out-of-memory error and takes the panel sweep."""
    j, a = er300
    want = jspgemm.spgemm_auto(j, j, kernel="colchunk")
    calls = []
    tiled = denseacc.spgemm_dense_acc_tiled
    monkeypatch.setattr(colchunk, "spgemm_colchunk", _oom)
    monkeypatch.setattr(denseacc, "spgemm_dense_acc_tiled",
                        lambda *a_, **kw: calls.append(kw) or tiled(*a_, **kw))
    _assert_product(spgemm_auto(a, a, kernel="colchunk"), want)
    assert calls == [{"panel_cols": tspgemm.dense_acc_panel_cols(300)}]


def test_dense_dense_tiers_catch_oom(jax_pinned, monkeypatch):
    """Where JAX's tiers catch RESOURCE_EXHAUSTED, the port's catch a CUDA
    out-of-memory error and go on to the next tier, then the sort paths;
    other errors propagate."""
    j, want = jax_pinned["small"]
    a = carry_csr(j, "cpu")
    calls = []
    monkeypatch.setattr(denseacc, "spgemm_dense_dense",
                        lambda *a_, **kw: calls.append(kw["wide"]) or _oom())
    _assert_product(spgemm_auto(a, a), want)
    assert calls == [False, True]
    monkeypatch.setattr(denseacc, "spgemm_dense_dense",
                        lambda *a_, **kw: (_ for _ in ()).throw(RuntimeError("launch")))
    with pytest.raises(RuntimeError, match="launch"):
        spgemm_auto(a, a)


def test_package_doctest_cases_on_cpu():
    """The cases of sparsetpu/__init__.py's doctest."""
    a = SparseCSR.from_coo_host([0, 0, 1], [1, 2, 2], [1, 2, 3], 3, sr=U64, device="cpu")
    c = spgemm_auto(a, a)
    assert int(c.nnz) == 1 and int(c.get(0, 2)) == 3 == int(c.to_dense_numpy()[0, 2])
    assert int(spadd(a, a).get(0, 2)) == 4
    bad = SparseCSR.from_coo_host([0], [0], [2**63], 2, sr=U64, device="cpu")
    sq = spgemm_auto(bad, bad)
    assert int(sq.nnz) == 1 and int(sq.get(0, 0)) == 2**64 - 1
    assert tspgemm.dense_acc_panel_cols(27000) == jspgemm.dense_acc_panel_cols(27000) == 8192
    assert tspgemm.dense_acc_panel_cols(10**6) == jspgemm.dense_acc_panel_cols(10**6) == 0
