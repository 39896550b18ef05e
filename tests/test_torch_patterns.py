"""The port's dense int8 pattern engine (``sparsetpu_torch.graphs.patterns``)
against the JAX package's (``sparsetpu.graphs.patterns``), on the CPU.

The graphs of ``tests/test_patterns.py`` (its three seeded random graphs,
directed and undirected, a 4 x 4 torus, a chain, a 5 x 5 torus, a star, a
complete graph) go through both.  Tolerance: bit for bit; frames are compared on the pattern's own
(n, m) corner, since the two pad differently (the port to a multiple of 128,
JAX to a power of two of at least 512); counts, loop counters and CSRs
exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sparsetpu import U64 as JU64
from sparsetpu.csr import SparseCSR as JCSR
from sparsetpu.graphs import generate as jgen
from sparsetpu.graphs import patterns as jpat

from sparsetpu_torch.graphs import patterns as pat
from sparsetpu_torch.interop import carry_csr


def _random_edges():
    rng = np.random.default_rng(7)
    out = []
    for n, e in ((12, 20), (30, 45), (50, 60)):
        r = rng.integers(0, n, e)
        c = rng.integers(0, n, e)
        keep = r != c
        out.append((n, list(zip(r[keep].tolist(), c[keep].tolist()))))
    return out


def _graphs():
    """name -> (JAX CSR, the port's copy on the CPU)."""
    (n0, e0), (n1, e1), (n2, e2) = _random_edges()
    coos = {"random0": jgen.from_edges(n0, e0), "random1u": jgen.from_edges(n1, e1, True),
            "random2": jgen.from_edges(n2, e2), "random2u": jgen.from_edges(n2, e2, True)}
    coos["torus4x4"] = jgen.lattice([4, 4], torus=True)
    coos["chain9"] = jgen.from_edges(9, [(i, i + 1) for i in range(8)], undirected=True)
    coos["torus5x5"] = jgen.lattice([5, 5], torus=True)
    coos["star6"] = jgen.from_edges(6, [(0, i) for i in range(1, 6)], undirected=True)
    coos["complete5"] = jgen.from_edges(5, [(i, j) for i in range(5) for j in range(5)
                                            if i != j])
    out = {}
    for name, (r, c, v, n) in coos.items():
        j = JCSR.from_coo_host(r, c, v, n, sr=JU64)
        out[name] = (j, carry_csr(j, "cpu"))
    return out


GRAPHS = _graphs()
NAMES = sorted(GRAPHS)


def _frame(x) -> np.ndarray:
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _assert_csr_same(got, want):
    assert int(got.nnz) == int(want.nnz) and got.capacity == want.capacity
    np.testing.assert_array_equal(got.row_ptr.numpy(), np.asarray(want.row_ptr))
    np.testing.assert_array_equal(got.col_idx.numpy(), np.asarray(want.col_idx))
    for g, w in zip(got.values, want.values):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int64))


def _or_raises(fn):
    """fn() or the RuntimeError it raises (powers of a periodic graph
    never settle)."""
    try:
        return fn()
    except RuntimeError as e:
        return e


# which of the engine's algorithms each graph takes, as in tests/test_patterns.py:
# reachability on the directed graphs, power-until-stable on the undirected
# ones, the diameter on the connected ones, components on both random kinds
ALGOS = {"random0": ("rsum", "cc"), "random2": ("rsum", "cc"),
         "random1u": ("pus", "cc"), "random2u": ("pus", "cc"), "torus4x4": ("pus",),
         "chain9": ("diameter", "rsum"), "torus5x5": ("diameter",), "star6": ("diameter",),
         "complete5": ("diameter", "pus")}


@pytest.fixture(scope="module")
def jax_results():
    """JAX's answers for every graph, computed once."""
    calls = {"diameter": jpat.diameter, "pus": jpat.power_until_stable,
             "rsum": jpat.reachability_sum, "cc": jpat.connected_components_closure}
    res = {}
    for name, (j, _) in GRAPHS.items():
        x0 = jpat.from_csr(j, pad_to=jpat.bucket(j.n_rows))
        closure, start, k, p2 = jpat.closure_while(jpat.add_identity(x0))
        reach, rk = jpat.reachability_while(x0)
        res[name] = dict(
            frame=np.asarray(jpat.from_csr(j)), closure=np.asarray(closure),
            start=np.asarray(start), k=int(k), p2=int(p2), reach=np.asarray(reach),
            rk=int(rk), reps=np.asarray(jpat._mutual_reps(closure)),
            **{key: _or_raises(lambda: calls[key](j)) for key in ALGOS[name]})
    return res


@pytest.mark.parametrize("name", NAMES)
def test_from_csr_and_to_csr_match_jax(name, jax_results):
    j, a = GRAPHS[name]
    x = pat.from_csr(a)
    np.testing.assert_array_equal(_frame(x), jax_results[name]["frame"])
    np.testing.assert_array_equal(_frame(x), (a.to_dense_numpy() > 0).astype(np.int8))
    if name in ("torus4x4", "random0"):
        _assert_csr_same(pat.to_csr(x, a.sr, capacity=a.capacity),
                         jpat.to_csr(jnp.asarray(_frame(x)), j.sr, capacity=j.capacity))
    padded = pat.from_csr(a, pad_to=pat.frame_side(*a.shape))
    assert padded.shape[0] % 128 == 0
    np.testing.assert_array_equal(_frame(padded)[:a.n_rows, :a.n_cols], _frame(x))
    assert int(pat.nnz(padded)) == int(jpat.nnz(jnp.asarray(_frame(x)))) == int(a.nnz)


def test_matmul_is_the_boolean_product_as_jax():
    rng = np.random.default_rng(3)
    x = (rng.random((17, 17)) < 0.2).astype(np.int8)
    want = np.asarray(jpat.matmul(jnp.asarray(x), jnp.asarray(x)))
    got = _frame(pat.matmul(torch.from_numpy(x), torch.from_numpy(x)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ((x.astype(np.int64) @ x.astype(np.int64)) > 0))


def test_panelled_product_equals_the_unpanelled_one():
    """Panels of 160 rows on a 256-row frame holding 150 real rows: the
    panel edge at 160 lies inside the padding; a float64 reference."""
    rng = np.random.default_rng(12)
    x = np.zeros((256, 256), np.int8)
    x[:150, :150] = rng.random((150, 150)) < 0.03
    y = np.zeros((256, 256), np.int8)
    y[:150, :150] = rng.random((150, 150)) < 0.03
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    whole = pat.matmul(xt, yt, panel_rows=256)
    np.testing.assert_array_equal(_frame(pat.matmul(xt, yt, panel_rows=160)), _frame(whole))
    np.testing.assert_array_equal(_frame(pat.matmul(xt, yt, panel_rows=128)), _frame(whole))
    want = (x.astype(np.float64) @ y.astype(np.float64)) > 0
    np.testing.assert_array_equal(_frame(whole), want)
    # a column-major second operand is used as it is
    np.testing.assert_array_equal(_frame(pat.matmul(xt, pat.col_major(yt))), _frame(whole))


@pytest.mark.parametrize("name", NAMES)
def test_fixed_point_loops_match_jax(name, jax_results):
    """closure_while (closure, start, k, start_len) and reachability_while
    (S, k) on the (A | I) and A frames."""
    _, a = GRAPHS[name]
    n = a.n_rows
    want = jax_results[name]
    x0 = pat.from_csr(a, pad_to=pat.frame_side(n))
    closure, start, k, p2 = pat.closure_while(pat.add_identity(x0))
    assert (k, p2) == (want["k"], want["p2"])
    np.testing.assert_array_equal(_frame(closure)[:n, :n], want["closure"][:n, :n])
    np.testing.assert_array_equal(_frame(start)[:n, :n], want["start"][:n, :n])
    reach, rk = pat.reachability_while(x0)
    assert rk == want["rk"]
    np.testing.assert_array_equal(_frame(reach)[:n, :n], want["reach"][:n, :n])
    np.testing.assert_array_equal(pat._mutual_reps(closure).numpy()[:n], want["reps"][:n])


@pytest.mark.parametrize("name", NAMES)
def test_algorithms_match_jax(name, jax_results):
    """diameter, power_until_stable, reachability_sum (whole CSRs and k),
    reachability_nnz and connected_components_closure, as ``ALGOS`` assigns."""
    _, a = GRAPHS[name]
    want = jax_results[name]
    if "diameter" in want:
        assert pat.diameter(a) == want["diameter"]
    for fn, key in ((pat.power_until_stable, "pus"), (pat.reachability_sum, "rsum")):
        if key not in want:
            continue
        if isinstance(want[key], RuntimeError):
            with pytest.raises(pat.ConvergenceError):
                fn(a)
            continue
        got_s, got_k = fn(a)
        _assert_csr_same(got_s, want[key][0])
        assert got_k == want[key][1]
    if "rsum" in want and not isinstance(want["rsum"], RuntimeError):
        assert pat.reachability_nnz(a) == (int(want["rsum"][0].nnz), want["rsum"][1])
    if "cc" in want:
        np.testing.assert_array_equal(pat.connected_components_closure(a), want["cc"])


def test_refine_while_matches_jax():
    _, a = GRAPHS["chain9"]
    j, _ = GRAPHS["chain9"]
    base = pat.add_identity(pat.from_csr(a, pad_to=pat.frame_side(9)))
    jbase = jpat.add_identity(jpat.from_csr(j, pad_to=jpat.bucket(9)))
    # from the base itself: 7 products reach the full closure, as JAX's
    target, jtarget = int(pat.nnz(pat.closure_while(base)[0])), jpat.nnz(
        jpat.closure_while(jbase)[0])
    got = pat.refine_while(base, base, target, 1)
    assert got == int(jpat.refine_while(jbase, jbase, jtarget, jnp.int32(1))) == 8
    assert pat.refine_while(base, base, target, 1, max_steps=3) == 4  # capped, no raise


def test_loops_at_max_iters_raise_as_jax():
    _, a = GRAPHS["chain9"]
    with pytest.raises(RuntimeError):
        pat.power_until_stable(a, max_iters=2)
    with pytest.raises(RuntimeError):
        pat.reachability_sum(a, max_iters=3)
    with pytest.raises(pat.ConvergenceError):
        pat.reachability_nnz(a, max_iters=3)


def test_non_square_frame_diverges_on_purpose():
    """The port pads a wide matrix to max(n_rows, n_cols); JAX pads to
    bucket(n_rows) only and refuses the wider one.  Unpadded, both agree."""
    r, c, v, _ = jgen.random_graph(600, 900, seed=4)
    keep = r < 5
    j = JCSR.from_coo(r[keep], c[keep], v[keep], 5, 600, sr=JU64)
    a = carry_csr(j, "cpu")
    np.testing.assert_array_equal(_frame(pat.from_csr(a)), np.asarray(jpat.from_csr(j)))
    side = pat.frame_side(*a.shape)
    assert side == 640 and pat.frame_side(5) == 128
    padded = _frame(pat.from_csr(a, pad_to=side))
    np.testing.assert_array_equal(padded[:5, :600], np.asarray(jpat.from_csr(j)))
    assert not padded[5:].any() and not padded[:, 600:].any()
    with pytest.raises(AssertionError):
        jpat.from_csr(j, pad_to=jpat.bucket(j.n_rows))  # 512 < 600
    with pytest.raises(ValueError):
        pat.from_csr(a, pad_to=512)


def test_frame_cap_is_sized_for_the_card():
    """JAX's cap stays for the route comparisons; the card's admits nell
    (65,755) and not ogbn-arxiv (169,343)."""
    for n in (2708, 27000, 32768, 32769, 65755):
        assert pat.fits(n, pat.JAX_MAX_PATTERN_N) == jpat.fits(n)
    assert pat.JAX_MAX_PATTERN_N == jpat.MAX_PATTERN_N == 32768
    assert pat.fits(65755) and not jpat.fits(65755)
    assert not pat.fits(169343)
    assert pat.MAX_PATTERN_N == 103168
    assert pat.FRAMES_HELD * pat.MAX_PATTERN_N ** 2 <= pat.PATTERN_BUDGET_BYTES
    # nell's frame: 65,792^2 int8, not JAX's 131,072^2 bucket
    assert pat.frame_side(65755) == 65792 and jpat.bucket(65755) == 131072


@pytest.mark.cuda
def test_cuda_engine_matches_the_cpu():
    """On the card (cuBLAS's int8 product, the panelled counts and
    compares, argmax on int8) every algorithm of the engine equals the
    CPU's on this module's graphs, and a panelled product with a panel edge
    inside the padding equals a float64 reference."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from sparsetpu_torch.csr import SparseCSR

    dev = torch.device("cuda")
    rng = np.random.default_rng(12)
    x = np.zeros((256, 256), np.int8)
    x[:150, :150] = rng.random((150, 150)) < 0.03
    xt = torch.from_numpy(x).to(dev)
    want = (x.astype(np.float64) @ x.astype(np.float64)) > 0
    for rows in (160, 256):
        np.testing.assert_array_equal(pat.matmul(xt, xt, panel_rows=rows).cpu().numpy(), want)
    for name in NAMES:
        _, a = GRAPHS[name]
        g = SparseCSR(row_ptr=a.row_ptr.to(dev), col_idx=a.col_idx.to(dev),
                      values=tuple(v.to(dev) for v in a.values), nnz=a.nnz.to(dev),
                      n_rows=a.n_rows, n_cols=a.n_cols, sr_name=a.sr_name)
        assert pat.diameter(g) == pat.diameter(a), name
        np.testing.assert_array_equal(pat.connected_components_closure(g),
                                      pat.connected_components_closure(a))
        for fn in (pat.power_until_stable, pat.reachability_sum):
            try:
                want_s, want_k = fn(a)
            except pat.ConvergenceError:
                with pytest.raises(pat.ConvergenceError):
                    fn(g)
                continue
            got_s, got_k = fn(g)
            assert got_k == want_k
            np.testing.assert_array_equal(got_s.to_dense_numpy(), want_s.to_dense_numpy())
