"""The tiled dense accumulator's CSR-panel form: ``kernels/spmm``'s
``spmm_dense_acc_csr_panel`` (over ``csrc/spmm_dense_acc_csr_panel.cu``),
its plain version, ``ops/denseacc``'s form rule and plan, and the tiled
route through it.

The CPU tests hold the plain version against ``spmm_dense_acc_reference``
on the densified panel (the dense form's arithmetic) on an ER operand, a
hub row, panels with no entry of B, a ragged last panel and stored zeros,
on u32 and u64; the form rule; the plan's table, order and byte count; the
wrapper's checks; and the tiled route on Graph 500's toy of the
``graph500_s17`` deployment against the JAX package's.  The ``cuda`` tests
hold the kernel against the plain version on the card: Kronecker SCALE 10
at panel widths 256 and 2,048, panels cut into chunks (wider than 8,192
columns, and of a width not a multiple of 4), a block whose sum reaches
2^24, and the CSR-panel counter; the launches' spans and bytes are held
by ``tests/test_torch_panel_pack.py``'s span test of the tiled route.
Tolerance: exact everywhere (integer values below 2^24 in f32, where every
order of summation is exact; the 2^24 case sums powers of two).
"""

import dataclasses
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sparsetpu_torch import obs
from sparsetpu_torch.csr import SparseCSR
from sparsetpu_torch.graphs import generate
from sparsetpu_torch.interop import carry_csr
from sparsetpu_torch.kernels import spmm as kspmm
from sparsetpu_torch.ops import denseacc as td
from sparsetpu_torch.semiring import U32, U64, by_name

P = obs.PREFIX
CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "spbench", "configs", "graph500_s17.json")
SR = {"u32": U32, "u64": U64}
F32 = by_name("f32")


def _csr(rows, cols, n_rows, n_cols, sr=U64, vals=None, device="cpu"):
    rows, cols = np.asarray(rows), np.asarray(cols)
    dtype = np.float32 if sr is F32 else np.uint64
    vals = np.ones(len(rows), dtype) if vals is None else np.asarray(vals, dtype)
    return SparseCSR.from_coo_host(rows, cols, vals, n_rows, n_cols, sr=sr, device=device)


def _er(seed, n_rows, n_cols, nnz, sr):
    rng = np.random.default_rng(seed)
    return _csr(rng.integers(0, n_rows, nnz), rng.integers(0, n_cols, nnz), n_rows, n_cols, sr,
                rng.integers(1, 9, nnz))


def _hub(sr):
    """200 x 200: row 3 and column 7 full, a sparse rest."""
    rng = np.random.default_rng(11)
    n = 200
    rows = np.concatenate([np.full(n, 3), np.arange(n), rng.integers(0, n, 600)])
    cols = np.concatenate([np.arange(n), np.full(n, 7), rng.integers(0, n, 600)])
    return _csr(rows, cols, n, n, sr)


def _stored_zeros(b: SparseCSR) -> SparseCSR:
    """b with every third live value stored as 0 (a CSR may hold them)."""
    nnz = int(b.nnz)
    values = tuple(l.clone() for l in b.values)
    values[0][:nnz:3] = 0
    return dataclasses.replace(b, values=values)


def _case(name, sr):
    """(A, B, panel width) of each case."""
    if name == "er":
        return _er(1, 120, 90, 700, sr), _er(2, 90, 256, 900, sr), 64
    if name == "hub":
        a = _hub(sr)
        return a, a, 50
    if name == "empty_panels":  # no entry of B in columns [100, 200)
        b = _er(4, 90, 300, 800, sr)
        r, c, v = b.to_numpy()
        keep = (c < 100) | (c >= 200)
        rows = np.repeat(np.arange(90), np.diff(r))[keep]
        return _er(3, 60, 90, 400, sr), _csr(rows, c[keep], 90, 300, sr, v[keep]), 100
    if name == "ragged":  # 333 % 100 = 33
        return _er(5, 70, 150, 500, sr), _er(6, 150, 333, 1200, sr), 100
    if name == "stored_zeros":
        return _er(7, 80, 80, 500, sr), _stored_zeros(_er(8, 80, 80, 500, sr)), 32
    raise KeyError(name)


CASES = ("er", "hub", "empty_panels", "ragged", "stored_zeros")


# ---- CPU -------------------------------------------------------------------

@pytest.mark.parametrize("sr_name", ["u32", "u64"])
@pytest.mark.parametrize("case", CASES)
def test_the_plain_version_equals_the_dense_forms_on_the_densified_panel(case, sr_name):
    a, b, w = _case(case, SR[sr_name])
    assert td.csr_panel_form(b)
    op = td.plan_dense_acc(a)
    bp = td.plan_csr_panels(op, b, w)
    assert bp.panels == -(-b.n_cols // w)
    seen = []
    for p in range(bp.panels):
        lo, width = bp.panel(p)
        got = kspmm.spmm_dense_acc_csr_panel_reference(op, bp, p)
        want = kspmm.spmm_dense_acc_reference(op, td._densify(b, lo, width))
        assert got.shape == (a.n_rows, width) and torch.equal(got, want), p
        seen.append(int((got != 0).sum()))
    assert sum(seen) > 0
    if case == "empty_panels":
        assert seen[1] == 0
    # the whole tiled product against the untiled dense accumulator
    c, want = td.spgemm_dense_acc_tiled(a, b, panel_cols=w), td.spgemm_dense_acc(a, b)
    assert int(c.nnz) == int(want.nnz) > 0
    assert torch.equal(c.row_ptr, want.row_ptr)
    live = int(c.nnz)
    for g, x in zip((c.col_idx, *c.values), (want.col_idx, *want.values)):
        assert torch.equal(g[:live], x[:live])


def test_the_form_follows_the_semiring_and_bs_capacity():
    cell = SimpleNamespace(sr_name="u64", capacity=4_194_304, n_rows=131_072, n_cols=131_072)
    assert td.csr_panel_form(cell)  # graph500_s17.a2_auto's B: 2.4e-4 of its cells
    assert td.csr_panel_form(SimpleNamespace(**{**vars(cell), "sr_name": "u32"}))
    assert not td.csr_panel_form(SimpleNamespace(**{**vars(cell), "sr_name": "f32"}))
    er = SimpleNamespace(sr_name="u64", capacity=1 << 20, n_rows=27_000, n_cols=27_000)
    assert td.csr_panel_form(er)
    full = SimpleNamespace(sr_name="u64", capacity=10_000, n_rows=100, n_cols=100)
    assert td.csr_panel_form(full)  # B's capacity does not move the rule
    assert not td.csr_panel_form(SimpleNamespace(**{**vars(full), "sr_name": "f32"}))


def _spy(monkeypatch):
    taken = []
    for name in ("spmm_dense_acc", "spmm_dense_acc_csr_panel"):
        real = getattr(kspmm, name)

        def spy(*args, name=name, real=real):
            taken.append(name)
            return real(*args)

        monkeypatch.setattr(kspmm, name, spy)
    return taken


@pytest.mark.parametrize("sr, dense_b, form", [
    (U64, False, "spmm_dense_acc_csr_panel"), (U32, False, "spmm_dense_acc_csr_panel"),
    (F32, False, "spmm_dense_acc"), (U64, True, "spmm_dense_acc_csr_panel")])
def test_the_tiled_route_takes_the_form_the_rule_gives(monkeypatch, sr, dense_b, form):
    """Each panel of each sweep is one call of the form's wrapper: the CSR
    form on an integer B, sparse or dense, the dense form on f32."""
    a = _er(9, 60, 60, 300, sr)
    b = _csr(*np.divmod(np.arange(3600), 60), 60, 60, sr) if dense_b else a
    taken = _spy(monkeypatch)
    td.spgemm_dense_acc_tiled(a, b, panel_cols=25)  # three panels
    assert taken == [form] * 6


def test_the_plan_holds_the_table_the_order_and_the_panels_entries():
    a = _hub(U64)
    op = td.plan_dense_acc(a)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        bp = td.plan_csr_panels(op, a, 64)
    assert [e.name for e in prof.events()].count(P + "sync/b_panel_nnz") == 1
    r, c, _ = a.to_numpy()
    bounds = [0, 64, 128, 192, 200]
    want = np.array([[r[k] + np.searchsorted(c[r[k]:r[k + 1]], x) for x in bounds]
                     for k in range(a.n_rows)])
    assert np.array_equal(bp.offsets.numpy(), want)
    assert bp.offsets.dtype == torch.int32 and bp.panels == 4 and bp.panel(3) == (192, 8)
    assert bp.panel_nnz == tuple(int(((c >= x) & (c < y)).sum())
                                 for x, y in zip(bounds, bounds[1:]))
    # blocks of rows_per_block rows, most products first: the hub row's leads
    assert bp.rows_per_block == kspmm.csr_panel_rows(64) == 32
    deg = np.diff(r)
    per_row = np.array([deg[c[r[i]:r[i + 1]]].sum() for i in range(a.n_rows)])
    per_block = np.add.reduceat(per_row, np.arange(0, a.n_rows, 32))
    assert sorted(bp.order.tolist()) == list(range(len(per_block)))
    assert np.all(np.diff(per_block[bp.order.numpy()]) <= 0)
    assert bp.order[0] == int(np.argmax(per_block)) == 3 // 32
    # untraced: the same count, read the same way
    assert td.plan_csr_panels(op, a, 64).panel_nnz == bp.panel_nnz


def test_the_rows_a_block_owns():
    assert [kspmm.csr_panel_rows(w) for w in (1, 3, 256, 300, 2048, 8192, 20000)] == \
        [32, 32, 32, 27, 4, 1, 1]


def test_the_byte_rule_by_hand():
    a = _hub(U64)
    op = td.plan_dense_acc(a)
    bp = td.plan_csr_panels(op, a, 64)
    n, nnz = a.n_rows, int(a.nnz)
    for p in range(bp.panels):
        # A's offsets, columns and values; B's two offsets a row; B's
        # entries of the panel (column and value); the C panel written
        want = 4 * (n + 1) + 4 * nnz + 4 * nnz + 8 * n + 8 * bp.panel_nnz[p] \
            + 4 * n * bp.panel(p)[1]
        assert kspmm.csr_panel_bytes(op, bp, p) == want


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    a = _hub(U64)
    op = td.plan_dense_acc(a)
    bp = td.plan_csr_panels(op, a, 64)
    for p in (-1, 4):
        with pytest.raises(ValueError, match="outside"):
            kspmm.spmm_dense_acc_csr_panel(op, bp, p)
    for field, bad in (("vals", bp.vals.double()), ("col_idx", bp.col_idx.long()),
                       ("offsets", bp.offsets.long()),
                       ("offsets", bp.offsets[:100]), ("order", bp.order[1:])):
        with pytest.raises(ValueError):
            kspmm.spmm_dense_acc_csr_panel(op, dataclasses.replace(bp, **{field: bad}), 0)
    meta = dataclasses.replace(op, row_ptr=op.row_ptr.to("meta"), col_idx=op.col_idx.to("meta"),
                               vals=op.vals.to("meta"))
    meta_b = dataclasses.replace(bp, **{f: getattr(bp, f).to("meta")
                                        for f in ("col_idx", "vals", "offsets", "order")})
    with pytest.raises(ValueError, match="cpu or cuda"):
        kspmm.spmm_dense_acc_csr_panel(meta, meta_b, 0)


@pytest.fixture(scope="module")
def s17_toy_jax():
    """The ``graph500_s17`` deployment's graph at SCALE 9 (its generator,
    edge factor and draw seed; a run's permutation seed) on both packages,
    and the JAX package's tiled A^2."""
    from sparsetpu import U64 as JU64
    from sparsetpu.csr import SparseCSR as JCSR
    from sparsetpu.ops import denseacc as jd

    with open(CONFIG) as f:
        config = json.load(f)
    assert config["generator"] == "graph500_kronecker" and config["semiring"] == "u64"
    r, c, v, n = generate.graph500_kronecker(9, config["edgefactor"], config["draw_seed"],
                                             perm_seed=2**31 + 7)
    j = JCSR.from_coo_host(r, c, v, n, sr=JU64)
    return carry_csr(j, "cpu"), jd.spgemm_dense_acc_tiled(j, j, panel_cols=1024)


@pytest.mark.parametrize("panel_cols", [64, 8192])  # 8,192: spgemm_auto's width at n = 512
def test_the_tiled_route_on_the_deployments_toy_equals_the_jax_package(s17_toy_jax, panel_cols):
    a, want = s17_toy_jax
    assert td.csr_panel_form(a)
    got = td.spgemm_dense_acc_tiled(a, a, panel_cols=panel_cols)
    assert int(got.nnz) == int(want.nnz) > 0 and got.capacity == want.capacity
    np.testing.assert_array_equal(got.row_ptr.numpy(), np.asarray(want.row_ptr))
    np.testing.assert_array_equal(got.col_idx.numpy(), np.asarray(want.col_idx))
    for g, w in zip(got.values, want.values):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int64))


# ---- CUDA: the kernel against its plain version -----------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CSR-panel kernel has no interpret mode")
    return torch.device("cuda")


def _to(c: SparseCSR, device) -> SparseCSR:
    return dataclasses.replace(c, row_ptr=c.row_ptr.to(device), col_idx=c.col_idx.to(device),
                               values=tuple(l.to(device) for l in c.values),
                               nnz=c.nnz.to(device))


def _kron(scale, device):
    r, c, v, n = generate.graph500_kronecker(scale, 16, draw_seed=1, perm_seed=3)
    return SparseCSR.from_coo_host(r, c, v, n, sr=U64, device=device)


def _every_panel_equals_the_plain_version(a, b, w):
    op = td.plan_dense_acc(a)
    bp = td.plan_csr_panels(op, b, w)
    before = kspmm.CSR_PANEL_LAUNCHES
    for p in range(bp.panels):
        got = kspmm.spmm_dense_acc_csr_panel(op, bp, p)
        want = kspmm.spmm_dense_acc_csr_panel_reference(op, bp, p)
        torch.cuda.synchronize()
        assert torch.equal(got, want), p
    assert kspmm.CSR_PANEL_LAUNCHES - before == bp.panels
    return bp


@pytest.mark.cuda
@pytest.mark.parametrize("w", [256, 2048])
def test_cuda_the_kernel_equals_its_plain_version_on_the_kronecker_graph(w):
    dev = _card()
    a = _kron(10, dev)
    bp = _every_panel_equals_the_plain_version(a, a, w)
    assert bp.panels == -(-a.n_cols // w)


@pytest.mark.cuda
@pytest.mark.parametrize("w", [9000, 10001])  # two chunks of the first panel; floats, not float4
def test_cuda_panels_cut_into_chunks_equal_the_plain_version(w):
    dev = _card()
    a = _kron(10, dev)
    b = _to(_er(12, a.n_cols, 20_000, 40_000, U64), dev)
    _every_panel_equals_the_plain_version(a, b, w)


@pytest.mark.cuda
def test_cuda_a_block_whose_sum_reaches_2_24_sums_in_f32_and_poisons():
    """(A x B)[0, 5] = 2 x 4,096 x 4,096 = 2^25, beside small cells of its
    block: the block sums again in f32 (exact here: powers of two), its
    panel equals the plain version's and the tiled route poisons nnz."""
    dev = _card()
    a = _csr([0, 0, 0, 1], [1, 2, 3, 3], 40, 40, vals=[4096, 4096, 1, 2])
    b = _csr([1, 2, 2, 3, 3], [5, 5, 6, 6, 7], 40, 40, vals=[4096, 4096, 3, 7, 1])
    for p_cols in (8, 40):
        _every_panel_equals_the_plain_version(_to(a, dev), _to(b, dev), p_cols)
    assert int(td.spgemm_dense_acc_tiled(_to(a, dev), _to(b, dev), panel_cols=8).nnz) == -1
    assert int(td.spgemm_dense_acc_tiled(a, b, panel_cols=8).nnz) == -1
