"""The tiled dense routes' count and pack kernels (``kernels/panelpack.py``
over ``csrc/panel_pack.cu``) and their dispatch in ``ops/denseacc``.

The CPU tests hold the dispatch (a CPU panel takes the tensor ops and no
launch is counted), the wrappers' checks (they take CUDA tensors alone),
the byte rules, the card's sweeps with the two launches emulated on CPU
tensors against the tensor ops, and both tiled routes on Graph 500's
Kronecker graph at SCALE 9 against the JAX package's, with a ragged last
panel.  The ``cuda`` tests hold the kernel path against the CPU plain
version field for field (row offsets, columns, every limb with its padding,
nnz): u64, u32 and f32 panels (negative values, -0.0) of widths 1, 3, 5, 128
and 2,048, empty rows, an all-zero panel, an empty operand, a value at 2^24
that poisons nnz on both routes, two launches a panel, no host read in the
pack sweep, and the launches' spans with their bytes.  They hold both tiled
routes on the card at SCALE 9 against the JAX package's product too,
through its SHA-256 digest (``KRON9_A2_SHA256``): a CPU test pins the
digest to the JAX package's product, since the JAX package runs in CPU
tests alone.  Tolerance: exact everywhere (the panels are the same f32
cells on both sides).
"""

import dataclasses
import hashlib
import inspect
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sparsetpu_torch import obs
from sparsetpu_torch.csr import SparseCSR
from sparsetpu_torch.graphs import generate
from sparsetpu_torch.interop import carry_csr
from sparsetpu_torch.kernels import panelpack as kpanel
from sparsetpu_torch.ops import denseacc as td
from sparsetpu_torch.semiring import U32, U64, by_name

P = obs.PREFIX
# A^2 of Graph 500's Kronecker graph at SCALE 9 (draw seed 1, permutation
# seed 3) by the JAX package, both tiled routes: ``_digest`` of its fields
KRON9_A2_SHA256 = "54b97e8cfd136e74aee122210868270fc533901148ab44cb0e63ff72e964570c"
KRON9_A2_NNZ = 135_588


def _kron(scale: int, sr=U64, device="cpu"):
    r, c, v, n = generate.graph500_kronecker(scale, 16, draw_seed=1, perm_seed=3)
    return SparseCSR.from_coo_host(r, c, v, n, sr=sr, device=device)


def _to(c: SparseCSR, device) -> SparseCSR:
    return dataclasses.replace(c, row_ptr=c.row_ptr.to(device), col_idx=c.col_idx.to(device),
                               values=tuple(l.to(device) for l in c.values),
                               nnz=c.nnz.to(device))


def _fields(c: SparseCSR):
    return (("row_ptr", c.row_ptr), ("col_idx", c.col_idx),
            *((f"limb {k}", l) for k, l in enumerate(c.values)), ("nnz", c.nnz))


def _digest(c) -> str:
    """SHA-256 of a product's fields as int64, in order: the row offsets,
    the columns and every limb (the padding included), then nnz.  Takes
    either package's CSR."""
    h = hashlib.sha256()
    for t in (c.row_ptr, c.col_idx, *c.values, c.nnz):
        t = t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
        h.update(np.ascontiguousarray(t.astype(np.int64).reshape(-1)).tobytes())
    return h.hexdigest()


def _assert_same(got: SparseCSR, want: SparseCSR) -> None:
    """Every field equal, dtype, shape and bits (the padding included)."""
    assert got.shape == want.shape and got.sr_name == want.sr_name
    assert {t.device for _, t in _fields(got)} == {got.row_ptr.device}
    for (name, g), (_, w) in zip(_fields(got), _fields(want)):
        g = g.cpu()
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if g.dtype == torch.float32:  # -0.0 and 0.0 apart
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w), name


def _panels(sr_name: str, n: int, m: int, w: int, seed: int, poison: bool = False):
    """Dense f32 C panels of an (n, m) product in widths w (the last one
    ragged where w does not divide m): about a tenth of the cells nonzero,
    every fifth row empty, the second panel all zero.  Integer semirings:
    integer values below 2^24 (one at 2^24 where ``poison``); f32: values
    of both signs with -0.0 cells."""
    rng = np.random.default_rng(seed)
    out = []
    for p, lo in enumerate(range(0, m, w)):
        width = min(w, m - lo)
        keep = rng.random((n, width)) < 0.1
        keep[::5] = False
        if p == 1:
            keep[:] = False
        if sr_name == "f32":
            vals = rng.standard_normal((n, width)).astype(np.float32)
            vals[rng.random((n, width)) < 0.05] = -0.0
        else:
            vals = rng.integers(1, 1 << 20, (n, width)).astype(np.float32)
        dense = np.where(keep, vals, np.float32(0.0))
        if poison and p == 0:
            dense[n // 2, width - 1] = float(1 << 24)
        out.append(torch.from_numpy(np.ascontiguousarray(dense)))
    return out


def _sweep(panels, sr_name: str, n: int, m: int, w: int, device) -> SparseCSR:
    """``_two_sweeps`` over the given panels on ``device``."""
    on = [p.to(device) for p in panels]
    return td._two_sweeps(n, m, sr_name, w, lambda lo, width: (on[lo // w], None),
                          None, torch.device(device))


# ---- CPU: dispatch, checks, byte rules, the card's sweeps emulated ---------

def test_a_cpu_panel_takes_the_tensor_ops_and_counts_no_launch(monkeypatch):
    taken = []
    plain = td._sweeps_in_tensor_ops

    def spy(*args):
        taken.append(args[2])
        return plain(*args)

    monkeypatch.setattr(td, "_sweeps_in_tensor_ops", spy)
    monkeypatch.setattr(td, "_sweeps_on_kernels", None)  # never reached from the CPU
    before = kpanel.LAUNCHES
    a = _kron(8)
    td.spgemm_dense_acc_tiled(a, a, panel_cols=100).check()
    td.spgemm_dense_dense_tiled(a, a, panel_cols=100).check()
    assert taken == ["u64", "u64"]
    assert kpanel.LAUNCHES == before


def _count_args(n=6, w=5, panels=3):
    return (torch.zeros(n, w), torch.zeros(panels, n, dtype=torch.int32), 1,
            torch.zeros((), dtype=torch.int32), True)


def _pack_args(n=6, w=5, panels=3, cap=16, sr_name="u64"):
    limbs = tuple(torch.zeros(cap, dtype=d) for d in kpanel.LIMB_DTYPES[sr_name])
    return (torch.zeros(n, w), 10, torch.zeros(n + 1, dtype=torch.int32),
            torch.zeros(panels, n, dtype=torch.int32), 1,
            torch.zeros(cap, dtype=torch.int32), limbs, sr_name, 0)


def test_the_wrappers_raise_on_a_wrong_dtype_contiguity_device_or_table_shape():
    before = kpanel.LAUNCHES

    def raises(match, fn, args, **changed):
        kw = dict(inspect.signature(fn).bind(*args).arguments, **changed)
        with pytest.raises(ValueError, match=match):
            fn(**kw)

    count, pack = kpanel.panel_count, kpanel.panel_pack
    c, k = _count_args(), _pack_args()
    strided = torch.zeros(5, 6).t()
    assert not strided.is_contiguous()
    for fn, args in ((count, c), (pack, k)):
        raises("float32", fn, args, dense=torch.zeros(6, 5, dtype=torch.float64))
        raises("contiguous", fn, args, dense=strided)
        raises("2-D", fn, args, dense=torch.zeros(30))
        raises("CUDA card, not cpu", fn, args)  # right in all but the device
    raises(r"\(panels, 6\) table", count, c, table=torch.zeros(3, 7, dtype=torch.int32))
    raises(r"\(panels, 6\) table", count, c, table=torch.zeros(18, dtype=torch.int32))
    raises("int32", count, c, table=torch.zeros(3, 6, dtype=torch.int64))
    raises("contiguous", count, c, table=torch.zeros(6, 3, dtype=torch.int32).t())
    raises("on cpu", count, c, table=torch.zeros(3, 6, dtype=torch.int32, device="meta"))
    raises("panel 3 outside", count, c, p=3)
    raises("fault", count, c, fault=torch.zeros(1, dtype=torch.int32))
    raises("row_ptr", pack, k, row_ptr=torch.zeros(6, dtype=torch.int32))
    raises("row_ptr", pack, k, row_ptr=torch.zeros(7, dtype=torch.int64))
    raises(r"\(panels, 6\) table", pack, k, prior=torch.zeros(3, 5, dtype=torch.int32))
    raises("panel -1 outside", pack, k, p=-1)
    raises("col_idx", pack, k, col_idx=torch.zeros(16, dtype=torch.int64))
    raises("1-D", pack, k, col_idx=torch.zeros(4, 4, dtype=torch.int32))
    raises("takes 2 limbs", pack, k, limbs=k[6][:1])
    raises("limb 1", pack, k, limbs=(k[6][0], torch.zeros(15, dtype=torch.int64)))
    raises("limb 0", pack, k, limbs=(torch.zeros(16, dtype=torch.int32), k[6][1]))
    raises("limb 0", pack, _pack_args(sr_name="f32"),
           limbs=(torch.zeros(16, dtype=torch.int64),))
    raises("takes 0 limbs", pack, k, sr_name="u16")
    raises("do not fit int32", pack, k, lo=2**31 - 4)
    raises("do not fit int32", pack, k, lo=-1)
    assert kpanel.LAUNCHES == before


def test_the_byte_rules_by_hand():
    # a 6 x 5 panel: 30 cells read (4 B), six counts written (4 B)
    assert kpanel.count_bytes(6, 5) == 120 + 24
    # the same panel packed with 7 entries: the cells, two int32 offsets a
    # row, then a column (4 B) and the value an entry: u64 16 B, u32 8, f32 4
    assert kpanel.pack_bytes(6, 5, 7, kpanel.VALUE_BYTES["u64"]) == 120 + 48 + 7 * 20
    assert kpanel.pack_bytes(6, 5, 7, kpanel.VALUE_BYTES["u32"]) == 120 + 48 + 7 * 12
    assert kpanel.pack_bytes(6, 5, 7, kpanel.VALUE_BYTES["f32"]) == 120 + 48 + 7 * 8
    assert kpanel.pack_bytes(6, 5, 0, 16) == 168  # an all-zero panel writes nothing
    # the cell's panel: 131,072 x 2,048 f32, 1 GiB read
    assert kpanel.count_bytes(131_072, 2_048) == 2**30 + 2**19
    # and the limbs' sizes are the product's dtypes'
    for sr_name, dtypes in kpanel.LIMB_DTYPES.items():
        assert kpanel.VALUE_BYTES[sr_name] == sum(
            torch.empty(0, dtype=d).element_size() for d in dtypes)
        assert dtypes == tuple(l.dtype for l in by_name(sr_name).zeros((1,)))


def _emulated_count(dense, table, p, fault, check):
    table[p] = (dense != 0).sum(dim=1).int()
    if check and not bool((dense < float(1 << 24)).all()):
        fault.fill_(1)


def _emulated_pack(dense, lo, row_ptr, prior, p, col_idx, limbs, sr_name, nnz):
    r, j = torch.nonzero(dense != 0, as_tuple=True)  # row-major
    assert len(r) == nnz
    first = torch.cumsum((dense != 0).sum(dim=1), 0) - (dense != 0).sum(dim=1)
    dst = row_ptr[r].long() + prior[p][r].long() + torch.arange(len(r)) - first[r]
    col_idx[dst] = (j + lo).int()
    v = dense[r, j]
    if sr_name == "f32":
        limbs[0][dst] = v
    else:
        limbs[0][dst] = v.long()
        if len(limbs) == 2:
            limbs[1][dst] = 0


@pytest.mark.parametrize("sr_name,poison", [("u64", False), ("u32", False), ("f32", False),
                                            ("u64", True), ("u32", True)])
def test_the_cards_sweeps_with_emulated_launches_equal_the_tensor_ops(monkeypatch, sr_name,
                                                                       poison):
    """The offsets, the product's allocation and padding and the poisoning
    of ``_sweeps_on_kernels``, with each launch done by tensor ops here (the
    f32 semiring has no exactness bound to poison)."""
    monkeypatch.setattr(kpanel, "panel_count", _emulated_count)
    monkeypatch.setattr(kpanel, "panel_pack", _emulated_pack)
    n, m, w = 40, 23, 5
    panels = _panels(sr_name, n, m, w, seed=1, poison=poison)
    fn = lambda lo, width: (panels[lo // w], None)
    got = td._sweeps_on_kernels(n, m, sr_name, [(lo, min(w, m - lo)) for lo in range(0, m, w)],
                                fn, None, torch.device("cpu"))
    want = _sweep(panels, sr_name, n, m, w, "cpu")
    _assert_same(got, want)
    assert int(got.nnz) == (-1 if poison else sum(int((p != 0).sum()) for p in panels))


@pytest.fixture(scope="module")
def kron9_jax():
    """Graph 500's Kronecker graph at SCALE 9 (n = 512) on both packages,
    and the JAX package's A^2 on both tiled routes (one panel of 1,024)."""
    from sparsetpu import U64 as JU64
    from sparsetpu.csr import SparseCSR as JCSR
    from sparsetpu.ops import denseacc as jd

    r, c, v, n = generate.graph500_kronecker(9, 16, draw_seed=1, perm_seed=3)
    j = JCSR.from_coo_host(r, c, v, n, sr=JU64)
    return (carry_csr(j, "cpu"), {"acc": jd.spgemm_dense_acc_tiled(j, j, panel_cols=1024),
                                  "dense": jd.spgemm_dense_dense_tiled(j, j, panel_cols=1024)})


@pytest.mark.parametrize("route", ["acc", "dense"])
@pytest.mark.parametrize("panel_cols", [96, 512])  # 512 % 96 = 32: a ragged last panel
def test_the_tiled_routes_on_the_kronecker_toy_equal_the_jax_package(kron9_jax, route,
                                                                     panel_cols):
    a, want = kron9_jax
    fn = td.spgemm_dense_acc_tiled if route == "acc" else td.spgemm_dense_dense_tiled
    got = fn(a, a, panel_cols=panel_cols)
    want = want[route]
    assert int(got.nnz) == int(want.nnz) == KRON9_A2_NNZ
    assert got.capacity == want.capacity
    np.testing.assert_array_equal(got.row_ptr.numpy(), np.asarray(want.row_ptr))
    np.testing.assert_array_equal(got.col_idx.numpy(), np.asarray(want.col_idx))
    for g, w in zip(got.values, want.values):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int64))


def test_the_jax_packages_kronecker_toy_product_has_the_frozen_digest(kron9_jax):
    """The digest the card's test holds its products against is the JAX
    package's A^2, on both tiled routes, of the operand that ``_kron(9)``
    builds without the JAX package."""
    a, want = kron9_jax
    _assert_same(_kron(9), a)
    assert _digest(want["acc"]) == _digest(want["dense"]) == KRON9_A2_SHA256


# ---- CUDA: the kernels against the tensor ops ------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the panel kernels have no CPU form")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("sr_name", ["u64", "u32", "f32"])
@pytest.mark.parametrize("w", [1, 3, 5, 128, 2048])
def test_cuda_sweeps_equal_the_tensor_ops_field_for_field(sr_name, w):
    dev = _card()
    n = 300 if w <= 128 else 64
    m = 2 * w + 1  # three panels, the last one a column wide
    panels = _panels(sr_name, n, m, w, seed=w)
    before = kpanel.LAUNCHES
    got = _sweep(panels, sr_name, n, m, w, dev)
    assert kpanel.LAUNCHES - before == 2 * len(panels)
    want = _sweep(panels, sr_name, n, m, w, "cpu")
    _assert_same(got, want)
    assert int(got.nnz) == sum(int((p != 0).sum()) for p in panels) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["acc", "dense"])
@pytest.mark.parametrize("sr", [U64, U32])
def test_cuda_tiled_routes_equal_the_tensor_ops_on_the_kronecker_graph(route, sr):
    dev = _card()
    fn = td.spgemm_dense_acc_tiled if route == "acc" else td.spgemm_dense_dense_tiled
    a = _kron(10, sr)
    before = kpanel.LAUNCHES
    got = fn(_to(a, dev), _to(a, dev), panel_cols=300)  # four panels, the last 124 wide
    assert kpanel.LAUNCHES - before == 2 * 4
    want = fn(a, a, panel_cols=300)
    _assert_same(got, want)
    assert int(got.check().nnz) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["acc", "dense"])
@pytest.mark.parametrize("panel_cols", [96, 512])  # six panels, the last 32 wide; one
def test_cuda_tiled_routes_on_the_kronecker_toy_equal_the_jax_package(route, panel_cols):
    dev = _card()
    fn = td.spgemm_dense_acc_tiled if route == "acc" else td.spgemm_dense_dense_tiled
    a = _to(_kron(9), dev)
    before = kpanel.LAUNCHES
    got = fn(a, a, panel_cols=panel_cols)
    assert kpanel.LAUNCHES - before == 2 * -(-a.n_cols // panel_cols)
    assert int(got.nnz) == KRON9_A2_NNZ
    assert _digest(got) == KRON9_A2_SHA256


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["acc", "dense"])
def test_cuda_empty_rows_an_all_zero_panel_and_an_empty_operand(route):
    dev = _card()
    fn = td.spgemm_dense_acc_tiled if route == "acc" else td.spgemm_dense_dense_tiled
    # rows 0-19 of A empty; B without an entry in columns [64, 128): panel 2 all zero
    rng = np.random.default_rng(7)
    n = 200
    r, c = rng.integers(20, n, 900), rng.integers(0, n, 900)
    c = np.where((c >= 64) & (c < 128), c - 64, c)
    a = SparseCSR.from_coo_host(r, c, np.ones(900, np.uint64), n, sr=U64, device="cpu")
    got = fn(_to(a, dev), _to(a, dev), panel_cols=64)
    want = fn(a, a, panel_cols=64)
    _assert_same(got, want)
    assert int(got.nnz) > 0 and got.row_ptr[20].item() == 0
    empty = SparseCSR.empty(n, n, 8, U64, "cpu")
    for x, y in ((empty, a), (a, empty)):
        got = fn(_to(x, dev), _to(y, dev), panel_cols=64)
        _assert_same(got, fn(x, y, panel_cols=64))
        assert int(got.nnz) == 0 and got.capacity == 1


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["acc", "dense"])
def test_cuda_a_value_at_2_24_in_one_panel_poisons_nnz(route):
    dev = _card()
    fn = td.spgemm_dense_acc_tiled if route == "acc" else td.spgemm_dense_dense_tiled
    # (A x B)[3, 70] = 4,096 * 4,096 = 2^24, in the second of three panels
    n = 100
    a = SparseCSR.from_coo_host(np.array([3, 5, 9, 40]), np.array([3, 70, 41, 9]),
                                np.array([4096, 1, 2, 7], np.uint64), n, sr=U64, device="cpu")

    def b_with(top):
        return SparseCSR.from_coo_host(np.array([3, 41, 9]), np.array([70, 5, 90]),
                                       np.array([top, 3, 1], np.uint64), n, sr=U64,
                                       device="cpu")

    b = b_with(4096)
    got = fn(_to(a, dev), _to(b, dev), panel_cols=40)
    want = fn(a, b, panel_cols=40)
    assert int(want.nnz) == -1
    _assert_same(got, want)
    # the same product one below the bound is kept on both
    b1 = b_with(4095)
    got = fn(_to(a, dev), _to(b1, dev), panel_cols=40)
    _assert_same(got, fn(a, b1, panel_cols=40))
    assert int(got.nnz) > 0


@pytest.mark.cuda
def test_cuda_the_pack_sweep_reads_nothing_back(monkeypatch):
    dev = _card()
    a = _to(_kron(10), dev)
    td.spgemm_dense_acc_tiled(a, a, panel_cols=256)  # warm: the allocator's sizes
    torch.cuda.synchronize()
    plain = td._pack_sweep
    swept = []

    def strict(*args):
        torch.cuda.set_sync_debug_mode("error")
        try:
            swept.append(plain(*args))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        return swept[-1]

    monkeypatch.setattr(td, "_pack_sweep", strict)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the debug mode's notice that it is a prototype
        c = td.spgemm_dense_acc_tiled(a, a, panel_cols=256)
    assert len(swept) == 1 and int(c.check().nnz) > 0


@pytest.mark.cuda
def test_cuda_each_launch_is_a_span_with_its_bytes():
    dev = _card()
    a = _to(_kron(10), dev)
    n, w = a.n_rows, 256
    want = td.spgemm_dense_acc_tiled(a, a, panel_cols=w)
    per_panel = [int(((want.col_idx[:int(want.nnz)] >= lo)
                      & (want.col_idx[:int(want.nnz)] < lo + w)).sum())
                 for lo in range(0, n, w)]
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    try:
        td.spgemm_dense_acc_tiled(a, a, panel_cols=w)
        torch.cuda.synchronize()
    finally:
        prof.stop()
    events = list(prof.events())
    host = [e.name for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    device = [e.name for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    assert host.count(f"{P}kernel/panel_count bytes={kpanel.count_bytes(n, w)}") == 4
    for nnz in set(per_panel):
        assert host.count(f"{P}kernel/panel_pack bytes="
                          f"{kpanel.pack_bytes(n, w, nnz, 16)}") == per_panel.count(nnz)
    assert sum("panel_count_kernel" in d for d in device) == 4
    assert sum("panel_pack_kernel" in d for d in device) == 4
    # the benchmark finds the dense-acc kernel's time by its name alone
    assert sum("spmm_dense_acc_kernel" in d for d in device) == 8
    assert not [d for d in device if "panel_" in d and "spmm_dense_acc" in d]
    for span in ("tiled/count", "tiled/pack", "sync/panel_counts"):
        assert host.count(P + span) == 1, span
