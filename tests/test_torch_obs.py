"""The port's own spans (``sparsetpu_torch.obs``): what a profiler sees of an
ESC product and of ``spgemm_auto``'s routes, nothing while no profiler
runs, and the bytes each hand-written launch's span carries.

The CPU tests start and stop the profiler with ``prof.start()`` and
``prof.stop()``, as the benchmark's traced runs do.  The ``cuda`` test runs
one ESC unit and one dense-acc unit of the 30^3 torus on the card: no span
has a shadow on the device's timeline, and the synchronising calls that
``torch.cuda.set_sync_debug_mode`` reports are the ``sync/`` spans.
"""

import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sparsetpu_torch import obs
from sparsetpu_torch.bench.chain import build_torus_host
from sparsetpu_torch.csr import HostCSR, SparseCSR
from sparsetpu_torch.kernels import bandplanes, groupdot, sortmerge
from sparsetpu_torch.kernels import spmm as kspmm
from sparsetpu_torch.ops import spgemm as ops_spgemm
from sparsetpu_torch.semiring import U64

P = obs.PREFIX


def _device_csr(h: HostCSR, device="cpu") -> SparseCSR:
    return SparseCSR.from_coo_host(h.rows(), h.col_idx, h.vals, h.n_rows, sr=U64,
                                   device=device)


def _esc_product(a, b):
    """One product as the ESC unit makes it: the flop count, the product at
    its power-of-two capacity, the caller's check."""
    cap = ops_spgemm.pow2(ops_spgemm.symbolic_flops_exact(a, b))
    return ops_spgemm.spgemm(a, b, cap).check()


def _spans(fn, activities=(ProfilerActivity.CPU,)):
    """fn() under a profiler started and stopped as the benchmark does;
    (its result, the program's spans as (name, start, end), in order)."""
    prof = profile(activities=list(activities))
    prof.start()
    try:
        out = fn()
    finally:
        prof.stop()
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
             if e.name.startswith(P)]
    return out, sorted(spans, key=lambda s: s[1])


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _named(spans, name):
    return [s for s in spans if s[0] == P + name]


def test_an_esc_product_shows_its_stages_and_syncs_nested_as_named():
    a = _device_csr(build_torus_host((4, 4, 4)))
    c, spans = _spans(lambda: _esc_product(a, a))
    assert int(c.nnz) > 0
    (product,) = _named(spans, "product/esc")
    for stage in ("esc/expand", "esc/sort", "esc/merge"):
        (s,) = _named(spans, stage)
        assert _inside(s, product), stage
    (symbolic,) = _named(spans, "esc/symbolic")
    (flops,) = _named(spans, "sync/flops")
    assert _inside(flops, symbolic) and not _inside(symbolic, product)
    (check,) = _named(spans, "sync/check")
    assert not _inside(check, product) and check[1] >= product[2]
    # the stages run in order, and nothing else of the program is recorded
    order = [s[0][len(P):] for s in spans]
    assert order == ["esc/symbolic", "sync/flops", "product/esc", "esc/expand", "esc/sort",
                     "esc/merge", "sync/check"]


def test_without_a_profiler_a_span_is_the_shared_no_op_and_names_are_not_built():
    def never(*args):
        raise AssertionError("a span's bytes were counted with no profiler running")

    assert obs.span("product/esc") is obs.OFF
    assert obs.kernel("spmm_dense_acc", never, 1, 2) is obs.OFF
    with obs.span("esc/expand") as inside:
        assert inside is None
    assert obs.item(torch.tensor(7), "check") == 7
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        assert obs.span("product/esc") is not obs.OFF
    finally:
        prof.stop()
    assert obs.span("product/esc") is obs.OFF


def test_a_traced_function_keeps_its_name_and_records_one_span_a_call():
    assert ops_spgemm.spgemm.__name__ == "spgemm"
    assert "expand_cap" in ops_spgemm.spgemm.__doc__
    a = _device_csr(build_torus_host((3, 3, 3)))
    _, spans = _spans(lambda: [ops_spgemm.spgemm(a, a, 1024) for _ in range(3)])
    assert len(_named(spans, "product/esc")) == 3


@pytest.mark.parametrize("kernel, route", [("auto", "densedense"), ("esc", "esc"),
                                           ("rowcat", "rowcat"), ("escb", "escb"),
                                           ("slab", "slab")])
def test_spgemm_auto_names_its_route_around_the_routes_own_span(kernel, route):
    """At this size the router tries the dense-dense tiers first."""
    a = _device_csr(build_torus_host((4, 4, 4)))
    want = _esc_product(a, a)
    c, spans = _spans(lambda: ops_spgemm.spgemm_auto(a, a, kernel=kernel))
    assert torch.equal(c.to_dense()[0], want.to_dense()[0])
    (outer,) = _named(spans, f"product/auto/{route}")
    (product,) = _named(spans, f"product/{route}")
    assert _inside(product, outer)
    # every read of the device is a span of its own, each outside the product
    # span or inside it, but never around another span
    syncs = [s for s in spans if s[0].startswith(P + "sync/")]
    assert syncs and all(not _inside(t, s) for s in syncs for t in spans if t is not s)


def test_dense_acc_bytes_by_hand():
    # rows 0: cols 1, 3; row 1: col 1; row 2: nothing -> 2 distinct columns
    h = HostCSR.from_coo([0, 0, 1], [1, 3, 1], [1, 2, 3], 3, 4, "u64")
    op = kspmm.prepare_sparse_operand(h, "cpu")
    assert op.distinct_cols == 2
    m = 5
    # row offsets 4 x 4 B, columns 3 x 4 B, f32 values 3 x 4 B, two P rows of
    # 5 f32, C's 3 rows of 5 f32
    want = 16 + 12 + 12 + 2 * 5 * 4 + 3 * 5 * 4
    assert kspmm.launch_bytes(op, m) == want == 140
    assert kspmm.csr_spmm_bytes(3, 3, 2, m, m, 12) == want
    # a slice or an operand built by hand has no count: its span has no bytes
    assert kspmm.row_slice(op, 0, 2).distinct_cols is None
    assert kspmm.launch_bytes(kspmm.row_slice(op, 0, 2), m) is None


def test_distinct_columns_of_the_torus_match_a_device_count():
    h = build_torus_host((6, 6, 6))
    op = kspmm.prepare_sparse_operand(h, "cpu")
    assert op.distinct_cols == torch.unique(op.col_idx).numel() == len(np.unique(h.col_idx))
    gop = groupdot.prepare_group_operand(h, "cpu")
    assert gop.distinct_cols == op.distinct_cols


def test_band_group_dot_and_sort_merge_bytes_by_hand():
    h = build_torus_host((6, 6, 6))
    op = kspmm.prepare_sparse_operand(h, "cpu")
    n, nnz, d = op.n_rows, op.col_idx.numel(), op.distinct_cols
    base = np.zeros(n, np.int64)
    bop = bandplanes.prepare_band_operand(op, base, n, base, n, n)
    # A's arrays and both window starts, each distinct source window, C's windows
    assert bandplanes.launch_bytes(bop) == (4 * (n + 1) + 8 * nnz + 8 * n + 4 * d * n
                                            + 4 * n * n)
    gop = groupdot.prepare_group_operand(h, "cpu")
    m = 7
    assert groupdot.launch_bytes(gop, m) == (
        4 * (gop.n_tiles + 1) + 4 * gop.n_tiles + 4 * gop.cols.numel() + gop.m8.numel()
        + 4 * d * m + 4 * n * m)
    cols = torch.zeros(3, 16, dtype=torch.int32)
    limbs = (torch.zeros(3, 16, dtype=torch.int64), torch.zeros(3, 16, dtype=torch.int64))
    assert sortmerge.launch_bytes(cols, limbs) == 2 * 3 * 16 * (4 + 8 + 8)
    assert sortmerge.launch_bytes(cols, limbs[:1]) == 2 * 3 * 16 * (4 + 8)


def test_a_kernel_span_carries_its_bytes_in_its_name():
    h = HostCSR.from_coo([0, 0, 1], [1, 3, 1], [1, 2, 3], 3, 4, "u64")
    op = kspmm.prepare_sparse_operand(h, "cpu")

    def launches():
        with obs.kernel("spmm_dense_acc", kspmm.launch_bytes, op, 5):
            pass
        with obs.kernel("spmm_dense_acc", kspmm.launch_bytes, kspmm.row_slice(op, 0, 1), 5):
            pass
        with obs.kernel("coalesce_blocks"):
            pass

    _, spans = _spans(launches)
    assert [s[0] for s in spans] == [P + "kernel/spmm_dense_acc bytes=140",
                                     P + "kernel/spmm_dense_acc", P + "kernel/coalesce_blocks"]


def test_the_cpu_path_of_a_kernel_wrapper_records_no_launch_span():
    h = build_torus_host((4, 4, 4))
    op = kspmm.prepare_sparse_operand(h, "cpu")
    p = kspmm.densify(op)
    _, spans = _spans(lambda: kspmm.spmm_dense_acc(op, p))
    assert spans == []


@pytest.mark.cuda
def test_cuda_spans_have_no_device_shadow_and_every_sync_is_a_span():
    """One ESC unit (A^2..A^7 through ``spgemm``, each checked) and one
    dense-acc unit (six launches, nothing read back) of the 30^3 torus."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the spans' device timeline and the sync debug mode")
    dev = torch.device("cuda")
    h = build_torus_host((30, 30, 30))
    a = _device_csr(h, dev)
    op = kspmm.prepare_sparse_operand(h, dev)
    p0 = kspmm.densify(op)
    bufs = (torch.empty_like(p0), torch.empty_like(p0))

    def esc_unit():
        c = a
        for _ in range(6):
            c = _esc_product(c, a)
        return c

    def dense_unit():
        p = p0
        for i in range(6):
            p = kspmm.spmm_dense_acc(op, p, out=bufs[i % 2])
        return p

    for unit in (esc_unit, dense_unit):  # the kernel build and the allocator's first use
        unit()
    torch.cuda.synchronize()

    def both():
        esc_unit()
        dense_unit()
        torch.cuda.synchronize()

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    try:
        both()
    finally:
        prof.stop()
    events = list(prof.events())
    device_names = [e.name for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    assert device_names and not [n for n in device_names if n.startswith(P)]
    host = [e.name for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    assert sum(n.startswith(P + "sync/") for n in host) == 12
    assert host.count(P + f"kernel/spmm_dense_acc bytes={kspmm.launch_bytes(op, h.n_cols)}") == 6
    assert any("spmm_dense_acc_kernel" in n for n in device_names)

    def syncs(unit):
        """The synchronising calls the sync debug mode reports in unit()."""
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                unit()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        return [str(w.message) for w in seen
                if "called a synchronizing CUDA operation" in str(w.message)]

    assert len(syncs(esc_unit)) == 12
    assert syncs(dense_unit) == []
