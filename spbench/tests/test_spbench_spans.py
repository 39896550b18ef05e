"""The readers of the program's own spans on a made-up trace, whose answers
are worked out by hand (times in microseconds), and on a toy run."""

import glob
import io
import os
import re
import time
import types

import pytest

from spbench import run, spans
from spbench import trace as tr
from spbench.tests import toy

P = spans.PROGRAM
DENSE_ACC = "void (anonymous namespace)::spmm_dense_acc_kernel<float4, 2, int>(int const*)"


def _read(name, t):
    return run.load_module(toy.REPO, "metrics", name).read(types.SimpleNamespace(trace=t))


def _trace(host=None, device=None):
    # two units, [0, 100] and [110, 210]; the device busy 20-50 and 120-150
    # (the dense-acc kernel) and 60-90 (another op), so idle 0-20, 50-60,
    # 90-120 and 150-210.  The host: a product 0-60 holding its expansion
    # 5-40, a launch 15-18 and a flop read 50-58; a check 95-100; a launch
    # 112-115; a check 215-216 after the traced units; PyTorch's own ops.
    device = device if device is not None else [
        (DENSE_ACC, 20, 50), ("elementwise_kernel", 60, 90), (DENSE_ACC, 120, 150)]
    host = host if host is not None else [
        (P + "product/esc", 0, 60), (P + "esc/expand", 5, 40),
        (P + "kernel/spmm_dense_acc bytes=3350000", 15, 18), (P + "sync/flops", 50, 58),
        ("aten::add", 52, 56), (P + "sync/check", 95, 100),
        (P + "kernel/spmm_dense_acc bytes=6700000", 112, 115), (P + "sync/check", 215, 216)]
    return tr.Trace(device, host, [(0, 100), (110, 210)], completed_units=2, unit_bytes=1)


def test_helpers():
    assert spans.intersect([(0, 10), (20, 30)], [(5, 25)]) == [(5, 10), (20, 25)]
    assert spans.intersect([(0, 10)], [(10, 20)]) == []
    assert spans.idle(_trace()) == [(0, 20), (50, 60), (90, 120), (150, 210)]
    assert spans.length([(0, 5), (3, 8), (10, 11)]) == 9
    assert spans.launch_bytes(P + "kernel/spmm_band bytes=12") == ("spmm_band", 12)
    assert spans.launch_bytes(P + "kernel/coalesce_blocks") == ("coalesce_blocks", -1)
    t = _trace()
    assert len(spans.program_spans(t)) == 7
    assert [s[0] for s in spans.in_units(t, spans.program_spans(t, spans.SYNC))] == [
        P + "sync/flops", P + "sync/check"]


def test_host_syncs_per_unit():
    # sync/flops and the first sync/check start in the units; the last check does not
    assert _read("host_syncs_per_unit", _trace()) == pytest.approx(2 / 2)
    no_syncs = [op for op in _trace().host_ops if not op[0].startswith(spans.SYNC)]
    assert _read("host_syncs_per_unit", _trace(host=no_syncs)) == 0.0


def test_enqueue_idle_pct():
    # idle inside the non-sync spans [0, 60] and [112, 115]: 0-20, 50-60,
    # 112-115 = 33; of it under a sync span: 50-58 = 8; 25 of the 210 span
    assert _read("enqueue_idle_pct", _trace()) == pytest.approx(100 * 25 / 210)
    # never above the device's idle share
    assert _read("enqueue_idle_pct", _trace()) <= _read("device_idle_pct", _trace())


def test_kernel_roofline_pct():
    # 10,050,000 B at 3.35e12 B/s = 3 us over the kernel's 60 us in the units
    assert _read("kernel_roofline_pct", _trace()) == pytest.approx(100 * 3 / 60)
    # a launch without bytes leaves its kernel out, and nothing is left
    host = _trace().host_ops + [(P + "kernel/spmm_dense_acc", 160, 161)]
    assert _read("kernel_roofline_pct", _trace(host=host)) is None


@pytest.mark.parametrize("name", ["host_syncs_per_unit", "enqueue_idle_pct",
                                  "kernel_roofline_pct"])
def test_a_program_without_spans_gives_nothing(name):
    """A program that records no span (an older one): each reader returns nothing."""
    assert _read(name, None) is None
    plain = [op for op in _trace().host_ops if not op[0].startswith(P)]
    assert _read(name, _trace(host=plain)) is None


def test_the_kernel_table_names_each_global_function_of_the_sources():
    reader = run.load_module(toy.REPO, "metrics", "kernel_roofline_pct")
    kernel = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(")
    found = set()
    for path in glob.glob(os.path.join(toy.REPO, "sparsetpu_torch", "csrc", "*.cu")):
        with open(path) as f:
            found |= set(kernel.findall(f.read()))
    assert set(reader.GLOBALS.values()) == found
    assert all(g == k + "_kernel" for k, g in reader.GLOBALS.items())


def test_a_traced_toy_run_counts_the_esc_units_syncs(tmp_path):
    """On the CPU the ESC unit's six products read the device twice each:
    the flop count and the caller's check."""
    root = toy.make_root(str(tmp_path))
    r = run.run_cell(root, "torus30.chain7_esc", 2**31 + 5, 0.1, True, "cpu",
                     time.perf_counter(), log=io.StringIO())
    assert r["correct"] and r["metrics"]["host_syncs_per_unit"]["value"] == 12.0
    # no device operation on the CPU: the device's shares read nothing
    assert "enqueue_idle_pct" not in r["metrics"]
