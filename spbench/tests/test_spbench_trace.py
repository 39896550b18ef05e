"""The per-layer readers and the breakdown on a made-up trace, whose
answers are worked out by hand (times in microseconds)."""

import types

import pytest

from spbench import bounds, run
from spbench import trace as tr

ROOT = run.ROOT


def _read(name, t):
    return run.load_module(ROOT, "metrics", name).read(types.SimpleNamespace(trace=t))


def _trace(**kw):
    # two units, [0, 100] and [110, 210]; the device busy 20-50 (a sort),
    # 40-90, 120-130 and 150-200 (a sort); the host runs op "a" over 0-60
    # with "b" inside it over 50-60, and "c" over 90-210
    device = [("DeviceRadixSortOnesweepKernel<...>", 20, 50), ("spmm_dense_acc_kernel", 40, 90),
              ("Memcpy DtoH", 120, 130), ("cub::DeviceRadixSortHistogramKernel", 150, 200),
              ("spbench.A^2", 0, 210)]
    host = [("a", 0, 60), ("b", 50, 60), ("c", 90, 210)]
    t = tr.Trace([d for d in device if not d[0].startswith(tr.SPAN_PREFIX)], host,
                 [(0, 100), (110, 210)], completed_units=2, unit_bytes=int(3.35e6))
    for k, v in kw.items():
        setattr(t, k, v)
    return t


def test_union_and_overlap():
    assert tr.union([(5, 7), (0, 2), (1, 3), (7, 8)]) == [(0, 3), (5, 8)]
    assert tr.overlap([(0, 3), (5, 8)], [(2, 6)]) == 2


def test_device_idle_pct():
    # busy 20-90, 120-130, 150-200 = 130 of the 210 span
    assert _read("device_idle_pct", _trace()) == pytest.approx(100 * (1 - 130 / 210))


def test_spgemm_roofline_pct():
    # each unit's bound is 3.35e6 B at 3.35e12 B/s = 1 us; busy inside units 130 us
    assert bounds.seconds_at_peak(int(3.35e6)) * 1e6 == pytest.approx(1.0)
    assert _read("spgemm_roofline_pct", _trace()) == pytest.approx(100 * 2 / 130)


def test_sort_share_pct():
    # sorts 20-50 and 150-200 = 80 of 130 busy
    assert _read("sort_share_pct", _trace()) == pytest.approx(100 * 80 / 130)


@pytest.mark.parametrize("name", ["device_idle_pct", "spgemm_roofline_pct", "sort_share_pct"])
def test_a_reader_that_finds_nothing_returns_nothing(name):
    assert _read(name, None) is None
    assert _read(name, _trace(device_ops=[])) is None


def test_breakdown():
    b = tr.breakdown(_trace())
    names = [n for n, _ in b["device_ops"]]
    assert names[0] == "spmm_dense_acc_kernel" and b["device_ops"][0][1] == pytest.approx(50e-6)
    assert "spbench.A^2" not in names
    # gaps: 0-20 (mid 10: "a"), 90-120 (mid 105: "c"), 130-150 (mid 140: "c"), 200-210 ("c")
    assert dict(b["idle_gaps"]) == pytest.approx({"a": 20e-6, "c": 60e-6})
