"""What a ``torch.profiler`` session over part of the window shows.

Device operations (kernels, copies, fills) come from the profiler's CUDA
events, host operations from its CPU events, as the port's
``bench/real_graphs._profiled_call`` reads them.  The harness marks every
unit with the span ``spbench.unit`` and every product inside it with
``spbench.A^k``; those spans are the benchmark's own.  Times are in
microseconds of the profiler's clock.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Sequence, Tuple

UNIT_SPAN = "spbench.unit"
SPAN_PREFIX = "spbench."

Interval = Tuple[float, float]


def union(intervals: Sequence[Interval]) -> List[Interval]:
    """The intervals merged where they overlap, in order."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def overlap(merged: Sequence[Interval], windows: Sequence[Interval]) -> float:
    """Length of the merged intervals that lies inside the merged windows."""
    total, j = 0.0, 0
    windows = union(windows)
    for s, e in merged:
        while j < len(windows) and windows[j][1] <= s:
            j += 1
        k = j
        while k < len(windows) and windows[k][0] < e:
            total += max(0.0, min(e, windows[k][1]) - max(s, windows[k][0]))
            k += 1
    return total


@dataclasses.dataclass
class Trace:
    device_ops: List[Tuple[str, float, float]]
    host_ops: List[Tuple[str, float, float]]
    units: List[Interval]
    completed_units: int = 0  # units in the traced part that ended without failing
    unit_bytes: int = 0       # compulsory bytes of one unit (bounds.unit_bytes)

    def span(self) -> Interval:
        if not self.units:
            return (0.0, 0.0)
        return (min(s for s, _ in self.units), max(e for _, e in self.units))

    def span_us(self) -> float:
        s, e = self.span()
        return e - s

    def busy(self, match=None) -> List[Interval]:
        """The device operations' intervals, merged (only those whose name
        ``match`` accepts, when given)."""
        ops = [(s, e) for name, s, e in self.device_ops if match is None or match(name)]
        return union(ops)

    def busy_us(self, match=None) -> float:
        return overlap(self.busy(match), [self.span()])

    def busy_in_units_us(self, match=None) -> float:
        return overlap(self.busy(match), self.units)


def from_profiler(prof, completed_units: int, unit_bytes: int) -> Trace:
    import torch

    device_ops, host_ops, units = [], [], []
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not e.name.startswith(SPAN_PREFIX):  # the spans' shadows on the device
                device_ops.append((e.name, start, end))
        elif e.name == UNIT_SPAN:
            units.append((start, end))
        else:
            host_ops.append((e.name, start, end))
    return Trace(device_ops, host_ops, sorted(units), completed_units, unit_bytes)


def _innermost(host_sorted: List[Tuple[float, float, str]], starts: List[float],
               t: float, limit: int = 5000) -> str:
    """The host operation running at time t with the latest start (the
    innermost of nested ones)."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - limit, -1), -1):
        s, e, name = host_sorted[j]
        if e >= t:
            return name
    return "(no host op)"


def breakdown(t: Trace, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, and the device's idle
    time inside the traced span by the host operation running during each
    gap, in seconds."""
    by_name: Dict[str, float] = {}
    for name, s, e in t.device_ops:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    lo, hi = t.span()
    host_sorted = sorted((s, e, name) for name, s, e in t.host_ops)
    starts = [s for s, _, _ in host_sorted]
    gaps: Dict[str, float] = {}
    prev = lo
    for s, e in t.busy() + [(hi, hi)]:
        s, e = min(max(s, lo), hi), min(e, hi)
        if s > prev:
            label = _innermost(host_sorted, starts, (prev + s) / 2)
            gaps[label] = gaps.get(label, 0.0) + (s - prev)
        prev = max(prev, e)
    def ranked(d):
        return [[name[:200], us / 1e6] for name, us in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": ranked(by_name), "idle_gaps": ranked(gaps)}
