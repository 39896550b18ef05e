"""The program's own spans in a traced run.

The port records spans named ``sparsetpu_torch.<kind>/...`` as host
operations on the profiler's clock (its ``obs`` module), so they land in
``Trace.host_ops`` beside PyTorch's operators:

- ``sync/<site>``: one read of a device value by the host, around the read;
- ``kernel/<kernel> bytes=<int>``: one launch of a hand-written kernel and
  the least bytes it must move;
- ``product/<route>`` and ``esc/<stage>``: where the program was.

They are read by their names alone: nothing here imports the program.  A
program that records none (an older one) leaves every reader here without
anything to read.  Times are in microseconds of the profiler's clock.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from spbench.trace import Interval, Trace, union

PROGRAM = "sparsetpu_torch."
SYNC = PROGRAM + "sync/"
KERNEL = PROGRAM + "kernel/"
BYTES = " bytes="

Span = Tuple[str, float, float]


def program_spans(t: Trace, prefix: str = PROGRAM) -> List[Span]:
    """The host operations whose name starts with ``prefix``."""
    return [op for op in t.host_ops if op[0].startswith(prefix)]


def in_units(t: Trace, spans: Sequence[Span]) -> List[Span]:
    """The spans that start inside a traced unit."""
    units = union(t.units)
    return [sp for sp in spans if any(s <= sp[1] < e for s, e in units)]


def intersect(a: Sequence[Interval], b: Sequence[Interval]) -> List[Interval]:
    """The intervals where both ``a`` and ``b`` hold, merged and in order."""
    a, b = union(a), union(b)
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def idle(t: Trace) -> List[Interval]:
    """The traced span's intervals in which no device operation runs."""
    lo, hi = t.span()
    out, prev = [], lo
    for s, e in t.busy() + [(hi, hi)]:
        s, e = min(max(s, lo), hi), min(e, hi)
        if s > prev:
            out.append((prev, s))
        prev = max(prev, e)
    return out


def length(intervals: Sequence[Interval]) -> float:
    return sum(e - s for s, e in union(intervals))


def launch_bytes(name: str) -> Tuple[str, int]:
    """(kernel, bytes) of a ``kernel/`` span's name; bytes -1 where the
    name carries none."""
    kernel, _, nbytes = name[len(KERNEL):].partition(BYTES)
    return kernel, int(nbytes) if nbytes else -1

