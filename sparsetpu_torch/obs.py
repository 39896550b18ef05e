"""The port's own spans, on ``torch.profiler``'s clock.

Anyone profiling the port with ``torch.profiler`` (CPU activity, with or
without CUDA) sees, beside PyTorch's own operators, where the port was:

- ``sparsetpu_torch.product/<route>``: one sparse product and the route
  that computed it (``product/auto/<route>`` around the route that
  ``spgemm_auto`` chose, with the route's own ``product/`` span inside);
- ``sparsetpu_torch.esc/symbolic``, ``/expand``, ``/sort``, ``/merge``: the
  stages of the ESC SpGEMM (the flop count, the expansion, the key sort of
  the COO build and its duplicate merge);
- ``sparsetpu_torch.tiled/count``, ``/pack``: the two column-panel sweeps
  of the tiled dense routes (``ops/denseacc._two_sweeps``);
- ``sparsetpu_torch.sync/<site>``: one read of a device value by the host,
  around the read alone, so its length is how long the host waited;
- ``sparsetpu_torch.kernel/<kernel> bytes=<int>``: one launch of a
  hand-written kernel, with the least bytes it must move (each input read
  once, each output written once), computed from sizes the host holds.

A span is recorded as a CPU operator (``_RecordFunctionFast``), not as a
user annotation: it has no shadow on the device's timeline, so the device
time a profile shows stays the kernels' own.  Spans are on exactly while a
profiler runs; otherwise :func:`span` and :func:`kernel` return one shared
object that does nothing, and a span's name, with any number in it, is not
built.
"""

from __future__ import annotations

import functools

import torch
from torch.autograd import profiler as _profiler

PREFIX = "sparsetpu_torch."


class _Off:
    """The span recorded while no profiler runs: nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


OFF = _Off()


def span(name: str):
    """A context manager recording ``sparsetpu_torch.<name>`` while a
    profiler runs, else :data:`OFF`."""
    if not _profiler._is_profiler_enabled:
        return OFF
    return torch._C._profiler._RecordFunctionFast(PREFIX + name)


def traced(name: str):
    """Decorator: every call of the function is the span ``name``."""
    label = PREFIX + name

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with torch._C._profiler._RecordFunctionFast(label):
                return fn(*args, **kwargs)
        return call
    return wrap


def item(x: torch.Tensor, site: str):
    """``x.item()``, one read of a device value by the host, recorded as the
    span ``sync/<site>`` around the read alone while a profiler runs."""
    if not _profiler._is_profiler_enabled:
        return x.item()
    with torch._C._profiler._RecordFunctionFast(PREFIX + "sync/" + site):
        return x.item()


def recording() -> bool:
    """Whether a profiler runs: for a number that only a span carries and
    that costs device work to count."""
    return _profiler._is_profiler_enabled


def kernel(name: str, nbytes=None, *args):
    """The span of one launch of the hand-written kernel ``name``:
    ``sparsetpu_torch.kernel/<name> bytes=<nbytes(*args)>`` while a
    profiler runs, else :data:`OFF`.  ``nbytes`` is called only while a
    profiler runs; without it, or where it returns None, the name has no
    ``bytes=``."""
    if not _profiler._is_profiler_enabled:
        return OFF
    label = f"{PREFIX}kernel/{name}"
    n = None if nbytes is None else nbytes(*args)
    if n is not None:
        label += f" bytes={int(n)}"
    return torch._C._profiler._RecordFunctionFast(label)
