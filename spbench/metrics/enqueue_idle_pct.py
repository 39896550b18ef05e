"""The device's idle time that the program's own enqueueing causes: 100 x
the idle time of the traced span during which the host is inside a
``sparsetpu_torch.`` span and not inside a ``sparsetpu_torch.sync/`` one,
over the traced span.  ``device_idle_pct`` less this is the idle that
belongs to the caller and to the host's reads of the device.  Nothing where
the program records no span."""

from spbench import spans
from spbench.trace import overlap


def read(r):
    t = r.trace
    if t is None or not t.device_ops or t.span_us() <= 0:
        return None
    prog = spans.program_spans(t)
    if not prog:
        return None
    inside = [(s, e) for name, s, e in prog if not name.startswith(spans.SYNC)]
    syncs = [(s, e) for name, s, e in prog if name.startswith(spans.SYNC)]
    idle_inside = spans.intersect(spans.idle(t), inside)
    enqueue = spans.length(idle_inside) - overlap(idle_inside, syncs)
    return 100.0 * enqueue / t.span_us()
