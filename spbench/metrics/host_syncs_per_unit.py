"""Host synchronisations a traced unit: the program's ``sync/`` spans (one
a read of a device value by the host) that start inside the traced units,
over the number of those units.  Nothing where the program records no
span."""

from spbench import spans


def read(r):
    t = r.trace
    if t is None or not t.units or not spans.program_spans(t):
        return None
    return len(spans.in_units(t, spans.program_spans(t, spans.SYNC))) / len(t.units)
