"""The device's idle share of the traced span: 100 x (1 - the union of the
device operations' intervals / the span from the first traced unit's start
to the last one's end)."""


def read(r):
    t = r.trace
    if t is None or not t.device_ops or t.span_us() <= 0:
        return None
    return 100.0 * (1.0 - t.busy_us() / t.span_us())
