"""The products' share of their roofline: the least time of the traced
units' products at the card's memory bandwidth (``bounds``: each input read
once, each output written once, whatever the route) over the device's busy
time inside those units."""

from spbench import bounds


def read(r):
    t = r.trace
    if t is None or not t.completed_units or not t.unit_bytes:
        return None
    busy_us = t.busy_in_units_us()
    if busy_us <= 0:
        return None
    return 100.0 * t.completed_units * bounds.seconds_at_peak(t.unit_bytes) * 1e6 / busy_us
