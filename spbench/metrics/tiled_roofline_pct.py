"""The tiled route's dense-acc launches against their own roofline: the
least time of the ``kernel/spmm_dense_acc`` launches of the traced units
at the card's memory bandwidth (the bytes each span carries: A, each P row
it references and C once), over the device time of
``spmm_dense_acc_kernel`` inside the units.  Nothing unless every such
launch starts inside a ``product/denseacc_tiled`` span (the router took
the tiled route alone) and carries its bytes."""

from spbench import bounds, spans

KERNEL = "spmm_dense_acc"
GLOBAL = "spmm_dense_acc_kernel"
TILED = spans.PROGRAM + "product/denseacc_tiled"


def read(r):
    t = r.trace
    if t is None or not t.device_ops:
        return None
    tiled = spans.in_units(t, spans.program_spans(t, TILED))
    launches = [(spans.launch_bytes(name)[1], s)
                for name, s, _ in spans.in_units(t, spans.program_spans(t, spans.KERNEL))
                if spans.launch_bytes(name)[0] == KERNEL]
    if not tiled or not launches or any(
            b < 0 or not any(ts <= s < te for _, ts, te in tiled) for b, s in launches):
        return None
    busy_us = t.busy_in_units_us(lambda op: GLOBAL in op)
    if busy_us <= 0:
        return None
    return 100.0 * bounds.seconds_at_peak(sum(b for b, _ in launches)) * 1e6 / busy_us
