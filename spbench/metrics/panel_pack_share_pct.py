"""The share of the device's busy time inside the traced units spent
outside the dense-acc kernel (``spmm_dense_acc_kernel``): B's panels
densified, each panel's rows counted and checked, its nonzeros packed and
scattered into the product, and the rest of a unit.  Nothing where no
``product/denseacc_tiled`` span lies in a traced unit (the router took
another route)."""

from spbench import spans

GLOBAL = "spmm_dense_acc_kernel"
TILED = spans.PROGRAM + "product/denseacc_tiled"


def read(r):
    t = r.trace
    if t is None or not t.device_ops or not spans.in_units(t, spans.program_spans(t, TILED)):
        return None
    busy_us = t.busy_in_units_us()
    if busy_us <= 0:
        return None
    return 100.0 * (busy_us - t.busy_in_units_us(lambda name: GLOBAL in name)) / busy_us
