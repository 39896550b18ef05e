"""The hand-written kernels' share of their own roofline: the least time
of the launches inside the traced units at the card's memory bandwidth (the
bytes each ``kernel/<kernel> bytes=<int>`` span carries: each input read
once, each output written once) over those kernels' device time inside the
units.  A device operation is a kernel's by its ``__global__`` name in
``sparsetpu_torch/csrc/*.cu`` (``GLOBALS``).  A kernel with a launch whose
span carries no bytes is left out, with its device time.  Nothing where no
launch carries bytes."""

from spbench import bounds, spans

GLOBALS = {  # the program's kernel name -> its __global__ function
    "spmm_dense_acc": "spmm_dense_acc_kernel",
    "spmm_band": "spmm_band_kernel",
    "spmm_group_dot": "spmm_group_dot_kernel",
    "sortmerge_rows": "sortmerge_rows_kernel",
    "coalesce_blocks": "coalesce_blocks_kernel",
    "sdd_block_scores": "sdd_block_scores_kernel",
}


def read(r):
    t = r.trace
    if t is None or not t.device_ops:
        return None
    by_kernel = {}
    for name, _, _ in spans.in_units(t, spans.program_spans(t, spans.KERNEL)):
        kernel, nbytes = spans.launch_bytes(name)
        if kernel in GLOBALS:
            total = by_kernel.get(kernel, 0)
            by_kernel[kernel] = -1 if total < 0 or nbytes < 0 else total + nbytes
    counted = {GLOBALS[k]: b for k, b in by_kernel.items() if b >= 0}
    if not counted:
        return None
    busy_us = t.busy_in_units_us(lambda op: any(g in op for g in counted))
    if busy_us <= 0:
        return None
    return 100.0 * bounds.seconds_at_peak(sum(counted.values())) * 1e6 / busy_us
