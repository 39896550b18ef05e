"""The share of the device's busy time inside the traced units spent in
sort kernels, named by the substrings below (CUB's radix sorts behind
torch.sort and torch.unique, PyTorch's small in-place sorts, and the
port's sort-merge kernel), case ignored."""

SORT_KERNELS = ("radixsort", "sortkeyvalue", "bitonicsort", "segmentedsort", "mergesort",
                "sortmerge")


def is_sort(name: str) -> bool:
    low = name.lower()
    return any(k in low for k in SORT_KERNELS)


def read(r):
    t = r.trace
    if t is None or not t.device_ops:
        return None
    busy_us = t.busy_in_units_us()
    if busy_us <= 0:
        return None
    return 100.0 * t.busy_in_units_us(is_sort) / busy_us
