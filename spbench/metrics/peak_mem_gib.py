"""torch.cuda.max_memory_allocated() over the window, after a reset at its
start, in GiB."""


def read(r):
    if r.window_peak_bytes is None:
        return None
    return r.window_peak_bytes / 2**30
