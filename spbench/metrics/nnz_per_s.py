"""Exact output entries of every product of every completed unit in the
window, over the window's length.  The entry counts are the reference's."""


def read(r):
    if r.window_s <= 0 or not r.completed:
        return None
    return r.completed * r.unit_nnz / r.window_s
