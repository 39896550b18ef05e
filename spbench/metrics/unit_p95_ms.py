"""The 95th percentile of every unit's wall time in the window, host clock,
a unit ending in a synchronisation; failed units count with their time."""

import numpy as np


def read(r):
    if not r.unit_seconds:
        return None
    return float(np.percentile(np.asarray(r.unit_seconds) * 1e3, 95))
