"""Band measures for the router, ported from ``sparsetpu/kernels/bandmm.py``.

Only ``cyclic_bandwidth`` is ported so far; the block-band product itself
comes with the rest of ``ops/hybrid.py`` (``hybrid_matmul``), as ROADMAP
queue 1 says.
"""

from __future__ import annotations

import numpy as np

from ..csr import HostCSR


def cyclic_bandwidth(a: HostCSR) -> int:
    """Max cyclic column offset min(|c - r| mod n, |r - c| mod n) over all
    entries (n = a.n_rows)."""
    n = a.n_rows
    delta = a.col_idx.astype(np.int64) - a.rows()
    dc = np.minimum(np.mod(delta, n), np.mod(-delta, n))
    return int(dc.max(initial=0))
