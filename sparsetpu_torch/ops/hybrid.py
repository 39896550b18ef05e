"""Chain router, ported from ``sparsetpu/ops/hybrid.py``.

``choose_strategy`` keeps the JAX package's rule and constants unchanged,
including ``dense_bytes <= 4e9`` and the 1024-column padding, so that the two
routers can be held equal in the tests.  Re-deriving them for an 80 GB card
is a ROADMAP item (the constants for 80 GB, beside ``spgemm_auto``).
"""

from __future__ import annotations

from ..csr import F32_EXACT_LIMIT, HostCSR
from ..kernels.bandmm import cyclic_bandwidth

__all__ = ["F32_EXACT_LIMIT", "choose_strategy"]


def _csr_max_value(a: HostCSR) -> float:
    return float(a.vals.max()) if a.nnz else 0.0


def choose_strategy(a: HostCSR, steps: int = 1) -> str:
    """Pick the kernel category for C = A^(steps+1) chains:

      - "dense-acc": the product densifies (expected final row degree
        deg^(steps+1) reaches 1% of n) and the dense product fits
        (kernels/spmm.py);
      - "band": (cyclic-)banded support with an occupied band (the
        block-band product, sparsetpu/kernels/bandmm.py: not in the port);
      - "esc": everything else, and any value beyond the f32 carrier (the
        chain driver runs it as the rowcat chain, ops/rowcat.py, as
        bench.py does).
    """
    n = a.n_rows
    nnz = a.nnz
    if nnz == 0 or n == 0:
        return "esc"
    if _csr_max_value(a) >= F32_EXACT_LIMIT:
        return "esc"
    deg = max(nnz / max(n, 1), 1.0)
    exp_row_deg = min(deg ** (steps + 1), float(n))
    padded_cols = -(-n // 1024) * 1024
    dense_bytes = n * padded_cols * 4
    if dense_bytes <= 4e9 and exp_row_deg >= 0.01 * n:
        return "dense-acc"
    bw = cyclic_bandwidth(a)
    band_frac = 2.0 * bw / max(n, 1)
    band_density = nnz / max(band_frac * n * n, 1.0)
    if band_density > 0.01:
        return "band"
    return "esc"
