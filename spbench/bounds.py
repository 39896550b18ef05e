"""The least bytes a graph product must move, and the card's peak.

The bound is counted on the operation, whatever route computes it: the
product reads its two sparse inputs once and writes its output once, an
entry as a 4-byte column and the u64's 8-byte value, each matrix with
(n + 1) 4-byte row offsets.  A route's dense frames, sort buffers and
re-reads are not counted, so a route that moves less cannot read above
100 % of this bound.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM 80 GB data sheet, HBM3
ENTRY_BYTES = 4 + 8        # int32 column + u64 value
ROW_PTR_BYTES = 4


def product_bytes(nnz_left: int, nnz_right: int, nnz_out: int, n_left: int, n_right: int,
                  n_out: int) -> int:
    """Compulsory bytes of C = L x R (``n_*``: each matrix's row count)."""
    return ((nnz_left + nnz_right + nnz_out) * ENTRY_BYTES
            + (n_left + 1 + n_right + 1 + n_out + 1) * ROW_PTR_BYTES)


def unit_bytes(products: Iterable[Tuple[int, int]], nnz: Dict[int, int], n: int) -> int:
    """Compulsory bytes of a unit of graph products A^l x A^r (n x n each),
    ``nnz[k]`` the entry count of A^k."""
    return sum(product_bytes(nnz[l], nnz[r], nnz[l + r], n, n, n) for l, r in products)


def seconds_at_peak(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S
