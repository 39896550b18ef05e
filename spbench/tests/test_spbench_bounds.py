"""The bound arithmetic against hand counts, and its independence of the
route."""

import io
import time

import pytest
import torch

from spbench import bounds, reference, run
from spbench.generators import moore_torus
from spbench.tests import toy

TORUS30 = {"dims": [30, 30, 30], "density": 3 / 26, "thin_seed": 42}


def test_torus_a2_hand_count():
    rows, cols, vals, n = moore_torus.build(TORUS30, 42)
    a = reference.from_coo(rows, cols, vals, n, "cpu")
    a2 = reference.matmul(a, a)
    assert (a.nnz, a2.nnz) == (81_434, 251_590)
    # (81,434 + 81,434 + 251,590) x 12 + 3 x 27,001 x 4
    assert bounds.product_bytes(a.nnz, a.nnz, a2.nnz, n, n, n) == 5_297_508
    assert bounds.unit_bytes([(1, 1)], {1: a.nnz, 2: a2.nnz}, n) == 5_297_508


def test_peak_is_the_data_sheets():
    assert bounds.seconds_at_peak(3.35e12) == pytest.approx(1.0)


def test_dense_route_counts_the_bytes_of_a_csr_route(tmp_path):
    """The chain on the dense-acc route (A x A^k) and on ESC (A^k x A) make
    the same products, so their units have the same bound."""
    root = toy.make_root(str(tmp_path))
    got = {}
    for cell in ("torus30.chain7_auto", "torus30.chain7_esc"):
        result = run.run_cell(root, cell, 5, 0.05, False, "cpu", time.perf_counter(),
                              log=io.StringIO())
        got[cell] = result["info"]["unit_bytes"]
    assert got["torus30.chain7_auto"] == got["torus30.chain7_esc"] > 0


def test_reference_guards_its_range():
    big = reference.from_coo([0, 0], [0, 1], [1 << 40, 1 << 40], 2, "cpu")
    with pytest.raises(OverflowError):
        reference.matmul(big, big)
    with pytest.raises(OverflowError):
        reference.from_coo([0], [0], [1 << 63], 1, "cpu")
    assert torch.equal(reference.round_bf16(torch.tensor([255, 257, 7383])),
                       torch.tensor([255, 256, 7392]))
