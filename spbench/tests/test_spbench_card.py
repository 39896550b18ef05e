"""On the card: every cell's unit kind at a toy size, traced, against the
reference, and the control failing there.  Skipped without a card; on one,
``python -m pytest spbench/tests -m cuda``."""

import io
import time

import pytest
import torch

from spbench import control, run
from spbench.tests import toy

CELLS = [w["name"] for w in toy.real_spec()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    root = toy.make_root(str(tmp_path))
    r = run.run_cell(root, cell, 2**31 + 33, 0.2, True, "cuda:0", time.perf_counter(),
                     log=io.StringIO())
    assert r["correct"] is True, r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0
    got = control.control_readings(root, cell, 2**31 + 33, r["info"]["pairs"],
                                   r["info"]["judged"], "cuda:0")
    assert got["wrong_entries"] > 0
