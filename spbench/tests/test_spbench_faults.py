"""``correct`` comes out false when the timed path is broken underneath,
and when the control takes the program's place.

Each fault a cell can have is planted in the program's entry point that
the cell's unit calls, and the rest of a run (set-up, window, reference,
comparison) runs as on the card, on the CPU: a step that returns its state
unchanged, half of the rows left out of a product, one answer altered
where it is produced.  The cells run on one chip, so there is no exchange
between chips to leave out.
"""

import io
import time

import numpy as np
import pytest
import torch

from spbench import control, run
from spbench.tests import toy
from sparsetpu_torch.csr import SparseCSR
from sparsetpu_torch.kernels import spmm as kspmm
from sparsetpu_torch.ops import spgemm as ops_spgemm
from sparsetpu_torch.semiring import U64

CELLS = [w["name"] for w in toy.real_spec()["workloads"]]
FAULTS = ("unchanged", "half_rows", "altered")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return toy.make_root(str(tmp_path_factory.mktemp("toy")))


def _break_csr(c: SparseCSR, fault: str) -> SparseCSR:
    row_ptr, col, vals = c.to_numpy()
    rows = np.repeat(np.arange(c.n_rows), np.diff(row_ptr))
    if fault == "half_rows":
        keep = rows < c.n_rows // 2
        rows, col, vals = rows[keep], col[keep], vals[keep]
    else:
        vals = vals.copy()
        vals[len(vals) // 2] += np.uint64(1)
    return SparseCSR.from_coo_host(rows, col, vals, c.n_rows, c.n_cols, sr=U64, device="cpu")


def _plant(monkeypatch, fault: str) -> None:
    dense_acc, esc = kspmm.spmm_dense_acc, ops_spgemm.spgemm

    def broken_dense_acc(op, p, out=None):
        if fault == "unchanged":
            return out.copy_(p)
        c = dense_acc(op, p, out=out)
        if fault == "half_rows":
            c[c.shape[0] // 2:] = 0
        else:
            c.view(-1)[torch.nonzero(c.view(-1))[0]] += 1
        return c

    def broken(product):
        def call(a, b, *args, **kw):
            return a if fault == "unchanged" else _break_csr(product(a, b, *args, **kw), fault)
        return call

    monkeypatch.setattr(kspmm, "spmm_dense_acc", broken_dense_acc)
    monkeypatch.setattr(ops_spgemm, "spgemm", broken(esc))


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_makes_the_run_incorrect(root, cell, fault, monkeypatch):
    _plant(monkeypatch, fault)
    r = run.run_cell(root, cell, 2**31 + 21, 0.05, False, "cpu", time.perf_counter(),
                     log=io.StringIO())
    assert r["correct"] is False
    assert r["checks"]["wrong_entries"]["value"] > r["checks"]["wrong_entries"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_where_the_program_passes(root, cell):
    r = run.run_cell(root, cell, 77, 0.05, False, "cpu", time.perf_counter(), log=io.StringIO())
    assert r["correct"] is True
    got = control.control_readings(root, cell, 77, r["info"]["pairs"], r["info"]["judged"], "cpu")
    assert got["wrong_entries"] > r["checks"]["wrong_entries"]["limit"]
