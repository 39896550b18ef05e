"""The dense-accumulator sources bench (sparsetpu_torch.bench.spmm_sources)
on the CPU at a toy size: its sweep operand and dense P equal the dense A
built from the JAX package's generators, its row-chunked plain product
equals the one-shot plain version and A·P computed in float64 (exact:
integer values), and its byte counts are the formulas' on a hand-made
operand.  The timing half needs a card (``chip_smoke.py``, the bench's
CLI)."""

import numpy as np
import pytest
import torch

from sparsetpu.graphs import datasets as jdata, generate as jgen

from sparsetpu_torch.bench import spmm_sources as ss
from sparsetpu_torch.csr import HostCSR
from sparsetpu_torch.kernels import spmm


def _jax_dense(coo):
    rows, cols, vals, n = coo
    dense = np.zeros((n, n))
    np.add.at(dense, (np.asarray(rows), np.asarray(cols)), np.asarray(vals, dtype=np.float64))
    return dense


@pytest.mark.parametrize("case,n,epn", [("er", 200, 4), ("powerlaw", 300, 8)])
def test_sweep_operand_matches_jax_graph(case, n, epn):
    op, p = ss.sweep_operand(case, n, epn, "cpu")
    coo = (jgen.random_graph(n, n * epn, seed=n + epn) if case == "er"
           else jdata.power_law(n, 8, seed=17))
    dense = _jax_dense(coo)
    np.testing.assert_array_equal(p.numpy(), dense.astype(np.float32))
    np.testing.assert_array_equal(spmm.densify(op).numpy(), dense.astype(np.float32))


@pytest.mark.parametrize("check_bytes", [1, 4 * 300 * 40, 1 << 31])
def test_plain_product_in_chunks(monkeypatch, check_bytes):
    """One-row chunks (a budget below one entry), chunks of ~40 entries, and
    one chunk give the same C, exactly A·P."""
    monkeypatch.setattr(ss, "CHECK_BYTES", check_bytes)
    op, p = ss.sweep_operand("powerlaw", 300, 8, "cpu")
    got = ss.plain_product(op, p)
    torch.testing.assert_close(got, spmm.spmm_dense_acc_reference(op, p), rtol=0, atol=0)
    a = spmm.densify(op).double().numpy()
    np.testing.assert_array_equal(got.numpy(), (a @ p.double().numpy()).astype(np.float32))


def test_byte_counts():
    # 3 x 4 operand, 4 entries over 3 distinct columns, one empty row
    h = HostCSR.from_coo([0, 0, 2, 2], [1, 3, 1, 0], [1, 2, 3, 4], 3, 4)
    op = spmm.prepare_sparse_operand(h, "cpu")
    m = 10
    assert ss.gather_bytes(op, m) == 4 * m * 4
    assert ss.compulsory_bytes(op, m) == (4 + 2 * 4 + 3 * m + 3 * m) * 4
