"""Unit kind ``spgemm_esc``: graph products on the program's device CSR,
each one call of ``ops.spgemm.spgemm`` at the power-of-two capacity of the
exact flop count (``bench.py --algo esc``, and the per-shard product of
``dist/shard``), checked as a caller must.

Traffic keys: ``products``, the unit's products [l, r] = A^l x A^r, in
order; an operand is A or an earlier product of the same unit.
"""

from __future__ import annotations

from torch.profiler import record_function

from spbench.reference import ProgramCSR
from sparsetpu_torch.csr import SparseCSR
from sparsetpu_torch.ops import spgemm as ops_spgemm
from sparsetpu_torch.semiring import by_name


class Products:
    def __init__(self, ctx):
        rows, cols, vals, n = ctx.coo
        self.products = [tuple(p) for p in ctx.traffic["products"]]
        self.judged = sorted({l + r for l, r in self.products})
        self.a = SparseCSR.from_coo_host(rows, cols, vals, n, sr=by_name(ctx.config["semiring"]),
                                         device=ctx.device)
        self.info = {}
        self.last = {}

    def run(self) -> None:
        self.last = {}
        have = {1: self.a}
        for l, r in self.products:
            with record_function(f"spbench.A^{l + r}"):
                a, b = have[l], have[r]
                c = ops_spgemm.spgemm(a, b, ops_spgemm.pow2(ops_spgemm.symbolic_flops_exact(a, b)))
                have[l + r] = self.last[l + r] = c.check()

    def outputs(self) -> dict:
        return {k: ProgramCSR(c.row_ptr, c.col_idx, c.values, c.nnz, c.n_rows, c.n_cols)
                for k, c in self.last.items()}

    def release(self) -> None:
        self.a = None


def setup(ctx):
    return Products(ctx)
