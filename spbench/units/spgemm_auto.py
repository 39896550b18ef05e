"""Unit kind ``spgemm_auto``: graph products on the program's device CSR,
each one call of its general SpGEMM entry point, ``ops.spgemm.spgemm_auto``,
on the route its router picks.

The route is not pinned: a router that picks another route runs the same
cell.  ``spgemm_auto`` returns each product checked (``check()`` raises on
a poisoned one), as a caller gets it.  A unit drops the previous unit's
products before its first, so one unit's results are alive at a time.
``info`` holds the route ``auto_route`` picks for each product, and the
column panels the tiled routes swept (``ops.denseacc.PANELS``, where the
program counts them) and the dense-acc launches (``kernels.spmm.LAUNCHES``,
CUDA launches only) of the last unit.

Traffic keys: ``products``, the unit's products [l, r] = A^l x A^r, in
order; an operand is A or an earlier product of the same unit.
"""

from __future__ import annotations

from torch.profiler import record_function

from spbench.reference import ProgramCSR
from sparsetpu_torch.csr import SparseCSR
from sparsetpu_torch.kernels import spmm as kspmm
from sparsetpu_torch.ops import denseacc
from sparsetpu_torch.ops import spgemm as ops_spgemm
from sparsetpu_torch.semiring import by_name


def _panels():
    return getattr(denseacc, "PANELS", None)


def _route(a, b) -> str:
    """The route ``spgemm_auto`` takes for A x B, with its panel width on
    the tiled route."""
    tiers, route = ops_spgemm.auto_route(a, b, ops_spgemm.symbolic_flops_exact(a, b))
    if tiers:
        return "densedense"
    if route == "denseacc_tiled":
        return f"{route} panel_cols={ops_spgemm.dense_acc_panel_cols(a.n_rows)}"
    return route


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
        routes = None if "route" in self.info else {}  # read in the first (warm-up) unit
        panels, launches = _panels(), kspmm.LAUNCHES
        for l, r in self.products:
            with record_function(f"spbench.A^{l + r}"):
                a, b = have[l], have[r]
                if routes is not None:
                    routes[f"A^{l + r}"] = _route(a, b)
                have[l + r] = self.last[l + r] = ops_spgemm.spgemm_auto(a, b)
        if routes is not None:
            self.info["route"] = routes
        if panels is not None:
            self.info["panels_per_unit"] = _panels() - panels
        self.info["dense_acc_launches_per_unit"] = kspmm.LAUNCHES - launches

    def outputs(self) -> dict:
        out = {}
        for k, c in self.last.items():
            nnz = int(c.nnz)
            out[k] = ProgramCSR(c.row_ptr, c.col_idx[:nnz], tuple(v[:nnz] for v in c.values),
                                nnz, c.n_rows, c.n_cols)
        return out

    def release(self) -> None:
        self.a = None


def setup(ctx):
    return Products(ctx)
