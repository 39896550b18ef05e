"""The chain on the "dense-acc" route: every step one launch of the
hand-written dense-accumulator SpMM, C = A x P (``kernels.spmm``).

Set-up builds the operand, P0 = A densified, and two (n, n) float32
buffers, once.  A unit is ``steps`` launches from P0, ping-ponging the two
buffers, with nothing read back; the run synchronises after it.  The last
unit's A^(steps + 1) is judged whole.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from spbench.reference import ProgramDense
from sparsetpu_torch.kernels import spmm as kspmm


class DenseAccChain:
    def __init__(self, ctx, host):
        steps = ctx.traffic["steps"]
        self.op = kspmm.prepare_sparse_operand(host, ctx.device)
        self.p0 = kspmm.densify(self.op)
        self.bufs = (torch.empty_like(self.p0), torch.empty_like(self.p0))
        self.products = [(1, k) for k in range(1, steps + 1)]  # A^(k+1) = A x A^k
        self.judged = [steps + 1]  # the ping-pong keeps only the last power
        self.info = {}
        self.last = None

    def run(self) -> None:
        self.last = None
        p = self.p0
        for i, (l, r) in enumerate(self.products):
            with record_function(f"spbench.A^{l + r}"):
                p = kspmm.spmm_dense_acc(self.op, p, out=self.bufs[i % 2])
        self.last = p

    def outputs(self) -> dict:
        if self.last is None:
            return {}
        return {sum(self.products[-1]): ProgramDense(self.last)}

    def release(self) -> None:
        self.op = self.p0 = self.bufs = None


def setup(ctx, host):
    return DenseAccChain(ctx, host)
