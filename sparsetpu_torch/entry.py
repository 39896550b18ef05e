"""Entry points of the port: one SpGEMM step to compile
and run, and the multi-device dry run; the counterparts of
``__graft_entry__.py``'s ``entry`` and ``dryrun_multichip``."""

from __future__ import annotations

from .csr import DEFAULT_DEVICE
from .dist import multihost, programs


def entry(device=DEFAULT_DEVICE):
    """(fn, example_args): the ESC SpGEMM step on the u64 saturating
    semiring, C = A x B, on the 8^3 torus thinned at 3/26 (seed 42), at the
    power-of-two capacities of its nnz and flop count."""
    from .csr import SparseCSR
    from .graphs import generate
    from .ops.spgemm import pow2, spgemm, symbolic_flops
    from .semiring import U64

    rows, cols, vals, n = generate.thin(generate.lattice([8, 8, 8], torus=True), 3.0 / 26.0,
                                        seed=42)
    a = SparseCSR.from_coo(rows, cols, vals, n, sr=U64, capacity=pow2(len(rows)),
                           device=device)
    expand_cap = pow2(int(symbolic_flops(a, a)))

    def step(a_in, b_in):
        return spgemm(a_in, b_in, expand_cap)

    return step, (a, a)


def dryrun_multichip(n_devices: int, device=DEFAULT_DEVICE) -> dict:
    """The thinned 4^3 torus's A^2 over a world of ``n_devices`` ranks
    (``multihost.run_local``): sharded ESC with A replicated, the B-panel
    ring with both operands sharded, and the sharded band product.  The
    three nnz must agree; returns them."""
    return dryrun_verdict(n_devices,
                          multihost.run_local(programs.dryrun, n_devices, device=device)[0])


def dryrun_verdict(n_devices: int, got: dict) -> dict:
    """Check and print rank 0's ``programs.dryrun`` result of an
    ``n_devices`` world: the three A^2 nnz must agree."""
    if got["esc"] <= 0 or len(set(got.values())) != 1:
        raise RuntimeError(f"dryrun_multichip({n_devices}): A^2 nnz disagree: {got}")
    for label, key in (("ESC", "esc"), ("ring-panel", "ring"), ("band", "band")):
        print(f"dryrun_multichip({n_devices}): {label} A^2 nnz={got[key]} OK", flush=True)
    return got
