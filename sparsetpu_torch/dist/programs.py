"""Rank programs: what every rank of a ``multihost.run_local`` world runs.

Each program is a module-level function ``program(device, *args)`` that the
launcher pickles by its import path; its arguments and results are numpy
arrays, numbers, strings and containers of them (tensors in a result come
back as numpy).  The children import torch, numpy and the port only.  The
programs drive the public functions of ``dist/`` the way a caller does:
the tests compare their shards with the JAX package's, ``bench/scaling.py``
times whole chains, ``entry.dryrun_multichip`` and ``chip_smoke.py`` run
them at full size on the card.

Operands travel as host CSR arrays ``(row_ptr, col_idx, vals, n_rows,
n_cols, sr_name)`` (``vals`` uint64 or float32) and are rebuilt on each
rank's device; ``csr_arrays`` and ``coo_arrays`` make them from a
``SparseCSR`` and from a COO.
"""

from __future__ import annotations

import contextlib
import socket
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..csr import HostCSR, SparseCSR
from ..kernels import bandmm
from ..ops.spgemm import max_value, pow2
from ..semiring import by_name
from . import band as dband
from . import multihost, panels
from . import shard as dshard

HostArrays = Tuple[np.ndarray, np.ndarray, np.ndarray, int, int, str]


def csr_arrays(a: SparseCSR) -> HostArrays:
    """A ``SparseCSR``'s valid entries as host CSR arrays."""
    row_ptr, col_idx, vals = a.to_numpy()
    return row_ptr, col_idx, vals, a.n_rows, a.n_cols, a.sr_name


def coo_arrays(coo, sr_name: str = "u64") -> HostArrays:
    """A COO ``(rows, cols, vals, n)`` merged into host CSR arrays."""
    rows, cols, vals, n = coo
    h = HostCSR.from_coo(rows, cols, vals, n, n, sr_name)
    return h.row_ptr, h.col_idx, h.vals, n, n, sr_name


def on_device(arrays: HostArrays, device) -> SparseCSR:
    """Host CSR arrays as a ``SparseCSR`` on ``device`` (capacity nnz, or 1
    when empty)."""
    row_ptr, col_idx, vals, n_rows, n_cols, sr_name = arrays
    sr = by_name(sr_name)
    if not len(col_idx):
        return SparseCSR.empty(n_rows, n_cols, 1, sr, device)
    return SparseCSR.from_host_arrays(row_ptr, col_idx, sr.to_host_limbs(np.asarray(vals)),
                                      len(col_idx), n_rows, n_cols, sr, device)


def whole(c: SparseCSR) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(row_ptr int64, col_idx int32, vals) of a whole CSR's valid entries."""
    row_ptr, col_idx, vals = c.to_numpy()
    return row_ptr.astype(np.int64), col_idx, vals


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(device, mesh, fn):
    """(fn(), the slowest rank's seconds): from a barrier after a
    synchronisation to fn's end synchronised."""
    _sync(device)
    dist.barrier()
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, world_max(time.perf_counter() - t0, mesh)


def _wire_device(mesh) -> str:
    """Where a small tensor for a collective lives: the card under NCCL."""
    return "cuda" if dshard.transport(mesh) == "nccl" else "cpu"


def _gathered(x, dtype, mesh) -> torch.Tensor:
    """Every rank's number ``x``, in rank order."""
    return dshard.all_gather(torch.tensor([x], dtype=dtype, device=_wire_device(mesh)),
                             mesh)[:, 0]


def world_max(x: float, mesh) -> float:
    """The largest of every rank's ``x``."""
    return float(_gathered(x, torch.float64, mesh).max())


def _shard_of(arrays: HostArrays, device, mesh) -> Tuple[SparseCSR, dshard.ShardedCSR]:
    a = on_device(arrays, device)
    return a, dshard.shard(a, mesh.size(), mesh=mesh)


def _unshard_or_error(s: dshard.ShardedCSR, mesh):
    """The whole CSR's arrays, or the message of the ValueError unshard
    raises on a poisoned shard."""
    try:
        return whole(dshard.unshard(s, mesh))
    except ValueError as e:
        return f"ValueError: {e}"


# -- the tests' programs -----------------------------------------------------

def chain_cases(device, cases: Sequence[dict]) -> List[dict]:
    """Per case ``{"a": HostArrays, "steps": k, "expand_cap": None or int}``:
    shard A (or, with ``"jax"``, start from the JAX package's sharded state:
    the keyword arguments of ``interop.sharded_from_jax`` but ``rank``),
    then k sharded ESC steps C <- C x A, each at ``expand_cap`` or the power
    of two of the largest shard's flop count.  Returns, per case, the shard
    of the start and of every product (``shard.shard_arrays``), every step's
    all-gathered flops, every whole CSR (or unshard's error) and the total
    nnz of each."""
    from ..interop import sharded_from_jax

    mesh = dshard.default_mesh(dist.get_world_size())
    out = []
    for case in cases:
        a, s = _shard_of(case["a"], device, mesh)
        if "jax" in case:
            s = sharded_from_jax(**case["jax"], rank=dshard.mesh_rank(mesh), device=device)
        rec = {"shards": [dshard.shard_arrays(s)], "flops": [],
               "whole": [_unshard_or_error(s, mesh)], "total_nnz": [s.total_nnz(mesh)],
               "memory_bytes": s.memory_bytes()}
        for _ in range(case["steps"]):
            flops = dshard.symbolic_flops_sharded(s, a, mesh=mesh)
            cap = case.get("expand_cap") or pow2(int(flops.max()))
            s = dshard.spgemm_sharded(s, a, expand_cap=cap, mesh=mesh)
            rec["flops"].append(flops)
            rec["shards"].append(dshard.shard_arrays(s))
            rec["whole"].append(_unshard_or_error(s, mesh))
            rec["total_nnz"].append(s.total_nnz(mesh))
        out.append(rec)
    return out


def ring_cases(device, cases: Sequence[dict]) -> List[dict]:
    """Per case ``{"a": HostArrays, "b": HostArrays, "step_cap": None or
    int, "square": bool}``: both operands sharded, C = A x B through the
    ring (``spgemm_panels_auto``, or ``spgemm_panels`` at ``step_cap``);
    with ``square``, then C x C through the ring.  Returns the panel flops,
    the replicated-B flops, each product's shard and whole CSR (or error),
    and the shard of the same A x B with B replicated (``spgemm_sharded``
    at the power of two of its flops)."""
    mesh = dshard.default_mesh(dist.get_world_size())
    out = []
    for case in cases:
        _, sa = _shard_of(case["a"], device, mesh)
        b, sb = _shard_of(case["b"], device, mesh)
        flops = dshard.symbolic_flops_sharded(sa, b, mesh=mesh)
        esc = dshard.spgemm_sharded(sa, b, expand_cap=pow2(int(flops.max())), mesh=mesh)
        rec = {"flops_panels": panels.symbolic_flops_panels(sa, sb, mesh=mesh),
               "flops_sharded": flops, "esc_shard": dshard.shard_arrays(esc),
               "shards": [], "whole": []}
        if case.get("step_cap"):
            c = panels.spgemm_panels(sa, sb, step_cap=case["step_cap"], mesh=mesh)
        else:
            c = panels.spgemm_panels_auto(sa, sb, mesh=mesh)
        products = [c]
        if case.get("square"):
            products.append(panels.spgemm_panels_auto(c, c, mesh=mesh))
        for p in products:
            rec["shards"].append(dshard.shard_arrays(p))
            rec["whole"].append(_unshard_or_error(p, mesh))
        out.append(rec)
    return out


def ring_call_order(device, a: HostArrays) -> List[str]:
    """The order in which one ``spgemm_panels_auto`` call posts its ring
    transfers and runs its expansions ("post" / "expand"), recorded by
    wrapping ``torch.distributed.batch_isend_irecv`` and the ring's
    expansion for the call's duration."""
    mesh = dshard.default_mesh(dist.get_world_size())
    _, sa = _shard_of(a, device, mesh)
    events: List[str] = []
    post, expand = dist.batch_isend_irecv, panels._expand_against_panel

    def spy_post(ops):
        events.append("post")
        return post(ops)

    def spy_expand(*args, **kwargs):
        events.append("expand")
        return expand(*args, **kwargs)

    dist.batch_isend_irecv, panels._expand_against_panel = spy_post, spy_expand
    try:
        panels.spgemm_panels_auto(sa, sa, mesh=mesh)
    finally:
        dist.batch_isend_irecv, panels._expand_against_panel = post, expand
    return events


def band_cases(device, cases: Sequence[dict]) -> List[List[np.ndarray]]:
    """Per case ``{"a": HostArrays, "half_width", "block", "cyclic",
    "limbs": [(p_limbs, a_limbs), ...]}``: split A's band (no outliers
    allowed), shard P = A's band, then one sharded band product a limbs
    pair, each step's product staying sharded.  Returns each step's local
    block rows."""
    mesh = dshard.default_mesh(dist.get_world_size())
    out = []
    for case in cases:
        a = on_device(case["a"], device)
        band, outliers = bandmm.csr_band_split(a, case["half_width"], block=case["block"],
                                               cyclic=case["cyclic"])
        if int(outliers.nnz):
            raise ValueError(f"{int(outliers.nnz)} entries outside the band")
        p = dband.shard_band(band, mesh=mesh)
        rep = dband.replicate_band(band, mesh=mesh)
        steps = []
        for p_limbs, a_limbs in case["limbs"]:
            p = dband.band_matmul_sharded(p, rep, p_limbs=p_limbs, a_limbs=a_limbs, mesh=mesh)
            steps.append(p.data)
        out.append(steps)
    return out


def pod_cases(device, n_rows: int, a: HostArrays) -> dict:
    """The pod mesh's order and hosts, every rank's ``host_row_block``, and
    the ring's whole A x A on the pod mesh."""
    mesh = multihost.pod_mesh()
    hosts: list = [None] * dist.get_world_size()
    dist.all_gather_object(hosts, socket.gethostname())
    _, sa = _shard_of(a, device, mesh)
    c = panels.spgemm_panels_auto(sa, sa, mesh=mesh)
    return {"mesh": mesh.mesh.tolist(), "hosts": hosts, "rank": dist.get_rank(),
            "row_block": multihost.host_row_block(n_rows),
            "whole": whole(dshard.unshard(c, mesh))}


def run_all(device, calls: Sequence[Tuple[str, tuple]]) -> list:
    """Several programs of this module in one world: ``calls`` holds
    (program name, its arguments after ``device``)."""
    return [globals()[name](device, *args) for name, args in calls]


# -- the benchmarks' programs ------------------------------------------------

def scaling_point(device, a: HostArrays, steps: int, iters: int) -> dict:
    """One device count of ``bench/scaling.py``: the first step's per-shard
    flops, the final total nnz, and the seconds of each of ``iters`` whole
    chains of ``steps`` sharded ESC steps (after one untimed chain), each
    the slowest rank's, by the host clock from a barrier after a
    synchronisation to the chain's end synchronised."""
    mesh = dshard.default_mesh(dist.get_world_size())
    a_dev, s = _shard_of(a, device, mesh)
    flops = dshard.symbolic_flops_sharded(s, a_dev, mesh=mesh)

    def run_chain():
        cur = s
        for _ in range(steps):
            f = dshard.symbolic_flops_sharded(cur, a_dev, mesh=mesh)
            cur = dshard.spgemm_sharded(cur, a_dev, expand_cap=pow2(int(f.max())), mesh=mesh)
        return cur

    nnz = run_chain().total_nnz(mesh)
    seconds = [_timed(device, mesh, run_chain)[1] for _ in range(iters)]
    return {"flops": flops, "nnz": nnz, "seconds": seconds,
            "transport": dshard.transport(mesh)}


def dryrun(device) -> Dict[str, int]:
    """``entry.dryrun_multichip``'s world: the thinned 4^3 torus's A^2 three
    ways over the world (sharded ESC, the B-panel ring, the sharded band
    product), each total nnz."""
    from ..graphs import generate

    mesh = dshard.default_mesh(dist.get_world_size())
    arrays = coo_arrays(generate.thin(generate.lattice([4, 4, 4], torus=True), 0.3, seed=7))
    a, s = _shard_of(arrays, device, mesh)
    cap = pow2(int(dshard.symbolic_flops_sharded(s, a, mesh=mesh).max()))
    esc = dshard.spgemm_sharded(s, a, expand_cap=cap, mesh=mesh).total_nnz(mesh)
    sb = dshard.shard(a, mesh.size(), mesh=mesh)
    ring = panels.spgemm_panels_auto(s, sb, mesh=mesh).total_nnz(mesh)
    band, outliers = bandmm.csr_band_split(a, half_width=21, block=8, cyclic=True)
    if int(outliers.nnz):
        raise ValueError("the 4^3 torus has entries outside its band")
    c = dband.band_matmul_sharded(dband.shard_band(band, mesh=mesh), band, p_limbs=1,
                                  a_limbs=1, mesh=mesh)
    nnz_band = int(_gathered(int(c.nnz()), torch.int64, mesh).sum())
    return {"esc": esc, "ring": ring, "band": nnz_band}


# -- chip_smoke.py's program -------------------------------------------------

@contextlib.contextmanager
def _first_esc_call(kept: list):
    """Within the block, the arguments of the first ``kernels/esc``
    product (``spgemm_esc``, which ``ops.spgemm.spgemm`` calls for CUDA
    u32 and u64 operands) are appended to ``kept``; the product runs as
    before."""
    from ..kernels import esc

    launch = esc.spgemm_esc

    def keeping(*args):
        if not kept:
            kept.append(args)
        return launch(*args)

    esc.spgemm_esc = keeping
    try:
        yield
    finally:
        esc.spgemm_esc = launch


def _hold_esc(kept: list, where: str) -> int:
    """The ESC product kept by ``_first_esc_call`` run again on the kernels
    and on the tensor ops (``ops.spgemm.spgemm_reference``); raises unless
    every field (row offsets, columns, limbs, nnz) is equal.  That launch is
    not counted.  Returns the products held (0 or 1)."""
    from ..kernels import esc
    from ..ops.spgemm import spgemm_reference

    if not kept:
        return 0
    args = kept.pop()
    n_path = esc.LAUNCHES
    got = esc.spgemm_esc(*args)
    esc.LAUNCHES = n_path
    want = spgemm_reference(*args)
    for name, g, w in zip(("row_ptr", "col_idx", "limbs", "nnz"),
                          (got.row_ptr, got.col_idx, torch.stack(got.values), got.nnz),
                          (want.row_ptr, want.col_idx, torch.stack(want.values), want.nnz)):
        if not torch.equal(g, w):
            raise ValueError(f"{where}: the ESC kernels' {name} != the tensor ops'")
    return 1


def smoke(device, a: HostArrays, steps: int, iters: int, keep: Sequence[int],
          ring_pairs: Sequence[Tuple[int, int]], band: Optional[Tuple[int, int]]) -> dict:
    """The smoke's sharded paths on the full operand A:

    - the chain A^2..A^steps through ``spgemm_sharded``, the product kept
      sharded: each step's total nnz, max value and flop imbalance
      (max/mean over the shards), its ms (the least of ``iters`` passes,
      the flop read included), and the whole product of each step in
      ``keep``;
    - the ring C = A^p x A^q for each (p, q) of ``ring_pairs``, both
      operands the chain's sharded products: its capacities, ms and whole;
    - with ``band = (half_width, block)``, the sharded band product of A's
      cyclic band with itself against the unsharded ``band_matmul``;
    - the launches of the port's kernel wrappers in this rank: on a card
      the chain's products take the ESC kernels (``kernels/esc``), six
      launches a product, and nothing else; each step's first such product
      in the first pass is held against the tensor ops (``esc_held``, the
      steps held, ``_hold_esc``).

    Whole CSRs come back from rank 0 only."""
    from ..kernels import (bandplanes, blocksparse, coalesce, esc, groupdot, panelpack,
                           sortmerge, spmm)

    mesh = dshard.default_mesh(dist.get_world_size())
    rank0 = dshard.mesh_rank(mesh) == 0
    a_dev, s = _shard_of(a, device, mesh)
    out = {"transport": dshard.transport(mesh), "ranks": mesh.size(), "steps": [],
           "wholes": {}, "esc_held": 0}
    powers = {1: s}
    best = [float("inf")] * (steps - 1)
    for it in range(iters):
        cur = s
        for k in range(2, steps + 1):
            def step(cur=cur):
                f = dshard.symbolic_flops_sharded(cur, a_dev, mesh=mesh)
                cap = pow2(int(f.max()))
                return f, cap, dshard.spgemm_sharded(cur, a_dev, expand_cap=cap, mesh=mesh)

            kept = []
            with _first_esc_call(kept) if it == 0 else contextlib.nullcontext():
                (f, cap, cur), secs = _timed(device, mesh, step)
            best[k - 2] = min(best[k - 2], secs)
            if it == 0:
                out["esc_held"] += _hold_esc(kept, f"A^{k}")
                powers[k] = cur
                fl = f.double()
                out["steps"].append({
                    "step": k, "nnz": cur.total_nnz(mesh), "flops": int(f.sum()),
                    "expand_cap": cap,
                    "max": int(world_max(float(max_value(cur.local())), mesh)),
                    "imbalance": float(fl.max() / max(float(fl.mean()), 1.0))})
    for rec, secs in zip(out["steps"], best):
        rec["ms"] = secs * 1e3
    for k in keep:
        c = dshard.unshard(powers[k], mesh)
        out["wholes"][k] = whole(c) if rank0 else None
        del c

    out["ring"] = []
    for p, q in ring_pairs:
        step_cap, out_cap = panels.panel_caps(
            panels.symbolic_flops_panels(powers[p], powers[q], mesh=mesh))
        c, secs = _timed(device, mesh, lambda: panels.spgemm_panels(
            powers[p], powers[q], step_cap=step_cap, out_cap=out_cap, mesh=mesh))
        c_whole = dshard.unshard(c, mesh)
        out["ring"].append({"p": p, "q": q, "step_cap": step_cap, "out_cap": out_cap,
                            "ms": secs * 1e3, "nnz": int(c_whole.nnz),
                            "whole": whole(c_whole) if rank0 else None})
        del c, c_whole
    if band is not None:
        half_width, block = band
        full, outliers = bandmm.csr_band_split(a_dev, half_width, block=block, cyclic=True)
        if int(outliers.nnz):
            raise ValueError(f"{int(outliers.nnz)} entries outside the band")
        p_sh = dband.shard_band(full, mesh=mesh)
        c, secs = _timed(device, mesh,
                         lambda: dband.band_matmul_sharded(p_sh, full, mesh=mesh))
        want = bandmm.band_matmul(full, full)
        lo = dshard.mesh_rank(mesh) * c.nb
        same = bool(torch.equal(c.data, want.data[lo:lo + c.nb]))
        out["band"] = {"nb": full.nb, "nb_local": c.nb, "half_width": half_width,
                       "block": block,
                       "bit_equal": bool(_gathered(int(same), torch.int64, mesh).all()),
                       "nnz": int(_gathered(int(c.nnz()), torch.int64, mesh).sum()),
                       "ms": secs * 1e3}
    out["launches"] = {name: mod.LAUNCHES for name, mod in (
        ("spmm_dense_acc", spmm), ("spmm_band", bandplanes), ("spmm_group_dot", groupdot),
        ("sdd_block_scores", blocksparse), ("sortmerge_rows", sortmerge),
        ("coalesce_blocks", coalesce), ("spgemm_esc", esc), ("panelpack", panelpack))}
    return out
