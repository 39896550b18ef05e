"""Sharded SpGEMM with a B-panel ring (both operands row-sharded): the
counterpart of ``sparsetpu/dist/panels.py`` on ``torch.distributed``.

``dist/shard.py`` replicates the right operand, the right call when B is
the small static base matrix of the A^k chain.  When B is itself large (a
grown product squared, C = P x P), every rank keeps its *panel* (its block
of B's rows) and the panels rotate around the ring while each rank expands
the partial products whose inner index k falls inside the panel it holds.
After nd steps every (A entry, B row) pair has met once, and one local
sort/compress turns the streams into the output row block.

JAX's ring is one jit whose ``ppermute`` of step t+1 and expansion against
panel t are independent, so the compiler may overlap the transfer with the
compute.  Here the overlap is in the program order: step t+1's send and
receive (``torch.distributed.batch_isend_irecv``, to rank - 1 and from rank
+ 1, into a second buffer) are posted **before** the expansion against
panel t, and waited for after it.  The loop reads nothing back to the host
between steps; the only synchronisation is what a step's transfer needs
(under gloo, the copy of a CUDA panel to pinned host memory).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..csr import SparseCSR
from ..ops import segments
from ..ops.segments import INT32_SENTINEL
from ..ops.spgemm import pow2
from .shard import (AXIS, ShardedCSR, _staged, _wire_buffer, all_gather, default_mesh,
                    mesh_rank, to_wire)


def symbolic_flops_panels(a: ShardedCSR, b: ShardedCSR,
                          mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """flops[d, s] = the partial products rank d generates against B-panel
    s, int64[nd, nd] on every rank.  One all-gather of B's local row nnz,
    a per-panel sum, then an all-gather of the rows.  The row sums are each
    rank's total (``symbolic_flops_sharded`` with a replicated B)."""
    mesh = mesh if mesh is not None else default_mesh(a.n_shards)
    nd = mesh.size()
    nlb = b.n_local
    rn_all = all_gather(b.row_ptr[1:] - b.row_ptr[:-1], mesh).long()  # (nd, nlb)
    valid = torch.arange(a.capacity, device=a.device) < a.nnz
    k = torch.clamp(a.col_idx.long(), 0, nd * nlb - 1)
    panel = k // nlb
    counts = torch.where(valid, rn_all[panel, k % nlb], 0)
    per_panel = torch.zeros(nd, dtype=torch.int64, device=a.device).index_add_(0, panel, counts)
    return all_gather(per_panel, mesh)


def _expand_against_panel(sr, a_rows, a_cols, a_vals, valid_a, p_rp, p_ci, p_vals,
                          panel_base: int, nlb: int, step_cap: int, n_rows_local: int):
    """The partial-product streams (i, j, v, valid, total) of the A entries
    whose column k lies in the held B panel [panel_base, panel_base + nlb),
    each ``step_cap`` slots long (``ops/spgemm.expand_products`` with a
    panel-membership mask); ``total`` is the true count, a device scalar."""
    cap_a = a_cols.shape[0]
    device = a_cols.device
    in_panel = valid_a & (a_cols >= panel_base) & (a_cols < panel_base + nlb)
    k_loc = torch.clamp(a_cols - panel_base, 0, nlb - 1)
    row_nnz = (p_rp[1:] - p_rp[:-1]).long()
    counts = torch.where(in_panel, row_nnz[k_loc], 0)
    cum = torch.cumsum(counts, 0)
    first = cum - counts
    total = cum[-1]
    t = torch.arange(step_cap, device=device)
    # an entry with no products repeats the next entry's start and covers no
    # slot; starts past the capacity drop out
    src = segments.repeat_index(first, torch.arange(cap_a, device=device), step_cap)
    valid_e = t < total
    src = torch.clamp(src, 0, cap_a - 1)
    shift = p_rp.long()[k_loc] - first
    p_pos = torch.clamp(t + shift[src], 0, p_ci.shape[0] - 1)
    i = torch.where(valid_e, a_rows[src], n_rows_local)
    j = torch.where(valid_e, p_ci[p_pos], INT32_SENTINEL)
    v = sr.mul(sr.gather(a_vals, src), sr.gather(p_vals, p_pos))
    v = sr.where(valid_e, v, sr.zeros((step_cap,), device=device))
    return i, j, v, valid_e, total


def _post_rotation(panel: List[torch.Tensor], mesh: DeviceMesh):
    """Post the ring's transfer of ``panel`` (row_ptr, col_idx, *limbs):
    send it to rank - 1, receive rank + 1's into fresh buffers.  Returns
    (requests, the buffers the next panel lands in)."""
    group = mesh.get_group(AXIS)
    nd, me = mesh.size(), mesh_rank(mesh)
    to_prev = dist.get_global_rank(group, (me - 1) % nd)
    from_next = dist.get_global_rank(group, (me + 1) % nd)
    wires = [to_wire(t, mesh) for t in panel]
    staged = _staged(panel[0], mesh)
    bufs = [_wire_buffer(w, staged) for w in wires]
    ops = ([dist.P2POp(dist.isend, w, to_prev, group, tag) for tag, w in enumerate(wires)]
           + [dist.P2POp(dist.irecv, r, from_next, group, tag) for tag, r in enumerate(bufs)])
    return dist.batch_isend_irecv(ops), bufs


def spgemm_panels(a: ShardedCSR, b: ShardedCSR, step_cap: int,
                  out_cap: Optional[int] = None,
                  mesh: Optional[DeviceMesh] = None) -> ShardedCSR:
    """C = A x B with BOTH operands row-sharded; B's panels ride the ring.

    ``step_cap`` >= the largest entry of ``symbolic_flops_panels``;
    ``out_cap`` bounds a rank's output nnz (default nd * step_cap, the
    whole expansion).  A ring step whose expansion passes ``step_cap``
    poisons the shard's nnz to -1, even when the total over the steps fits
    (products are dropped per step)."""
    mesh = mesh if mesh is not None else default_mesh(a.n_shards)
    nd = mesh.size()
    if a.n_shards != nd or b.n_shards != nd:
        raise ValueError(f"shards {a.n_shards} x {b.n_shards} on a mesh of {nd}")
    if a.n_cols != b.n_rows:
        raise ValueError(f"shapes ({a.n_rows}, {a.n_cols}) x ({b.n_rows}, {b.n_cols}) "
                         "do not chain")
    out_cap = out_cap or nd * step_cap
    sr = a.sr
    device = a.device
    me = mesh_rank(mesh)
    n_local, nlb = a.n_local, b.n_local
    a_loc = a.local()
    valid_a = torch.arange(a.capacity, device=device) < a.nnz
    a_rows = a_loc.row_of_slot()
    a_cols = a.col_idx.long()

    i_all = torch.full((nd * step_cap,), n_local, dtype=torch.int64, device=device)
    j_all = torch.full((nd * step_cap,), INT32_SENTINEL, dtype=torch.int32, device=device)
    ok_all = torch.zeros(nd * step_cap, dtype=torch.bool, device=device)
    v_all = sr.zeros((nd * step_cap,), device=device)
    flops_ok = torch.ones((), dtype=torch.bool, device=device)

    held = [b.row_ptr, b.col_idx, *b.values]
    for step in range(nd):
        # step t + 1's panel is in flight while this step expands panel t
        pending = _post_rotation(held, mesh) if step + 1 < nd else None
        src_shard = (me + step) % nd  # whose panel is held now
        i, j, v, ok, total = _expand_against_panel(
            sr, a_rows, a_cols, a.values, valid_a, held[0], held[1], tuple(held[2:]),
            src_shard * nlb, nlb, step_cap, n_local)
        span = slice(step * step_cap, (step + 1) * step_cap)
        i_all[span], j_all[span], ok_all[span] = i, j, ok
        for buf, limb in zip(v_all, v):
            buf[span] = limb
        flops_ok = flops_ok & (total <= step_cap)
        if pending is not None:
            reqs, bufs = pending
            for req in reqs:
                req.wait()
            held = [t.to(device, non_blocking=True) for t in bufs]

    c = SparseCSR.from_coo_device(i_all, j_all, v_all, n_local, b.n_cols, sr, out_cap,
                                  valid=ok_all)
    # a step over step_cap dropped products: poison, as ops/spgemm.spgemm does
    nnz = torch.where(flops_ok, c.nnz, -1)
    return ShardedCSR(row_ptr=c.row_ptr, col_idx=c.col_idx, values=c.values, nnz=nnz,
                      n_rows=a.n_rows, n_cols=b.n_cols, sr_name=a.sr_name,
                      n_local=n_local, n_shards=nd, rank=a.rank)


def panel_caps(flops: torch.Tensor, round_to_pow2: bool = True) -> Tuple[int, int]:
    """(step_cap, out_cap) from ``symbolic_flops_panels``: the largest
    (rank, panel) count, and the largest rank's total over its panels, which
    bounds its output nnz (far below nd * step_cap, the default, which made
    the final sort nd times larger than needed); each a power of two when
    ``round_to_pow2``."""
    cap = max(int(flops.max()), 1)
    out_cap = max(int(flops.sum(dim=1).max()), 1)
    if round_to_pow2:
        cap, out_cap = pow2(cap), pow2(out_cap)
    return cap, out_cap


def spgemm_panels_auto(a: ShardedCSR, b: ShardedCSR, mesh: Optional[DeviceMesh] = None,
                       round_to_pow2: bool = True) -> ShardedCSR:
    """Two passes: the sharded symbolic pass sizes the per-step capacity and
    the output capacity (``panel_caps``), then the ring runs."""
    mesh = mesh if mesh is not None else default_mesh(a.n_shards)
    step_cap, out_cap = panel_caps(symbolic_flops_panels(a, b, mesh=mesh), round_to_pow2)
    return spgemm_panels(a, b, step_cap=step_cap, out_cap=out_cap, mesh=mesh)
