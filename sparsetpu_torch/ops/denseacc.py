"""Dense-accumulator and dense-dense SpGEMM: the counterpart of ``sparsetpu/ops/denseacc.py``.

Three routes of C = A x B that keep the product dense and pack it into a CSR
at the end; their cost does not depend on the number of partial products:

- the dense accumulator (``spgemm_dense_acc``): B densified to a row-major
  (k, m) f32 P, C = A x P through the hand-written kernel
  ``kernels.spmm.spmm_dense_acc`` (``csrc/spmm_dense_acc.cu``, the
  counterpart of the Pallas ``_spmm_kernel``; on a CPU tensor its plain
  version), then the pack;
- its column-panel sweep (``spgemm_dense_acc_tiled``): B's columns in panels
  of ``panel_cols``, so only one (k, w) P panel and one (n, w) C panel live
  at a time; sweep 1 counts each panel's row nonzeros and so gives the exact
  final row offsets, sweep 2 recomputes each panel and writes its entries
  at per-row offsets (panels own disjoint ascending column ranges, so no
  global sort).  On a CUDA card each sweep's work on a panel is one
  hand-written kernel (``kernels/panelpack``, ``csrc/panel_pack.cu``),
  on the CPU the tensor ops, their plain version;
- dense-dense (``spgemm_dense_dense``, ``spgemm_dense_dense_tiled``): both
  operands densified and one matrix product.  JAX computes it outside any
  Pallas kernel, so it stays ``torch.matmul``: fp32 with TF32 off (it raises
  if TF32 is enabled, never switches it), and the wide integer tier as one
  fp64 product on both devices (torch has no int32 matmul on CUDA).

Exactness, as in the JAX package: integer semirings ride an f32 carrier,
exact below 2^24, checked on the device; a violation poisons nnz to -1 and
``check()`` raises.  The dense-dense f32 tier keeps JAX's checks (inputs
< 2^16, outputs < 2^24) although an fp32 product does not need the input
bound, so that its poisoning, and with it ``spgemm_auto``'s tier cascade,
matches JAX's.  The wide tier keeps a product only when its f32 companion
reads < 2^30, so every partial sum is < 2^31 < 2^53 and the fp64 product is
exact.  The f32 semiring keeps a cell when its value is nonzero.

Differences from the JAX package, and why:

- The sparse operand is a ``kernels.spmm.SparseOperand`` built on the device
  from the ``SparseCSR`` (``plan_dense_acc``): the per-tile entry lists,
  ``rows_per_tile`` and the 1,024-column row planes are Mosaic layout and
  are gone, and so is the ``panel_cols % 1024 == 0`` rule: any panel width
  >= 1 is accepted.
- The pack (``_dense_to_csr_lanesort``) takes the nonzeros in row-major
  order (``torch.nonzero_static``), which is CSR order already: no (n, m)
  sort and no (n, m) index grid.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import obs
from ..csr import F32_EXACT_LIMIT, SparseCSR
from ..kernels import panelpack as kpanel
from ..kernels import spmm as kspmm
from ..semiring import by_name
from .segments import INT32_SENTINEL
from .spgemm import max_value, pow2, symbolic_flops_exact

IN_LIMIT_F32 = float(1 << 16)   # dense-dense f32 tier: inputs below this
WIDE_LIMIT = float(1 << 30)     # dense-dense wide tier: outputs below this

PANELS = 0  # column panels swept by the tiled routes, each sweep's counted


def _check_pair(a: SparseCSR, b: SparseCSR) -> None:
    if a.n_cols != b.n_rows or a.sr_name != b.sr_name:
        raise ValueError(f"{a.shape} {a.sr_name} x {b.shape} {b.sr_name} do not chain")


def _check_panel_cols(panel_cols: int) -> None:
    if panel_cols < 1:
        raise ValueError(f"panel_cols must be >= 1, got {panel_cols}")


def _below(x: torch.Tensor, limit: float) -> torch.Tensor:
    """Device bool: every element of x is below ``limit`` (True when empty)."""
    if x.numel() == 0:
        return torch.ones((), dtype=torch.bool, device=x.device)
    return x.max() < limit


def plan_dense_acc(a: SparseCSR) -> kspmm.SparseOperand:
    """The host half: A as the kernel's operand (int32 row offsets, the
    nnz valid columns, f32 values from the limbs), built on A's device.
    While a profiler runs, the operand also holds the number of distinct
    columns, counted on the device and read once, so that each launch's
    span carries its bytes; otherwise nothing is counted.  Raises
    ValueError on an integer value >= 2^24 (a nonzero u64 hi limb
    included), which the f32 carrier cannot hold exactly."""
    if a.sr_name != "f32" and max_value(a) >= F32_EXACT_LIMIT:
        raise ValueError("the dense accumulator requires values < 2^24")
    nnz = obs.item(a.check().nnz, "nnz")
    col = a.col_idx[:nnz].int().contiguous()
    distinct = None
    if obs.recording():
        seen = torch.zeros(a.n_cols, dtype=torch.bool, device=a.device)
        seen[col.long()] = True
        distinct = obs.item(torch.count_nonzero(seen), "distinct_cols")
    return kspmm.SparseOperand(a.row_ptr.int().contiguous(), col,
                               _values_to_f32(tuple(l[:nnz] for l in a.values),
                                              a.sr_name).contiguous(),
                               a.n_rows, a.n_cols, distinct)


def _values_to_f32(values, sr_name: str) -> torch.Tensor:
    """Limb tuple -> one f32 carrier tensor.  For u64 the hi limb rides as
    hi * 2^32, so any hi != 0 lands >= 2^24 and trips the exactness check."""
    bf = values[0].float()
    if sr_name == "u64":
        bf = bf + values[1].float() * float(1 << 32)
    return bf


def _limbs_from_f32(x: torch.Tensor, sr_name: str):
    """f32 carrier -> limb tuple (exactness checked by the caller)."""
    if sr_name == "f32":
        return (x,)
    lo = x.long()
    return (lo,) if sr_name == "u32" else (lo, torch.zeros_like(lo))


def _limbs_from_i32(x: torch.Tensor, sr_name: str):
    """Non-negative integer carrier (values < 2^31) -> limb tuple."""
    if sr_name not in ("u32", "u64"):
        raise ValueError(f"an integer carrier is for u32/u64, not {sr_name}")
    lo = x.long()
    return (lo,) if sr_name == "u32" else (lo, torch.zeros_like(lo))


def _pack(dense: torch.Tensor, sr_name: str, cap: int):
    """The nonzeros of ``dense`` (n, w) in row-major order, in ``cap``
    slots: (per-row counts, rows, local columns, limbs, valid slots, total
    count), int64 indices.  Slots past the total hold row n, column
    INT32_SENTINEL and value 0; nonzeros past ``cap`` are dropped."""
    n, w = dense.shape
    flat = dense.reshape(-1)
    size = flat.numel()
    pos = torch.nonzero_static(flat != 0, size=cap, fill_value=size)[:, 0]
    valid = pos < size
    val = torch.where(valid, flat[pos.clamp(max=max(size - 1, 0))], 0)
    rows = torch.where(valid, pos // max(w, 1), n)
    col = torch.where(valid, pos % max(w, 1), INT32_SENTINEL)
    counts = torch.count_nonzero(dense, dim=1)
    if dense.dtype == torch.float32:
        limbs = _limbs_from_f32(val, sr_name)
    else:
        limbs = _limbs_from_i32(val, sr_name)
    return counts, rows, col, limbs, valid, counts.sum()


def _dense_to_csr_lanesort(dense: torch.Tensor, sr_name: str, cap: int) -> SparseCSR:
    """Dense carrier (n, m) -> ``SparseCSR`` of capacity ``cap``, columns
    ascending in each row; more than ``cap`` nonzeros poisons nnz to -1.
    ``dense`` is the f32 carrier or, for the wide dense-dense tier, an fp64
    one holding integers below 2^31."""
    n, m = dense.shape
    counts, _, col, limbs, _, total = _pack(dense, sr_name, cap)
    rp = torch.cat([counts.new_zeros(1), torch.cumsum(counts, dim=0)]).int()
    return SparseCSR(row_ptr=rp, col_idx=col.int(), values=limbs,
                     nnz=torch.where(total <= cap, total, -1),
                     n_rows=n, n_cols=m, sr_name=sr_name)


def _densify(x: SparseCSR, lo: int = 0, w: Optional[int] = None) -> torch.Tensor:
    """Columns [lo, lo + w) of x (all of them by default) as a dense
    (n_rows, w) f32 carrier, by one scatter on x's device."""
    w = x.n_cols - lo if w is None else w
    rows = x.row_of_slot()
    cols = x.col_idx.long()
    valid = (torch.arange(x.capacity, device=x.device) < x.nnz) & (cols >= lo) & (cols < lo + w)
    flat = torch.where(valid, rows * w + (cols - lo), x.n_rows * w)
    out = torch.zeros(x.n_rows * w + 1, dtype=torch.float32, device=x.device)
    out[flat] = torch.where(valid, _values_to_f32(x.values, x.sr_name), 0.0)
    return out[:-1].view(x.n_rows, w)


def _exact_f32(dense: torch.Tensor, sr_name: str) -> torch.Tensor:
    """The f32 carrier's exactness flag: True for the f32 semiring, else
    every value below 2^24."""
    if sr_name == "f32":
        return torch.ones((), dtype=torch.bool, device=dense.device)
    return _below(dense, F32_EXACT_LIMIT)


def _poison(c: SparseCSR, exact: torch.Tensor) -> SparseCSR:
    return SparseCSR(row_ptr=c.row_ptr, col_idx=c.col_idx, values=c.values,
                     nnz=torch.where(exact & (c.nnz >= 0), c.nnz, -1),
                     n_rows=c.n_rows, n_cols=c.n_cols, sr_name=c.sr_name)


def dense_acc_numeric(op: kspmm.SparseOperand, b: SparseCSR, cap: int) -> SparseCSR:
    """The device half: densify B, C = A x B_dense through the
    dense-accumulator SpMM, the exactness check and the CSR pack."""
    c = kspmm.spmm_dense_acc(op, _densify(b))
    return _poison(_dense_to_csr_lanesort(c, b.sr_name, cap), _exact_f32(c, b.sr_name))


@obs.traced("product/denseacc")
def spgemm_dense_acc(a: SparseCSR, b: SparseCSR, out_cap: Optional[int] = None) -> SparseCSR:
    """C = A x B through the dense accumulator (u64/u32 exact below 2^24,
    f32 plain float).  ``out_cap`` defaults to the next power of two of
    min(flops, n * m)."""
    _check_pair(a, b)
    op = plan_dense_acc(a)
    if out_cap is None:
        out_cap = pow2(min(symbolic_flops_exact(a, b), a.n_rows * b.n_cols))
    return dense_acc_numeric(op, b, out_cap)


def _panel_dense(op: kspmm.SparseOperand, b: SparseCSR, lo: int, w: int):
    """One dense C panel, columns [lo, lo + w): B's panel densified (no
    full B_dense ever exists) through the dense-accumulator SpMM.  No flag
    of the inputs (None): A's bound is ``plan_dense_acc``'s, the output
    bound the sweeps'."""
    return kspmm.spmm_dense_acc(op, _densify(b, lo, w)), None


def _panel_counts(panel_fn, lo: int, w: int, sr_name: str):
    """Sweep 1 in tensor ops: per-row nonzeros of one panel, and its
    exactness flag (the output bound and the inputs' flag, if any).
    ``panel_fn(lo, w)`` computes the dense panel (``_panel_dense`` or
    ``_mm_panel_dense``) and its inputs' flag or None."""
    dense, in_ok = panel_fn(lo, w)
    exact = _exact_f32(dense, sr_name)
    return torch.count_nonzero(dense, dim=1), exact if in_ok is None else exact & in_ok


def _panel_pack_merge(panel_fn, lo: int, w: int, final_row_ptr: torch.Tensor,
                      prior: torch.Tensor, dst_col: torch.Tensor, dst_limbs, sr_name: str,
                      cap_p: int) -> torch.Tensor:
    """Sweep 2 in tensor ops: recompute one dense panel, pack its nonzeros
    in row-major order and write them into the final arrays at per-row
    offsets (``final_row_ptr`` + the entries of earlier panels, ``prior``),
    in place; returns the updated ``prior``."""
    dense, _ = panel_fn(lo, w)
    counts, rows, col, limbs, valid, _ = _pack(dense, sr_name, cap_p)
    r = rows.clamp(max=dense.shape[0] - 1)
    rp = torch.cat([counts.new_zeros(1), torch.cumsum(counts, dim=0)])
    s = torch.arange(cap_p, device=dense.device)
    dest = torch.where(valid, final_row_ptr[r].long() + prior[r] + (s - rp[r]),
                       dst_col.shape[0] - 1)
    dst_col[dest] = (col + lo).int()
    for d, l in zip(dst_limbs, limbs):
        d[dest] = l
    return prior + counts


def _two_sweeps(n: int, m: int, sr_name: str, panel_cols: int, panel_fn,
                exact0: Optional[torch.Tensor], device) -> SparseCSR:
    """The column-panel sweep of the tiled routes: sweep 1 counts every
    panel and gives the exact final row offsets; sweep 2 recomputes, packs
    and merges every panel.  ``exact0``: an extra exactness flag (A's input
    bound), or None.  On a CUDA card each sweep's work on a panel is one
    hand-written kernel (``kernels/panelpack``, ``_sweeps_on_kernels``);
    on the CPU it is the tensor ops (``_sweeps_in_tensor_ops``), their plain
    version.  Under a profiler the sweeps are the spans ``tiled/count`` and
    ``tiled/pack``; every panel of each counts in ``PANELS``."""
    panels = [(lo, min(panel_cols, m - lo)) for lo in range(0, m, panel_cols)]
    sweeps = _sweeps_on_kernels if device.type == "cuda" else _sweeps_in_tensor_ops
    return sweeps(n, m, sr_name, panels, panel_fn, exact0, device)


def _sweeps_in_tensor_ops(n: int, m: int, sr_name: str, panels, panel_fn,
                          exact0: Optional[torch.Tensor], device) -> SparseCSR:
    """The two sweeps in tensor ops: the counts fetched to the host at the
    end of sweep 1, which gives the row offsets there; each panel packed by
    ``_pack`` and scattered into the product."""
    global PANELS
    counts_dev, exact_dev = [], [] if exact0 is None else [exact0]
    with obs.span("tiled/count"):
        for lo, w in panels:
            cts, ex = _panel_counts(panel_fn, lo, w, sr_name)
            counts_dev.append(cts)
            exact_dev.append(ex)
            PANELS += 1
        with obs.span("sync/panel_counts"):
            counts_all = (torch.stack(counts_dev).cpu().numpy() if counts_dev
                          else np.zeros((0, n), np.int64))
    all_exact = obs.item(torch.stack(exact_dev).all(), "panel_exact") if exact_dev else True
    nnzp = counts_all.sum(axis=1)
    total = int(nnzp.sum())
    _check_total(total)
    cap = pow2(max(total, 1))
    cap_p = pow2(max(int(nnzp.max(initial=1)), 1))
    row_ptr = np.concatenate([[0], np.cumsum(counts_all.sum(axis=0))]).astype(np.int32)
    with obs.span("tiled/pack"):
        final_row_ptr = torch.from_numpy(row_ptr).to(device)
        dst_col = torch.full((cap + 1,), INT32_SENTINEL, dtype=torch.int32, device=device)
        dst_limbs = by_name(sr_name).zeros((cap + 1,), device=device)  # slot cap: the dump
        prior = torch.zeros(n, dtype=torch.int64, device=device)
        for lo, w in panels:
            prior = _panel_pack_merge(panel_fn, lo, w, final_row_ptr, prior, dst_col,
                                      dst_limbs, sr_name, cap_p)
            PANELS += 1
    return SparseCSR(row_ptr=final_row_ptr, col_idx=dst_col[:cap],
                     values=tuple(l[:cap] for l in dst_limbs),
                     nnz=torch.tensor(total if all_exact else -1, dtype=torch.int64,
                                      device=device),
                     n_rows=n, n_cols=m, sr_name=sr_name)


def _check_total(total: int) -> None:
    if total >= 2**31:
        raise ValueError(f"{total} output entries do not fit int32 row offsets")


def _sweeps_on_kernels(n: int, m: int, sr_name: str, panels, panel_fn,
                       exact0: Optional[torch.Tensor], device) -> SparseCSR:
    """The two sweeps on the card: sweep 1 counts each panel into an int32
    (panels, n) table and ORs its exactness fault into one word
    (``panelpack.panel_count``); the offsets come from the table on the
    device, and one small read brings the per-panel totals to the host,
    which sizes the product; sweep 2 (``_pack_sweep``) writes each panel's
    entries straight into it.  The exactness flag stays on the device and
    poisons nnz there."""
    global PANELS
    table = torch.empty((len(panels), n), dtype=torch.int32, device=device)
    fault = torch.zeros((), dtype=torch.int32, device=device)
    flags = [] if exact0 is None else [exact0]
    with obs.span("tiled/count"):
        for p, (lo, w) in enumerate(panels):
            dense, in_ok = panel_fn(lo, w)
            kpanel.panel_count(dense, table, p, fault, sr_name != "f32")
            del dense  # before the next panel is computed
            if in_ok is not None:
                flags.append(in_ok)
            PANELS += 1
        exact = fault == 0
        if flags:
            exact = exact & torch.stack(flags).all()
        with obs.span("sync/panel_counts"):
            nnzp = table.sum(dim=1).tolist()
    total = sum(nnzp)
    _check_total(total)
    with obs.span("tiled/pack"):
        return _pack_sweep(n, m, sr_name, panels, panel_fn, table, nnzp, total, exact, device)


def _pack_sweep(n: int, m: int, sr_name: str, panels, panel_fn, table: torch.Tensor,
                nnzp, total: int, exact: torch.Tensor, device) -> SparseCSR:
    """Sweep 2 on the card, with no host read: the row offsets (the
    exclusive cumsum of the table's column sums) and each panel's offsets
    in its rows (the table's exclusive cumsum over the panels) on the
    device, the product allocated at pow2(total) slots, the slots past the
    total filled (column INT32_SENTINEL, limbs 0), each panel's entries
    written by ``panelpack.panel_pack``, and nnz poisoned to -1 where
    ``exact`` (a device bool) is false."""
    global PANELS
    row_ptr = torch.zeros(n + 1, dtype=torch.int32, device=device)
    row_ptr[1:] = torch.cumsum(table.sum(dim=0), dim=0)
    prior = torch.cumsum(table, dim=0, dtype=torch.int32).sub_(table)
    cap = pow2(max(total, 1))
    col = torch.empty(cap, dtype=torch.int32, device=device)
    col[total:] = INT32_SENTINEL
    limbs = tuple(torch.empty(cap, dtype=d, device=device) for d in kpanel.LIMB_DTYPES[sr_name])
    for l in limbs:
        l[total:] = 0
    for p, (lo, w) in enumerate(panels):
        dense, _ = panel_fn(lo, w)
        kpanel.panel_pack(dense, lo, row_ptr, prior, p, col, limbs, sr_name, nnzp[p])
        del dense
        PANELS += 1
    return SparseCSR(row_ptr=row_ptr, col_idx=col, values=limbs,
                     nnz=torch.where(exact, total, -1), n_rows=n, n_cols=m, sr_name=sr_name)


@obs.traced("product/denseacc_tiled")
def spgemm_dense_acc_tiled(a: SparseCSR, b: SparseCSR, panel_cols: int = 8192) -> SparseCSR:
    """C = A x B through column-panel sweeps of the dense accumulator: only
    one (k, panel_cols) B panel and one (n, panel_cols) C panel live at a
    time.  Sweep 1 runs the SpMM on each panel and keeps its per-row counts,
    which give the exact final row offsets; sweep 2 recomputes each panel
    and merges it in place.  u64/u32 exact while every output value < 2^24
    (checked per panel; a violation poisons nnz to -1); f32 is plain float,
    summed in the kernel's order."""
    _check_pair(a, b)
    _check_panel_cols(panel_cols)
    op = plan_dense_acc(a)
    return _two_sweeps(a.n_rows, b.n_cols, a.sr_name, panel_cols,
                       lambda lo, w: _panel_dense(op, b, lo, w), None, a.device)


def _check_tf32() -> None:
    if kspmm.tf32_enabled():
        raise RuntimeError("the dense-dense route needs full fp32 products: TF32 is "
                           "enabled (torch.backends.cuda.matmul.allow_tf32 or "
                           "torch.set_float32_matmul_precision)")


def densedense_numeric(a: SparseCSR, b: SparseCSR, cap: int) -> SparseCSR:
    """C = A x B as one fp32 matrix product of the densified operands and
    the pack.  Integer semirings: inputs < 2^16 and outputs < 2^24, checked
    on the device (a violation poisons nnz to -1).  The f32 semiring keeps
    the cells whose value is nonzero, so terms that cancel to 0 drop out of
    the pattern (the sort-based routes keep them)."""
    _check_tf32()
    ad, bd = _densify(a), _densify(b)
    dense = ad @ bd
    if a.sr_name == "f32":
        exact = torch.ones((), dtype=torch.bool, device=dense.device)
    else:
        exact = _below(ad, IN_LIMIT_F32) & _below(bd, IN_LIMIT_F32) & \
            _below(dense, F32_EXACT_LIMIT)
    return _poison(_dense_to_csr_lanesort(dense, a.sr_name, cap), exact)


def _densify_i(x: SparseCSR):
    """x's lo limbs as a dense fp64 (n_rows, n_cols) carrier, and whether
    every valid value is below 2^31 with a zero u64 hi limb."""
    valid = torch.arange(x.capacity, device=x.device) < x.nnz
    lo = torch.where(valid, x.values[0], 0)
    d = torch.zeros(x.n_rows * x.n_cols + 1, dtype=torch.float64, device=x.device)
    flat = torch.where(valid, x.row_of_slot() * x.n_cols + x.col_idx.long(),
                       x.n_rows * x.n_cols)
    d[flat] = lo.double()
    ok = _below(lo, float(1 << 31))
    if x.sr_name == "u64":
        ok = ok & (torch.where(valid, x.values[1], 0) == 0).all()
    return d[:-1].view(x.n_rows, x.n_cols), ok


def densedense_numeric_i32(a: SparseCSR, b: SparseCSR, cap: int) -> SparseCSR:
    """The wide integer tier: outputs < 2^30 (64x the f32 tier's window;
    inputs may exceed 2^16).  One fp64 product, exact for every product the
    tier keeps, with JAX's f32 magnitude companion: its estimate < 2^30
    certifies every partial sum < 2^31 (sums of non-negative terms are
    monotone).  Input validity (values < 2^31, u64 hi limbs zero) is
    checked from the limbs on the device."""
    if a.sr_name not in ("u32", "u64"):
        raise ValueError(f"the wide tier is for u32/u64, not {a.sr_name}")
    _check_tf32()
    ad, ok_a = _densify_i(a)
    bd, ok_b = _densify_i(b)
    est = ad.float() @ bd.float()
    dense = ad @ bd
    exact = ok_a & ok_b & _below(est, WIDE_LIMIT)
    return _poison(_dense_to_csr_lanesort(dense, a.sr_name, cap), exact)


def densedense_fits(n: int, k: int, m: int, budget_bytes: float = 6e9) -> bool:
    """Whether the dense-dense route's peak footprint (A, B, C and the pack's
    two copies of C, all f32, as JAX models it) fits the memory budget."""
    return 4.0 * (n * k + k * m + 3 * n * m) <= budget_bytes


@obs.traced("product/densedense")
def spgemm_dense_dense(a: SparseCSR, b: SparseCSR, out_cap: Optional[int] = None,
                       wide: bool = False) -> SparseCSR:
    """C = A x B through the fully dense route (``densedense_numeric``);
    ``wide``: the integer tier (``densedense_numeric_i32``), outputs < 2^30."""
    _check_pair(a, b)
    if out_cap is None:
        out_cap = pow2(min(symbolic_flops_exact(a, b), a.n_rows * b.n_cols))
    if wide:
        return densedense_numeric_i32(a, b, out_cap)
    return densedense_numeric(a, b, out_cap)


def _mm_panel_dense(ad: torch.Tensor, b: SparseCSR, lo: int, w: int):
    """B's columns [lo, lo + w) densified and multiplied by the densified A
    in fp32; the dense C panel and, on an integer semiring, B's panel's
    input bound (A's is checked once by the caller, the output bound by the
    sweeps), else None."""
    panel = _densify(b, lo, w)
    dense = ad @ panel
    if b.sr_name == "f32":
        return dense, None
    return dense, _below(panel, IN_LIMIT_F32)


def densedense_tiled_panel_cols(n: int, k: int, budget_bytes: float = 6e9) -> int:
    """Widest B/C column panel (a multiple of 1024, at most 8192) such that
    A_dense (n, k) and ~4 live (max(n, k), w) f32 panels fit the budget; 0
    when A_dense alone does not fit (JAX's arithmetic, unchanged)."""
    rest = budget_bytes - 4.0 * n * k
    if rest <= 0:
        return 0
    w = int(rest // (16 * max(n, k, 1))) // 1024 * 1024
    return min(w, 8192)


@obs.traced("product/densedense_tiled")
def spgemm_dense_dense_tiled(a: SparseCSR, b: SparseCSR, panel_cols: int = 8192) -> SparseCSR:
    """C = A x B: A densified once, B/C column panels swept through fp32
    products, with the two sweeps of ``spgemm_dense_acc_tiled``.  Exactness
    as the f32 tier: inputs < 2^16 and every panel's outputs < 2^24,
    checked on the device, poisoning nnz."""
    _check_pair(a, b)
    _check_panel_cols(panel_cols)
    _check_tf32()
    ad = _densify(a)
    a_ok = None if a.sr_name == "f32" else _below(ad, IN_LIMIT_F32)
    return _two_sweeps(a.n_rows, b.n_cols, a.sr_name, panel_cols,
                       lambda lo, w: _mm_panel_dense(ad, b, lo, w), a_ok, a.device)
