"""Runtime einsum engine over mixed dense/sparse semiring operands: the port
of ``sparsetpu/einsum/engine.py``.

The engine is a planner.  It classifies the spec and the operands' kinds
and lowers to the first tier that takes them, in the JAX engine's order:

  grouped      ``bij,bjk->bik`` on two ``GroupedCSR``: one block-diagonal
               ESC SpGEMM (``grouped.py``);
  SpMM         two operands, one sparse and one dense, matmul or matvec
               shaped: ``ops/spmm.py`` (f32: gather and ``index_add_``;
               u32/u64: exact limb sums);
  chain        matmul-shaped specs over N >= 2 two-dimensional operands, one
               of them sparse: greedy pairwise ``spgemm_auto``, the
               intermediates kept as CSR;
  entry-driven one sparse operand drives any spec (f32), or every operand is
               sparse (u32/u64): per-entry gathers, scatter-adds;
  dense        every operand dense on f32: one fp32 ``torch.einsum``;
  fallback     the densified loop nest, exact on every semiring, under a
               joint-space guard; past it ``InvalidSpec("Unsupported")``.

Operands: dense tensors or numpy arrays (an f32 array, or a tuple of the
semiring's limbs; a one-limb semiring also takes a plain array),
``SparseCSR`` (2-D) or ``GroupedCSR`` (3-D).  Outputs are dense (one tensor
for a one-limb semiring, else a limb tuple) or, with
``out_format="sparse"``, a ``SparseCSR`` per 2-D output.  Tensors are built
on ``device``: by default that of the operands' tensors, else the card.

Differences from the JAX package, none of them in a result:

- JAX's jit-compiled tiers run as eager torch operations.
- Integer limbs are uint32 values carried in int64 (``semiring.py``).  A
  dense integer operand keeps its low 32 bits, as ``jnp.asarray`` narrows a
  uint64 array with x64 off.
- JAX sums 16-bit planes; the port sums whole limbs in int64 and
  recombines with saturation (``ops/segments._recombine``), equal since a
  saturating fold of non-negative values is min(true sum, MAX).  The
  entry-driven tier's ``exact_ok`` is still computed as JAX computes it
  (every output cell below 2^16 - 1 entries), and the SpMM tier keeps
  JAX's row window (a row of 2^16 - 1 entries declines it), so the same
  specs fall back.
- f32 scatter-adds are ``index_put_(accumulate=True)``: on the card their
  atomics vary the order of a sum from run to run.  Integer-valued f32
  stays exact; other values agree to float32 rounding.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..csr import DEFAULT_DEVICE, SparseCSR, resolve_device
from ..grouped import GroupedCSR
from ..kernels.spmm import tf32_enabled
from ..ops import segments
from ..ops import spgemm as spgemm_ops
from ..ops import spmm as spmm_ops
from ..semiring import F32SR, MASK32, Semiring, Value
from .parser import EinsumSpec, InvalidSpec, parse_spec, validate_dims

Operand = Union[torch.Tensor, np.ndarray, tuple, SparseCSR, GroupedCSR]

# joint-index-space guard for the general fallback (elements)
FALLBACK_MAX_ELEMS = 1 << 22
# joint guard for the entry-driven tier: capacity x (unbound letter space)
ENTRY_DRIVEN_MAX_ELEMS = 1 << 26
# the spec letter of the entry axis in the entry-driven tier's einsum (the
# engine's specs use lowercase letters only)
_ENTRY = "Z"


def _device_of(operands, device) -> torch.device:
    """``device`` if given, else the device of the first operand that has
    one, else the card."""
    if device is not None:
        return resolve_device(device)
    for op in operands:
        if isinstance(op, (SparseCSR, GroupedCSR, torch.Tensor)):
            return op.device
        if isinstance(op, tuple) and op and isinstance(op[0], torch.Tensor):
            return op[0].device
    return resolve_device(DEFAULT_DEVICE)


def _limb(x, sr: Semiring, device) -> torch.Tensor:
    """A dense array as a tensor of the semiring's limb type on ``device``:
    float32 for f32; for u32/u64 int64 holding the low 32 bits of an integer
    array (a float array truncates)."""
    if not isinstance(x, torch.Tensor):
        a = np.asarray(x)
        if sr.dtype == torch.float32:
            a = a.astype(np.float32)
        elif a.dtype.kind in "uib":  # torch's unsigned types are thin: widen first
            a = (a.astype(np.uint64) & np.uint64(MASK32)).astype(np.int64)
        x = torch.from_numpy(np.ascontiguousarray(a))
    x = x.to(device)
    if sr.dtype == torch.float32:
        return x.float()
    return x.long() if x.is_floating_point() else x.long() & MASK32


def _operand_info(op: Operand, sr: Semiring, device):
    """Returns (kind, shape, limbs) with kind in {dense, sparse, grouped}."""
    if isinstance(op, GroupedCSR):
        return "grouped", op.shape, None
    if isinstance(op, SparseCSR):
        return "sparse", op.shape, None
    if isinstance(op, tuple):
        limbs = tuple(_limb(l, sr, device) for l in op)
        return "dense", tuple(limbs[0].shape), limbs
    if sr.nlimbs == 1:
        arr = _limb(op, sr, device)
        return "dense", tuple(arr.shape), (arr,)
    raise TypeError(f"dense operand for {sr.name} must be a {sr.nlimbs}-limb tuple")


def einsum(spec: str, operands: Sequence[Operand], sr: Semiring = F32SR,
           out_format: str = "dense", device=None):
    """Evaluate ``spec`` over ``operands`` on semiring ``sr``; returns one
    result per output of the spec.

    ``out_format="dense"`` (default) returns dense outputs (a tensor for
    one-limb semirings, else a limb tuple).  ``out_format="sparse"``
    returns a ``SparseCSR`` per 2-D output: when the plan lowers to the
    sparse chain the result is never densified.  (JAX's ``out_caps``
    argument, which its engine never reads, is not ported.)"""
    if out_format not in ("dense", "sparse"):
        raise ValueError(f"out_format must be dense|sparse, got {out_format}")
    parsed = parse_spec(spec)
    device = _device_of(operands, device)
    infos = [_operand_info(op, sr, device) for op in operands]
    dims = validate_dims(parsed, [i[1] for i in infos])

    # single-pass multi-output: an output that permutes an earlier one's
    # axes reuses its contraction (the sibling is a transpose)
    results: List = [None] * len(parsed.outputs)
    computed: List[Tuple[Tuple[str, ...], object]] = []
    for oi, out in enumerate(parsed.outputs):
        reused = None
        if len(set(out)) == len(out):
            for prev_out, prev_res in computed:
                if prev_out == out:
                    reused = prev_res
                    break
                if len(set(prev_out)) == len(prev_out) and set(prev_out) == set(out):
                    reused = _permute_result(prev_res, prev_out, out, out_format)
                    break
        if reused is not None:
            results[oi] = reused
            continue
        res = _einsum_single(parsed, out, operands, infos, dims, sr, out_format)
        computed.append((out, res))
        results[oi] = res
    return results


def _permute_result(res, src: Tuple[str, ...], dst: Tuple[str, ...], out_format: str):
    """Reorder a computed output's axes from ``src`` letter order to the
    permutation ``dst``."""
    perm = tuple(src.index(ch) for ch in dst)
    if out_format == "sparse":
        if len(src) != 2 or perm != (1, 0):
            raise ValueError(f"a sparse output permutes only (1, 0): {src} -> {dst}")
        return _transpose_jit(res)
    limbs = res if isinstance(res, tuple) else (res,)
    limbs = tuple(l.permute(perm) for l in limbs)
    return limbs if isinstance(res, tuple) else limbs[0]


def _einsum_single(parsed: EinsumSpec, out: Tuple[str, ...], operands, infos,
                   dims: Dict[str, int], sr: Semiring, out_format: str):
    lowered = _try_grouped_matmul(parsed, out, operands, infos, dims, sr)
    if lowered is not None:
        return lowered
    lowered = _try_spmm(parsed, out, operands, infos, dims, sr, out_format)
    if lowered is not None:
        return lowered
    lowered = _try_sparse_chain(parsed, out, operands, infos, dims, sr, out_format)
    if lowered is not None:
        return lowered
    lowered = _try_entry_driven(parsed, out, operands, infos, dims, sr, out_format)
    if lowered is not None:
        return lowered
    if sr.name == "f32" and all(i[0] == "dense" for i in infos):
        arrs = [i[2][0] for i in infos]
        sub = ",".join("".join(i) for i in parsed.inputs) + "->" + "".join(out)
        return _pack_output(_dense_exec(sub, *arrs), out, dims, sr, out_format)
    dense = _fallback_loop_nest(parsed, out, operands, infos, dims, sr)
    return _pack_output(dense, out, dims, sr, out_format)


def _einsum_f32(sub: str, *arrs) -> torch.Tensor:
    """One fp32 ``torch.einsum``; raises on the card while TF32 is enabled,
    which would round the products to about three digits."""
    if arrs[0].device.type == "cuda" and tf32_enabled():
        raise RuntimeError("the einsum engine needs full fp32 products: TF32 is enabled "
                           "(torch.backends.cuda.matmul.allow_tf32 or "
                           "torch.set_float32_matmul_precision)")
    return torch.einsum(sub, *arrs)


def _dense_exec(sub: str, *arrs) -> torch.Tensor:
    """The all-dense tier: one fp32 einsum (a library product: the JAX
    engine computes it outside any Pallas kernel)."""
    return _einsum_f32(sub, *(a.float() for a in arrs))


def _pack_output(dense, out, dims, sr: Semiring, out_format: str):
    """Convert a dense result to the requested output format."""
    if out_format == "dense":
        return dense
    if len(out) != 2:
        raise InvalidSpec("Unsupported",
                          f"sparse output requires a 2-D output, got {len(out)} axes")
    limbs = dense if isinstance(dense, tuple) else (dense,)
    return SparseCSR.from_dense_device(limbs, sr)


# ---------------------------------------------------------------------------
# sparse x dense matmul / matvec -> SpMM (dense result)
# ---------------------------------------------------------------------------

def _try_spmm(parsed, out, operands, infos, dims, sr, out_format: str):
    """Two-operand sparse x dense contractions (``ab,bc->ac``, ``ab,cb->ac``,
    ``ba,bc->ac``, SpMV ``ab,b->a`` / ``b,ab->a`` and their transposes)
    lowered to ``ops/spmm.py``: f32 to ``spmm_csr_dense``, u32/u64 to the
    exact ``spmm_csr_dense_exact`` while the sparse operand's rows hold
    fewer than 2^16 - 1 entries (JAX's plane window; past it the spec goes
    on to the next tier, as in JAX)."""
    if len(parsed.inputs) != 2:
        return None
    kinds = [infos[0][0], infos[1][0]]
    if sorted(kinds) != ["dense", "sparse"]:
        return None
    si = kinds.index("sparse")
    di = 1 - si
    s_ix, d_ix = parsed.inputs[si], parsed.inputs[di]
    if len(s_ix) != 2 or len(set(s_ix)) != 2:
        return None
    if len(d_ix) not in (1, 2) or len(set(d_ix)) != len(d_ix):
        return None
    shared = set(s_ix) & set(d_ix)
    if len(shared) != 1:
        return None
    k = shared.pop()
    if k in out:
        return None
    s_free = s_ix[0] if s_ix[1] == k else s_ix[1]
    d_free = None
    if len(d_ix) == 2:
        d_free = d_ix[0] if d_ix[1] == k else d_ix[1]
    expected = tuple(x for x in (s_free, d_free) if x is not None)
    if len(out) != len(expected) or set(out) != set(expected):
        return None

    s = operands[si]
    t_s = s_ix[0] == k
    t_d = len(d_ix) == 2 and d_ix[0] != k
    t_out = len(out) == 2 and out == (d_free, s_free)
    if sr.name == "f32":
        result = _spmm_exec(s, infos[di][2][0], t_s=t_s, t_d=t_d, t_out=t_out)
    else:
        s_eff = _transpose_jit(s) if t_s else s
        if int(s_eff.row_nnz().max()) >= 0xFFFF:
            return None
        result, _ = _spmm_exact_exec(s_eff, infos[di][2], t_d=t_d, t_out=t_out)
        if sr.nlimbs == 1:
            result = result[0]
    return _pack_output(result, out, dims, sr, out_format)


def _spmm_exec(s: SparseCSR, d: torch.Tensor, t_s: bool, t_d: bool, t_out: bool):
    if t_s:  # contraction along the sparse rows
        s = s.transpose()
    if t_d:  # contraction along the dense columns
        d = d.T
    result = spmm_ops.spmm_csr_dense(s, d.float())
    return result.T if t_out else result


def _spmm_exact_exec(s: SparseCSR, d_limbs, t_d: bool, t_out: bool):
    if d_limbs[0].dim() == 1:
        out, ok = spmm_ops.spmm_csr_dense_exact(s, tuple(l[:, None] for l in d_limbs))
        return tuple(l[:, 0] for l in out), ok
    if t_d:
        d_limbs = tuple(l.T for l in d_limbs)
    out, ok = spmm_ops.spmm_csr_dense_exact(s, d_limbs)
    if t_out:
        out = tuple(l.T for l in out)
    return out, ok


# ---------------------------------------------------------------------------
# batched (compound-row) sparse matmul: "bij,bjk->bik"
# ---------------------------------------------------------------------------

def _try_grouped_matmul(parsed, out, operands, infos, dims, sr):
    """Batched sparse matmul on two GroupedCSR operands, lowered to one
    block-diagonal SpGEMM.  The result is dense whatever ``out_format``
    asks (a 3-D output has no CSR form), as in JAX."""
    if len(parsed.inputs) != 2 or len(out) != 3:
        return None
    a_ix, b_ix = parsed.inputs
    if len(a_ix) != 3 or len(b_ix) != 3:
        return None
    if not (isinstance(operands[0], GroupedCSR) and isinstance(operands[1], GroupedCSR)):
        return None
    if a_ix[0] != b_ix[0] or a_ix[0] != out[0]:
        return None
    if a_ix[2] != b_ix[1] or (a_ix[1], b_ix[2]) != (out[1], out[2]):
        return None
    if len({a_ix[0], a_ix[1], a_ix[2], b_ix[2]}) != 4:
        return None
    dense = _grouped_to_dense(operands[0].matmul(operands[1]))
    return dense if sr.nlimbs > 1 else dense[0]


def _grouped_to_dense(c: GroupedCSR) -> tuple:
    """GroupedCSR -> (g, n, m) dense limb tuple by an nnz-sized scatter of
    each batch's diagonal block (never the (g * n, g * m) square)."""
    flat = c.flat
    g, n, m = c.g, c.n, c.m
    valid = torch.arange(flat.capacity, device=flat.device) < flat.nnz
    row = flat.row_of_slot()
    b = row // n
    ci = flat.col_idx.long() - b * m
    ok = valid & (ci >= 0) & (ci < m)
    idx = (b[ok], row[ok] % n, ci[ok])
    return tuple(torch.zeros((g, n, m), dtype=l.dtype, device=flat.device)
                 .index_put_(idx, l[ok], accumulate=True) for l in flat.values)


# ---------------------------------------------------------------------------
# the matmul-chain planner (N >= 2 two-dimensional operands)
# ---------------------------------------------------------------------------

def _try_sparse_chain(parsed, out, operands, infos, dims, sr, out_format: str = "dense"):
    """Greedy pairwise-contraction planner for matmul-shaped specs over any
    number of 2-D operands (``ab,bc->ac``, ``ab,bc,cd->ad``, transposed
    variants): contract two operands that share exactly one letter found
    nowhere else, preferring an orientation that needs no transpose, keep
    the product as CSR (``spgemm_auto`` routes it), repeat until one
    operand is left."""
    if len(out) != 2 or len(set(out)) != 2:
        return None
    if any(len(ix) != 2 or len(set(ix)) != 2 for ix in parsed.inputs):
        return None
    if len(parsed.inputs) < 2 or not any(i[0] == "sparse" for i in infos):
        return None

    # each contracted letter appears in exactly 2 inputs, each output letter
    # in exactly 1
    occ: Dict[str, int] = {}
    for ix in parsed.inputs:
        for ch in ix:
            occ[ch] = occ.get(ch, 0) + 1
    for ch, cnt in occ.items():
        if ch in out and cnt != 1:
            return None
        if ch not in out and cnt != 2:
            return None
    if any(ch not in occ for ch in out):
        return None

    items = [[tuple(ix), op, info, None]  # letters, operand, info, CSR cache
             for ix, op, info in zip(parsed.inputs, operands, infos)]

    def as_csr(item, transpose: bool) -> SparseCSR:
        if item[3] is None:
            item[3] = (item[1] if isinstance(item[1], SparseCSR)
                       else _as_csr(item[1], item[2], sr, transpose=False))
        return _transpose_jit(item[3]) if transpose else item[3]

    while len(items) > 1:
        found = None       # the first contractible pair (may need transposes)
        found_free = None  # the first transpose-free orientation, preferred
        for ia in range(len(items)):
            for ib in range(ia + 1, len(items)):
                shared = set(items[ia][0]) & set(items[ib][0])
                if len(shared) != 1:
                    continue
                k = next(iter(shared))
                if k in out:
                    continue
                a_l, b_l = items[ia][0], items[ib][0]
                x = a_l[0] if a_l[1] == k else a_l[1]
                y = b_l[0] if b_l[1] == k else b_l[1]
                if x == y:
                    continue
                if a_l[1] == k and b_l[0] == k:
                    found_free = (ia, ib, k, x, y)   # a @ b as it is
                elif b_l[1] == k and a_l[0] == k:
                    found_free = (ib, ia, k, y, x)   # b @ a as it is
                elif found is None:
                    found = (ia, ib, k, x, y)        # needs transposes
                if found_free:
                    break
            if found_free:
                break
        found = found_free or found
        if not found:
            return None
        ia, ib, k, x, y = found
        a = as_csr(items[ia], transpose=items[ia][0][0] == k)
        b = as_csr(items[ib], transpose=items[ib][0][1] == k)
        c = spgemm_ops.spgemm_auto(a, b)
        new_item = [(x, y), c, ("sparse", c.shape, None), c]
        items = [it for j, it in enumerate(items) if j not in (ia, ib)]
        items.append(new_item)

    letters = items[0][0]
    c = as_csr(items[0], transpose=False)
    if letters == tuple(out)[::-1]:
        c = _transpose_jit(c)
    elif letters != tuple(out):
        return None
    if out_format == "sparse":
        return c
    dense = c.to_dense()
    return dense if sr.nlimbs > 1 else dense[0]


def _transpose_jit(s: SparseCSR) -> SparseCSR:
    """The device transpose (named as the JAX engine's jitted one; eager here)."""
    return s.transpose()


def _as_csr(op, info, sr: Semiring, transpose: bool) -> SparseCSR:
    if isinstance(op, SparseCSR):
        return op.transpose() if transpose else op
    limbs = info[2]
    if transpose:
        limbs = tuple(l.T for l in limbs)
    return SparseCSR.from_dense_device(limbs, sr)


# ---------------------------------------------------------------------------
# entry-driven lowering: ANY spec with one driving sparse operand
# ---------------------------------------------------------------------------

def _try_entry_driven(parsed, out, operands, infos, dims, sr, out_format: str):
    """The sparse-driven schedule: iterate the first sparse operand's
    entries, evaluate the dense sub-contraction per entry (gathers bind the
    sparse letters) and scatter-add into the output.  Covers traces
    (``aa->``), reductions (``ab->a``), masks (``ab,ab->ab``), N-D dense
    partners (``ab,bcd->acd``) and free-letter products (``ab,ac->abc``).
    Further sparse operands join when the driving one binds all their letters,
    each read by a per-entry ``lookup``; a 3-D GroupedCSR may drive, its
    flat entries binding (batch, row, col).  u32/u64 take this tier only
    when every operand is sparse: exact products, outputs summed exactly
    (``_entry_driven_exact_exec``)."""
    sparse_pos = [i for i, inf in enumerate(infos) if inf[0] in ("sparse", "grouped")]
    if not sparse_pos:
        return None
    if sr.name != "f32" and len(sparse_pos) != len(infos):
        return None
    si = sparse_pos[0]
    s_ix = parsed.inputs[si]
    s = operands[si]
    if isinstance(s, GroupedCSR):
        if len(s_ix) != 3 or len(set(s_ix)) != 3:
            return None
        drv = ("grouped", tuple(s_ix), s.n, s.m)
        s_flat = s.flat
        bound = set(s_ix)
    else:
        if len(s_ix) != 2:
            return None
        p, q = s_ix
        drv = ("csr", (p, q))
        s_flat = s
        bound = {p} if p == q else {p, q}

    # further sparse operands: the driving one binds every letter of each
    extra_flats: List[SparseCSR] = []
    extra = []
    for j in sparse_pos[1:]:
        ix = parsed.inputs[j]
        o = operands[j]
        if not set(ix) <= bound:
            return None
        if isinstance(o, GroupedCSR):
            if len(ix) != 3:
                return None
            extra_flats.append(o.flat)
            extra.append(("grouped", tuple(ix), o.n, o.m))
        else:
            if len(ix) != 2:
                return None
            extra_flats.append(o)
            extra.append(("csr", tuple(ix)))

    rest = set(sparse_pos)
    dense_ixs = tuple(tuple(ix) for j, ix in enumerate(parsed.inputs) if j not in rest)
    dense_arrs = [infos[j][2][0] for j in range(len(operands)) if j not in rest]
    # repeated letters inside a dense operand (diagonals): the fallback's
    if any(len(set(ix)) != len(ix) for ix in dense_ixs):
        return None

    unbound = [ch for ch in parsed.slots if ch not in bound]
    work = s_flat.capacity * int(np.prod([dims[ch] for ch in unbound]) or 1)
    if work > ENTRY_DRIVEN_MAX_ELEMS:
        return None

    if sr.name != "f32":
        result, ok = _entry_driven_exact_exec(s_flat, tuple(extra_flats), drv=drv,
                                              extra=tuple(extra), out=tuple(out),
                                              dims=dims, sr=sr)
        # an output cell past the plane window (>= 2^16 - 1 entries): the
        # exact loop nest, as in JAX
        if not bool(ok):
            return None
        if sr.nlimbs == 1:
            result = result[0]
        return _pack_output(result, out, dims, sr, out_format)

    result = _entry_driven_exec(s_flat, tuple(dense_arrs), tuple(extra_flats), drv=drv,
                                dense_ixs=dense_ixs, extra=tuple(extra), out=tuple(out),
                                dims=dims)
    return _pack_output(result, out, dims, sr, out_format)


def _entry_letters(s: SparseCSR, drv):
    """(valid slots, {letter: int64 index of each slot}) of the driving
    operand; invalid slots index 0.  A driving CSR with one letter twice
    (``aa``) keeps only its diagonal entries."""
    valid = torch.arange(s.capacity, device=s.device) < s.nnz
    r = s.row_of_slot()
    c = s.col_idx.long()
    if drv[0] == "grouped":
        _, (lb, li, lj), n, m = drv
        b = torch.where(valid, r // n, 0)
        return valid, {lb: b, li: torch.where(valid, r % n, 0),
                       lj: torch.where(valid, c - b * m, 0)}
    p, q = drv[1]
    if p == q:
        valid = valid & (r == c)
    letter_val = {p: torch.where(valid, r, 0)}
    if p != q:
        letter_val[q] = torch.where(valid, c, 0)
    return valid, letter_val


def _extra_values(extra_flats, extra, letter_val):
    """Each further sparse operand's value at every driving entry (a lookup)."""
    for s2, e in zip(extra_flats, extra):
        if e[0] == "grouped":
            _, (xb, xi, xj), n2, m2 = e
            yield s2.lookup(letter_val[xb] * n2 + letter_val[xi],
                            letter_val[xb] * m2 + letter_val[xj])
        else:
            ix = e[1]
            yield s2.lookup(letter_val[ix[0]], letter_val[ix[1]])


def _entry_driven_exec(s: SparseCSR, dense_arrs, extra_flats, drv, dense_ixs, extra, out,
                       dims) -> torch.Tensor:
    """The f32 entry-driven tier.  Where JAX maps a per-entry einsum over the
    entries (``jax.vmap``), each dense operand's bound axes are gathered by
    the entries' letter values, giving a leading entry axis, and one einsum
    runs with that axis as a batch letter."""
    cap = s.capacity
    valid, letter_val = _entry_letters(s, drv)
    v = torch.where(valid, s.values[0].float(), 0.0)
    for v2 in _extra_values(extra_flats, extra, letter_val):
        v = v * v2[0].float()
    bound = set(letter_val)

    out_s = tuple(ch for ch in out if ch in bound)
    out_d = tuple(ch for ch in out if ch not in bound)
    if dense_arrs:
        specs, ops = [], []
        for ix, arr in zip(dense_ixs, dense_arrs):
            b_axes = [k for k, ch in enumerate(ix) if ch in bound]
            free = "".join(ch for ch in ix if ch not in bound)
            if b_axes:
                rest = [k for k in range(len(ix)) if k not in b_axes]
                arr = arr.float().permute(b_axes + rest)[
                    tuple(letter_val[ix[k]] for k in b_axes)]
                free = _ENTRY + free
            specs.append(free)
            ops.append(arr.float())
        batched = any(sp.startswith(_ENTRY) for sp in specs)
        sub = ",".join(specs) + "->" + (_ENTRY if batched else "") + "".join(out_d)
        contrib = _einsum_f32(sub, *ops)
        if not batched:  # no dense operand reads a bound letter
            contrib = contrib.expand((cap,) + tuple(contrib.shape))
        contrib = v.reshape((cap,) + (1,) * (contrib.dim() - 1)) * contrib
    else:
        contrib = v.reshape((cap,) + (1,) * len(out_d)).expand(
            (cap,) + tuple(dims[ch] for ch in out_d))

    if out_s:
        res0 = torch.zeros(tuple(dims[ch] for ch in out_s + out_d), dtype=torch.float32,
                           device=v.device)
        idx = tuple(letter_val[ch][valid] for ch in out_s)
        res0.index_put_(idx, contrib[valid], accumulate=True)
    else:
        res0 = contrib.sum(0)
    # reorder (out_s ++ out_d) axes into the requested output order
    order0 = out_s + out_d
    perm = tuple(order0.index(ch) for ch in out)
    return res0.permute(perm) if perm != tuple(range(len(out))) else res0


def _entry_driven_exact_exec(s: SparseCSR, extra_flats, drv, extra, out, dims,
                             sr: Semiring):
    """The exact integer entry-driven tier (no dense operands): per-entry
    saturating products, outputs summed as whole int64 limbs and
    recombined with saturation.  Returns (limbs, exact_ok), ``exact_ok``
    computed as JAX's: True for a scalar output, else every output cell
    receives fewer than 2^16 - 1 entries."""
    valid, letter_val = _entry_letters(s, drv)
    v = sr.where(valid, s.values, sr.zeros((s.capacity,), device=s.device))
    for v2 in _extra_values(extra_flats, extra, letter_val):
        v = sr.mul(v, v2)

    if out:  # the driving operand binds every letter here
        shape = tuple(dims[ch] for ch in out)
        idx = tuple(letter_val[ch][valid] for ch in out)

        def scatter(x):
            return torch.zeros(shape, dtype=torch.int64, device=s.device).index_put_(
                idx, x[valid], accumulate=True)

        counts = scatter(torch.ones_like(valid, dtype=torch.int64))
        return segments._recombine(sr, [scatter(l) for l in v]), counts.max() < 0xFFFF
    # a scalar: the whole sum at once, equal to JAX's saturating fold over
    # chunk totals (both are min(true sum, MAX))
    sums = [torch.where(valid, l, 0).sum() for l in v]
    return segments._recombine(sr, sums), torch.ones((), dtype=torch.bool, device=s.device)


# ---------------------------------------------------------------------------
# the general loop-nest fallback (exact, any semiring, any spec)
# ---------------------------------------------------------------------------

def _densify(op, info, sr: Semiring):
    if isinstance(op, GroupedCSR):
        return _grouped_to_dense(op)
    if isinstance(op, SparseCSR):
        return op.to_dense()
    return info[2]


def _fallback_loop_nest(parsed, out, operands, infos, dims, sr: Semiring):
    """Broadcast every operand into the joint index space (free ++
    contracted), multiply on the semiring, then reduce the contracted axes.
    JAX folds them with saturating adds one element at a time; here u32/u64
    sum whole limbs in int64 (below 2^32 x 2^22 < 2^63) recombined with
    saturation, the same min(true sum, MAX), and f32 is one ``torch.sum``
    (bit-equal on integer values; other values agree to float32 rounding)."""
    letters = list(out) + [ch for ch in parsed.slots if ch not in out]
    joint_shape = tuple(dims[ch] for ch in letters)
    n_elems = int(np.prod(joint_shape)) if joint_shape else 1
    if n_elems > FALLBACK_MAX_ELEMS:
        raise InvalidSpec("Unsupported",
                          f"no kernel for spec {parsed.canonical()!r} and joint space "
                          f"{n_elems} exceeds the fallback guard")

    prod: Optional[Value] = None
    for op, info, inp in zip(operands, infos, parsed.inputs):
        expanded = _broadcast_to_joint(_densify(op, info, sr), inp, letters, dims)
        prod = expanded if prod is None else sr.mul(prod, expanded)

    n_free = len(out)
    contracted_size = int(np.prod(joint_shape[n_free:])) if letters[n_free:] else 1
    flat = tuple(l.reshape(joint_shape[:n_free] + (contracted_size,)) for l in prod)
    if contracted_size == 1:
        total = tuple(l[..., 0] for l in flat)
    elif sr.name == "f32":
        total = (flat[0].sum(-1),)
    else:
        total = segments._recombine(sr, [l.sum(-1) for l in flat])
    return total if sr.nlimbs > 1 else total[0]


def _broadcast_to_joint(limbs: Value, inp: Tuple[str, ...], letters: List[str],
                        dims: Dict[str, int]) -> Value:
    """Extract diagonals for repeated letters, then broadcast to the joint space."""
    uniq: List[str] = []
    for ch in inp:
        if ch not in uniq:
            uniq.append(ch)
    device = limbs[0].device
    if len(uniq) != len(inp):
        # take diagonals: index each axis by the unique letters' index grids
        grids = torch.meshgrid(*[torch.arange(dims[ch], device=device) for ch in uniq],
                               indexing="ij")
        index = tuple(grids[uniq.index(ch)] for ch in inp)
        limbs = tuple(l[index] for l in limbs)
    # limbs now have axes uniq; move them into the joint layout
    order = tuple(int(i) for i in np.argsort([letters.index(ch) for ch in uniq]))
    shape = [1] * len(letters)
    for ch in uniq:
        shape[letters.index(ch)] = dims[ch]
    out = []
    for l in limbs:
        lr = l.reshape([dims[ch] for ch in uniq])
        lr = lr.permute(order) if len(uniq) > 1 else lr
        out.append(lr.reshape(shape).expand([dims[ch] for ch in letters]))
    return tuple(out)
