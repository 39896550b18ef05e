"""ESC SpGEMM's expansion and merge on the exact integer semirings, as
hand-written CUDA kernels (``csrc/esc_products.cu``).

C = A x B by expand-sort-compress, as ``ops/spgemm.spgemm_reference``
computes it in tensor ops, with the element-wise work in six launches
around the key sort:

  1. ``esc_counts``: the products each entry of A expands to (the nnz of B's
     row at its column), then ``torch.cumsum``: their inclusive running
     count, whose last element is the flop count;
  2. ``esc_expand``: every slot of the ``expand_cap``-slot stream as the
     fused key ``row * n_cols + col`` and the saturating product
     a_ik (x) b_kj in one 64-bit word;
  3. ``torch.sort`` of the keys (CUB's radix sort), as the tensor-op path;
  4. the merge: the sums of equal keys with the saturating add, zero totals
     dropped, compacted into CSR, in four launches: ``esc_merge_tiles`` (a
     segmented scan of each tile of 2,048 sorted positions, and its
     summary), ``esc_merge_carry`` (one block carrying the open segment's
     sum and the output offset across the tiles), ``esc_merge_emit`` (the
     scan again, each kept segment written at its offset, and the padding)
     and ``esc_merge_rows`` (the row offsets).

Every field of the result, padding included, equals the tensor-op path's
bit for bit: a saturating sum of non-negative integers is min(true sum,
MAX) in any order.  An expansion past ``expand_cap``, or more entries than
``out_cap``, poisons nnz to -1 as there.  No step synchronises with the
host.

Replaces no TPU kernel: the JAX package's ESC is plain ``jnp``, which XLA
fuses on the TPU.  Added because in PyTorch tensor ops the same ESC took
~130 int64 passes over the expansion stream (the u64 multiply alone ~60, in
16-bit halves of int64 limbs) and ~250 launches a product, which held the
ESC chain of the 30^3 torus at 0.18 % of its products' byte bound on the
H100.

``spgemm_esc`` takes CUDA tensors of u32 or u64 values only.  The one
dispatch is ``ops.spgemm.spgemm`` (``takes``): every other product, f32 and
the CPU, runs the tensor ops there, ``ops.spgemm.spgemm_reference``, the
kernels' plain version.  f32 stays on the tensor ops because its segmented
sum has a fixed order, and a kernel's would round differently.  Under a
profiler each launch is the span ``kernel/<entry
point> bytes=<int>`` (``obs``; the kernel is ``<entry point>_kernel``),
inside ESC's stage spans ``esc/expand``, ``esc/sort`` and ``esc/merge``.
"""

from __future__ import annotations

import torch

from .. import obs
from ..csr import SparseCSR
from ..ops.segments import KEY_SENTINEL
from . import _build

LAUNCHES = 0  # kernel launches by spgemm_esc (CUDA tensors only): six a product
SEMIRINGS = ("u32", "u64")
# the merge's scratch, as the source sizes it: the entry points refuse any
# other length (cudaErrorInvalidValue)
TILE = 2048   # sorted positions a merge block takes (kTile in the source)
SUMMARY_WORDS = 4  # int64 words of a tile's summary (kSummary)
CARRY_WORDS = 2    # int64 words of a tile's carry (kCarry)


def takes(a: SparseCSR) -> bool:
    """Whether ``ops.spgemm.spgemm`` runs A x B on these kernels: A on a
    CUDA card with u32 or u64 values."""
    return a.device.type == "cuda" and a.sr_name in SEMIRINGS


def counts_bytes(cap_a: int) -> int:
    """The least bytes of one ``esc_counts`` launch: a count written for
    every slot of A (8 B).  The columns of A and the row offsets of B that
    it reads stop at nnz(A), a device value, and are not counted."""
    return 8 * cap_a


def expand_bytes(expand_cap: int) -> int:
    """The least bytes of one ``esc_expand`` launch: the key and the
    product written for every slot (16 B).  The entries of A and B that it
    reads number the flops, a device value, and are not counted."""
    return 16 * expand_cap


def tiles_of(expand_cap: int) -> int:
    """Tiles of the merge over an ``expand_cap``-slot sorted stream."""
    return -(-expand_cap // TILE)


def merge_tiles_bytes(expand_cap: int) -> int:
    """The least bytes of one ``esc_merge_tiles`` launch: every sorted key
    read (8 B a slot) and every tile's summary written.  The permutation
    and the products read through it cover the live slots only and are not
    counted."""
    return 8 * expand_cap + 8 * SUMMARY_WORDS * tiles_of(expand_cap)


def merge_carry_bytes(expand_cap: int) -> int:
    """The least bytes of one ``esc_merge_carry`` launch: the summaries
    read, every tile's carry written, the count and nnz written (8 B
    each)."""
    return 8 * (SUMMARY_WORDS + CARRY_WORDS) * tiles_of(expand_cap) + 16


def merge_emit_bytes(expand_cap: int, out_cap: int, nlimbs: int) -> int:
    """The least bytes of one ``esc_merge_emit`` launch: every sorted key
    and every tile's carry read, and a column (4 B) and the limbs (8 B
    each) written at every slot of ``out_cap``.  The live slots' reads and
    the kept entries' rows (device counts) are not counted."""
    return (8 * expand_cap + 8 * CARRY_WORDS * tiles_of(expand_cap)
            + (4 + 8 * nlimbs) * out_cap)


def merge_rows_bytes(n_rows: int) -> int:
    """The least bytes of one ``esc_merge_rows`` launch: the row offsets
    written (4 B a row and one).  Its searches of the kept entries' rows
    (a device count) are not counted."""
    return 4 * (n_rows + 1)


def product_bytes(a_rows: int, a_nnz: int, b_rows: int, b_nnz: int, n_rows: int,
                  out_cap: int, nlimbs: int) -> int:
    """The least bytes of C = A x B: A and B read once (row offsets 4 B a
    row and one, 4 B of column and 8 B a limb an entry) and C written once
    at its capacity, with nnz (``chip_smoke.py``'s bound)."""
    entry = 4 + 8 * nlimbs
    return (4 * (a_rows + 1) + entry * a_nnz + 4 * (b_rows + 1) + entry * b_nnz
            + 4 * (n_rows + 1) + entry * out_cap + 8)


def _check(a: SparseCSR, b: SparseCSR, expand_cap: int, out_cap: int) -> None:
    if a.n_cols != b.n_rows:
        raise ValueError(f"shapes {a.shape} x {b.shape} do not chain")
    if a.sr_name != b.sr_name or a.sr_name not in SEMIRINGS:
        raise ValueError(f"the ESC kernels take {SEMIRINGS} operands of one semiring, got "
                         f"{a.sr_name} and {b.sr_name}")
    if expand_cap < 1 or out_cap < 1:
        raise ValueError(f"expand_cap and out_cap must be >= 1, got {expand_cap}, {out_cap}")
    if (a.n_rows + 1) * b.n_cols >= KEY_SENTINEL:
        raise ValueError(f"({a.n_rows}, {b.n_cols}) does not fit an int64 (row, col) key")
    device = a.device
    for name, m in (("A", a), ("B", b)):
        if m.capacity < 1:
            raise ValueError(f"{name} has capacity 0")
        want = [("row_ptr", m.row_ptr, torch.int32, (m.n_rows + 1,)),
                ("col_idx", m.col_idx, torch.int32, (m.capacity,)),
                ("nnz", m.nnz, torch.int64, ())]
        want += [(f"limb {k}", l, torch.int64, (m.capacity,)) for k, l in enumerate(m.values)]
        for field, t, dtype, shape in want:
            if (t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous()
                    or t.device != device):
                raise ValueError(f"{name}'s {field} must be a contiguous {dtype} tensor of "
                                 f"shape {shape} on {device}, got {t.dtype} "
                                 f"{tuple(t.shape)} on {t.device}")
        if len(m.values) != m.sr.nlimbs:
            raise ValueError(f"{name} has {len(m.values)} limbs, {m.sr_name} has "
                             f"{m.sr.nlimbs}")


def _launch(lib, name: str, rule, rule_args, *args) -> None:
    """One launch through the library's entry point ``name``, recorded as
    the span ``kernel/<name> bytes=<rule(*rule_args)>`` (``obs``)."""
    global LAUNCHES
    with obs.kernel(name, rule, *rule_args):
        err = getattr(lib, name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: " + lib.spmm_error_string(err).decode())
    LAUNCHES += 1


def spgemm_esc(a: SparseCSR, b: SparseCSR, expand_cap: int, out_cap: int) -> SparseCSR:
    """C = A x B on u32 or u64, by ESC at an ``expand_cap``-slot expansion
    and an ``out_cap``-slot result; nnz is poisoned to -1 where the
    products pass ``expand_cap`` or the entries ``out_cap``.  A and B are
    ``SparseCSR``s on one CUDA card, every field a contiguous tensor of the
    port's types (ValueError otherwise).  Six launches on the current
    stream, ``torch.cumsum`` and ``torch.sort`` between them, no
    synchronisation."""
    _check(a, b, expand_cap, out_cap)
    if a.device.type != "cuda":
        raise ValueError(f"the ESC kernels run on a CUDA card, not {a.device}")
    lib = _build.load()
    dev = a.device
    wide = int(a.sr_name == "u64")
    n_rows, n_cols, cap_a = a.n_rows, b.n_cols, a.capacity
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        with obs.span("esc/expand"):
            counts = torch.empty(cap_a, dtype=torch.int64, device=dev)
            _launch(lib, "esc_counts", counts_bytes, (cap_a,), a.col_idx.data_ptr(),
                    a.nnz.data_ptr(), cap_a, b.row_ptr.data_ptr(), b.n_rows, counts.data_ptr(),
                    stream)
            cum = torch.cumsum(counts, 0)
            del counts
            key = torch.empty(expand_cap, dtype=torch.int64, device=dev)
            word = torch.empty(expand_cap, dtype=torch.int64, device=dev)
            _launch(lib, "esc_expand", expand_bytes, (expand_cap,), cum.data_ptr(), cap_a,
                    a.row_ptr.data_ptr(), n_rows, a.col_idx.data_ptr(), a.values[0].data_ptr(),
                    a.values[1].data_ptr() if wide else None, b.row_ptr.data_ptr(), b.n_rows,
                    b.capacity, b.col_idx.data_ptr(), b.values[0].data_ptr(),
                    b.values[1].data_ptr() if wide else None, n_cols, expand_cap,
                    key.data_ptr(), word.data_ptr(), wide, stream)
        with obs.span("esc/sort"):
            key, perm = torch.sort(key, stable=True)
        with obs.span("esc/merge"):
            n_tiles = tiles_of(expand_cap)
            summary = torch.empty(SUMMARY_WORDS * n_tiles, dtype=torch.int64, device=dev)
            carry = torch.empty(CARRY_WORDS * n_tiles, dtype=torch.int64, device=dev)
            count = torch.empty((), dtype=torch.int64, device=dev)
            nnz = torch.empty((), dtype=torch.int64, device=dev)
            row_ptr = torch.empty(n_rows + 1, dtype=torch.int32, device=dev)
            col_idx = torch.empty(out_cap, dtype=torch.int32, device=dev)
            out_row = torch.empty(out_cap, dtype=torch.int32, device=dev)
            limbs = tuple(torch.empty(out_cap, dtype=torch.int64, device=dev)
                          for _ in range(1 + wide))
            sorted_in = (key.data_ptr(), perm.data_ptr(), word.data_ptr(), expand_cap)
            _launch(lib, "esc_merge_tiles", merge_tiles_bytes, (expand_cap,), *sorted_in,
                    summary.data_ptr(), summary.numel(), wide, stream)
            flops = cum.data_ptr() + 8 * (cap_a - 1)  # the last running count
            _launch(lib, "esc_merge_carry", merge_carry_bytes, (expand_cap,), summary.data_ptr(),
                    summary.numel(), expand_cap, carry.data_ptr(), carry.numel(),
                    count.data_ptr(), flops, expand_cap, out_cap, nnz.data_ptr(), wide, stream)
            _launch(lib, "esc_merge_emit", merge_emit_bytes, (expand_cap, out_cap, 1 + wide),
                    *sorted_in, carry.data_ptr(), carry.numel(), count.data_ptr(), n_cols, out_cap,
                    col_idx.data_ptr(), limbs[0].data_ptr(),
                    limbs[1].data_ptr() if wide else None, out_row.data_ptr(), wide, stream)
            _launch(lib, "esc_merge_rows", merge_rows_bytes, (n_rows,), out_row.data_ptr(),
                    count.data_ptr(), out_cap, n_rows, row_ptr.data_ptr(), stream)
    return SparseCSR(row_ptr=row_ptr, col_idx=col_idx, values=limbs, nnz=nnz,
                     n_rows=n_rows, n_cols=n_cols, sr_name=a.sr_name)
