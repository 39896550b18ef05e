"""The tiled dense routes' count and pack as hand-written CUDA kernels
(``csrc/panel_pack.cu``).

``ops/denseacc._two_sweeps`` sweeps B's columns in panels: sweep 1 computes
each dense (n, w) f32 C panel and counts its rows' nonzeros, which give the
product's row offsets; sweep 2 computes each panel again and writes its
nonzeros into the product.  On a CUDA card each sweep's work on a panel is
one launch that reads the panel once:

  1. ``panel_count``: row r's nonzeros into row p of an int32 (panels, n)
     count table, and, for the integer semirings, the panel's exactness
     fault (a cell not below 2^24) OR-ed into an int32 word on the card;
  2. ``panel_pack``: each nonzero of row r, in row-major order, at slot
     ``row_ptr[r] + prior[p, r] + (its rank in the row)`` of the product:
     its column ``lo + j`` and its value as the semiring's limbs.

Every slot equals the tensor ops' (``ops/denseacc``'s plain sweeps, which
take CPU tensors) bit for bit.  Replaces no TPU kernel: the JAX package
packs with ``jnp``, which XLA fuses on the TPU.  Added because in PyTorch
tensor ops the two sweeps read each panel five times and scattered its
entries through ~15 int64 passes, 62 % of the device time of Graph 500's
SCALE-17 A^2 on the H100.

The wrappers take CUDA tensors alone (ValueError otherwise); the one
dispatch is ``ops/denseacc._two_sweeps``, by the device.  Under a profiler
each launch is the span ``kernel/<entry point> bytes=<int>`` (``obs``; the
kernel is ``<entry point>_kernel``), with the bytes from the rules below.
"""

from __future__ import annotations

import torch

from .. import obs
from . import _build

LAUNCHES = 0  # launches of panel_count and panel_pack (CUDA tensors only): two a panel
LIMB_DTYPES = {"u32": (torch.int64,), "u64": (torch.int64, torch.int64),
               "f32": (torch.float32,)}
VALUE_BYTES = {"u32": 8, "u64": 16, "f32": 4}  # an entry's limbs in the product


def count_bytes(n: int, w: int) -> int:
    """The least bytes of one ``panel_count`` launch: the (n, w) f32 panel
    read once, a count written a row (4 B)."""
    return 4 * n * w + 4 * n


def pack_bytes(n: int, w: int, nnz: int, entry_value_bytes: int) -> int:
    """The least bytes of one ``panel_pack`` launch: the (n, w) f32 panel
    read once, the row's offset in the product and in the earlier panels
    (4 B each a row), and the panel's ``nnz`` entries written: a column (4
    B) and the value (``VALUE_BYTES``)."""
    return 4 * n * w + 8 * n + nnz * (4 + entry_value_bytes)


def _check_tensor(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if (t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous()
            or t.device != device):
        raise ValueError(f"{name} must be a contiguous {dtype} tensor of shape "
                         f"{tuple(shape)} on {device}, got {t.dtype} {tuple(t.shape)} "
                         f"on {t.device}")


def _check_panel(dense: torch.Tensor) -> None:
    if dense.dtype != torch.float32 or dense.dim() != 2 or not dense.is_contiguous():
        raise ValueError(f"the panel must be a contiguous 2-D float32 tensor, got "
                         f"{dense.dtype} {tuple(dense.shape)}")


def _check_table(name: str, table: torch.Tensor, p: int, n: int, device) -> None:
    if table.dim() != 2 or table.shape[1] != n:
        raise ValueError(f"{name} must be a (panels, {n}) table, got {tuple(table.shape)}")
    _check_tensor(name, table, torch.int32, table.shape, device)
    if not 0 <= p < table.shape[0]:
        raise ValueError(f"panel {p} outside the {name}'s {table.shape[0]} rows")


def _on_card(device) -> None:
    if device.type != "cuda":
        raise ValueError(f"the panel kernels run on a CUDA card, not {device}")


def _launch(name: str, rule, rule_args, device, *args) -> None:
    """One launch through the library's entry point ``name`` on the current
    stream, recorded as the span ``kernel/<name> bytes=<rule(*rule_args)>``."""
    global LAUNCHES
    lib = _build.load()
    with torch.cuda.device(device), obs.kernel(name, rule, *rule_args):
        err = getattr(lib, name)(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: " + lib.spmm_error_string(err).decode())
    LAUNCHES += 1


def panel_count(dense: torch.Tensor, table: torch.Tensor, p: int, fault: torch.Tensor,
                check: bool) -> None:
    """Sweep 1 on one panel: ``table[p, r]`` = the nonzeros of the panel's
    row r; where ``check``, ``fault`` (an int32 on the card) is OR-ed with 1
    if a cell is not below 2^24 (a NaN included).  One launch, no
    synchronisation; a panel of no rows launches nothing."""
    _check_panel(dense)
    n, w = dense.shape
    dev = dense.device
    _check_table("the count table", table, p, n, dev)
    _check_tensor("fault", fault, torch.int32, (), dev)
    _on_card(dev)
    if n == 0:
        return
    _launch("panel_count", count_bytes, (n, w), dev, dense.data_ptr(), n, w,
            table[p].data_ptr(), fault.data_ptr(), int(check))


def panel_pack(dense: torch.Tensor, lo: int, row_ptr: torch.Tensor, prior: torch.Tensor,
               p: int, col_idx: torch.Tensor, limbs, sr_name: str, nnz: int) -> None:
    """Sweep 2 on one panel, columns [lo, lo + w) of the product: each
    nonzero of row r, in row-major order, at slot ``row_ptr[r] + prior[p,
    r]`` + its rank in the row, as the column ``lo + j`` in ``col_idx`` and
    the value in ``limbs`` (u32: the int64 lo limb; u64: lo and a 0 hi limb;
    f32: the value).  ``nnz``: the panel's entries, for the span's bytes.
    One launch, no synchronisation; a panel of no rows launches nothing."""
    _check_panel(dense)
    n, w = dense.shape
    dev = dense.device
    _check_tensor("row_ptr", row_ptr, torch.int32, (n + 1,), dev)
    _check_table("prior", prior, p, n, dev)
    if col_idx.dim() != 1:
        raise ValueError(f"col_idx must be 1-D, got {tuple(col_idx.shape)}")
    cap = col_idx.shape[0]
    _check_tensor("col_idx", col_idx, torch.int32, (cap,), dev)
    dtypes = LIMB_DTYPES.get(sr_name)
    if dtypes is None or len(limbs) != len(dtypes):
        raise ValueError(f"{sr_name} takes {len(dtypes or ())} limbs, got {len(limbs)}")
    for k, (l, d) in enumerate(zip(limbs, dtypes)):
        _check_tensor(f"limb {k}", l, d, (cap,), dev)
    if lo < 0 or lo + w > 2**31:
        raise ValueError(f"columns [{lo}, {lo + w}) do not fit int32")
    _on_card(dev)
    if n == 0:
        return
    n_limbs = 0 if sr_name == "f32" else len(limbs)
    _launch("panel_pack", pack_bytes, (n, w, nnz, VALUE_BYTES[sr_name]), dev,
            dense.data_ptr(), n, w, lo, row_ptr.data_ptr(), prior[p].data_ptr(),
            col_idx.data_ptr(), limbs[0].data_ptr(),
            limbs[1].data_ptr() if n_limbs == 2 else None, n_limbs)
