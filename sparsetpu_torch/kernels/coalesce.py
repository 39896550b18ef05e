"""Prefix-coalesce of block-slab survivors: the port of
``sparsetpu/kernels/coalesce.py``, the compaction step of the slab ESC
SpGEMM (``ops/slab.py``).

After the slab's merge, each block b of an (nb, L) stream holds its
``sb[b]`` survivors at its front, in final order.  Compaction is then nb
variable-offset copies of those prefixes into one flat stream:

    out[offs[b] + j] = stream[b, j]   and   block_id[offs[b] + j] = b,
    for 0 <= j < sb[b] = offs[b + 1] - offs[b].

On a CUDA tensor ``coalesce_blocks`` launches the hand-written kernel
``csrc/coalesce_blocks.cu`` (the counterpart of ``_kernel``); on a CPU
tensor it runs the plain version ``coalesce_blocks_reference``, the
arithmetic-gather form of ``sparsetpu/ops/slab.py``'s compaction: the block
of every output position from ``segments.repeat_index``, then one gather per
stream.

Differences from the JAX package, and why:

- ``offs`` holds nb + 1 offsets, the last being the total, where JAX's holds
  nb and leaves the last block's length implicit: the kernel needs every
  block's end, the total among them, where the fill begins.
- JAX copies every block's full L lanes and lets later blocks overwrite the
  earlier blocks' dead tails, which is right only because TPU grid steps run
  one after another.  CUDA blocks run concurrently, so the kernel walks the
  output positions instead, each written once by one thread (a survivor or
  a fill), and nothing depends on an order of writes.
- Positions at or past the total (and before ``offs[0]``) are filled with a
  stated value per stream (``fills``, default 0) and block id -1; positions
  at or past ``out_cap`` are dropped.  Nothing is left uninitialised.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from .. import obs
from ..ops import segments
from . import _build

LAUNCHES = 0     # kernel launches by coalesce_blocks (CUDA tensors only)
MAX_STREAMS = 4  # streams one call takes
DTYPES = (torch.int32, torch.int64, torch.float32)
BLOCK_ID_FILL = -1  # block id of a position that no block covers


def _check(offs: torch.Tensor, streams: Sequence[torch.Tensor], out_cap: int,
           fills: Sequence) -> None:
    if not 1 <= len(streams) <= MAX_STREAMS:
        raise ValueError(f"coalesce_blocks takes 1 to {MAX_STREAMS} streams, got {len(streams)}")
    if len(fills) != len(streams):
        raise ValueError(f"{len(fills)} fill values for {len(streams)} streams")
    shape = streams[0].shape
    if len(shape) != 2:
        raise ValueError(f"streams must be 2-D (nb, L), got {tuple(shape)}")
    for s in streams:
        if (s.shape != shape or s.dtype not in DTYPES or not s.is_contiguous()
                or s.device != offs.device):
            raise ValueError(f"each stream must be a contiguous {tuple(shape)} tensor of one "
                             f"of {DTYPES} on {offs.device}, got {s.dtype} "
                             f"{tuple(s.shape)} on {s.device}")
    if (offs.dtype != torch.int32 or offs.dim() != 1 or offs.numel() != shape[0] + 1
            or not offs.is_contiguous()):
        raise ValueError(f"offs must be a contiguous int32 tensor of nb + 1 = {shape[0] + 1} "
                         f"offsets, got {offs.dtype} {tuple(offs.shape)}")
    if shape[1] < 1 or out_cap < 0:
        raise ValueError(f"need L >= 1 and out_cap >= 0, got L={shape[1]}, out_cap={out_cap}")


def coalesce_blocks_reference(offs: torch.Tensor, streams: Sequence[torch.Tensor],
                              out_cap: int, fills: Optional[Sequence] = None
                              ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch compaction: the block of each output position t from
    one increment scatter + cumsum over the block starts, then one gather
    per stream at ``b * L + (t - offs[b])``."""
    fills = [0] * len(streams) if fills is None else fills
    nb, L = streams[0].shape
    device = offs.device
    t = torch.arange(out_cap, device=device)
    offs = offs.long()
    if nb == 0:
        covered = torch.zeros(out_cap, dtype=torch.bool, device=device)
        bid = torch.zeros(out_cap, dtype=torch.int64, device=device)
    else:
        bid = torch.clamp(segments.repeat_index(offs[:-1], torch.arange(nb, device=device),
                                                out_cap), 0, nb - 1)
        covered = (t >= offs[0]) & (t < offs[-1])
    src = torch.clamp(bid * L + (t - offs[bid]), 0, max(nb * L - 1, 0))
    outs = [torch.where(covered, s.reshape(-1)[src] if nb else s.new_zeros(out_cap),
                        torch.tensor(f, dtype=s.dtype, device=device))
            for s, f in zip(streams, fills)]
    return (*outs, torch.where(covered, bid, BLOCK_ID_FILL).int())


def coalesce_blocks(offs: torch.Tensor, streams: Sequence[torch.Tensor], out_cap: int,
                    fills: Optional[Sequence] = None) -> Tuple[torch.Tensor, ...]:
    """Compact the survivor prefixes of K (nb, L) streams into flat streams.

    ``offs``: int32[nb + 1], the exclusive prefix sums of the blocks'
    survivor counts (offs[0] = 0, nondecreasing, each step at most L), so
    offs[nb] is the total.  ``streams``: 1 to 4 contiguous (nb, L) tensors,
    int32, int64 (the port's uint32 limbs) or float32.  ``fills``: one value
    per stream for the positions that hold no survivor (default 0).

    Returns ``(*flat_streams, block_id)``, each of ``out_cap`` elements:
    position t < min(offs[nb], out_cap) holds ``stream[b, t - offs[b]]`` for
    the b with offs[b] <= t < offs[b + 1], and ``block_id[t] = b`` (int32);
    the rest hold the fills and block id -1.  Survivors past ``out_cap`` are
    dropped (the caller poisons its count).  Offsets that break the
    precondition never make the kernel read or write out of bounds.

    On CUDA: one launch of the kernel on the current stream, without
    synchronising; the streams may be contiguous views at any element
    offset.  Under a profiler the launch is the span
    ``kernel/coalesce_blocks`` (``obs``), without ``bytes=``: the survivors
    it reads number offs[nb], which only a read of the device would give.
    On the CPU: the plain version."""
    global LAUNCHES
    fills = [0] * len(streams) if fills is None else list(fills)
    _check(offs, streams, out_cap, fills)
    if offs.device.type == "cpu":
        return coalesce_blocks_reference(offs, streams, out_cap, fills)
    if offs.device.type != "cuda":
        raise ValueError(f"coalesce_blocks runs on cpu or cuda, not {offs.device}")
    nb, L = streams[0].shape
    outs = [torch.empty(out_cap, dtype=s.dtype, device=s.device) for s in streams]
    block_id = torch.empty(out_cap, dtype=torch.int32, device=offs.device)
    if out_cap == 0:
        return (*outs, block_id)
    # the kernel writes every output by 16-byte stores; the allocator aligns them
    if any(o.data_ptr() % 16 for o in (*outs, block_id)):
        raise RuntimeError("coalesce_blocks: an output is not 16-byte aligned")
    lib = _build.load()
    ptrs_in = [s.data_ptr() for s in streams] + [None] * (MAX_STREAMS - len(streams))
    ptrs_out = [o.data_ptr() for o in outs] + [None] * (MAX_STREAMS - len(streams))
    wide = sum(1 << k for k, s in enumerate(streams) if s.element_size() == 8)
    bits = [_fill_bits(f, s.dtype) for f, s in zip(fills, streams)]
    bits += [0] * (MAX_STREAMS - len(bits))
    with torch.cuda.device(offs.device), obs.kernel("coalesce_blocks"):
        err = lib.coalesce_blocks(
            offs.data_ptr(), nb, L, out_cap, len(streams), wide, *ptrs_in, *ptrs_out,
            block_id.data_ptr(), *bits, torch.cuda.current_stream(offs.device).cuda_stream)
    if err != 0:
        raise RuntimeError("coalesce_blocks launch failed: "
                           + lib.spmm_error_string(err).decode())
    LAUNCHES += 1
    return (*outs, block_id)


def _fill_bits(value, dtype: torch.dtype) -> int:
    """The bit pattern of ``value`` in ``dtype``, as a signed 64-bit integer
    (the kernel stores its low 4 bytes for a 4-byte stream)."""
    t = torch.tensor([value], dtype=dtype)
    if t.element_size() == 4:
        return int(t.view(torch.int32)[0])
    return int(t.view(torch.int64)[0])
