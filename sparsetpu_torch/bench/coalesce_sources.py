"""The coalesce kernel's sources side by side on the slab's real inputs: the
survivor streams of the mixed chain's A^4 slab (A^3 x A on the 30^3 thinned
torus) and of the ER 27,000 x 32 slab (A x A).

Run on a card from the repository root::

    python -m sparsetpu_torch.bench.coalesce_sources [--source A.cu B.cu ...]

Each source (default: the package's ``csrc/coalesce_blocks.cu``; any
version with the same C entry point ``coalesce_blocks``, such as a parent
commit's) is built by nvcc into a library of its own, with ptxas's report.
The sources are then timed in the order given (name one twice for an A / B /
B / A order), each call held against the plain version for exact equality
first, by CUDA events behind a device sleep.  Beside each input: its two
bounds, the data's bytes (4 B a stream) and the port's format's (int64
limbs) at 3.35 TB/s.  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import tempfile
import time
from typing import List, Optional, Sequence

import torch

from ..kernels import _build, coalesce
from ..ops import slab
from ..ops.segments import INT32_SENTINEL
from . import spgemm_bench
from .sortmerge_phases import time_ms

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def real_inputs(a, a_er) -> dict:
    """{label: (offs, streams, out_cap, fills)}: the coalesce inputs of the
    mixed chain's A^4 slab step (A^3 x A for the torus operand ``a``) and of
    the slab product ``a_er`` x ``a_er``."""
    a_3 = slab.spgemm_slab(slab.spgemm_slab(a, a).check(), a).check()
    out = {}
    for label, (x, y) in (("mixed chain A^4 slab (A^3 x A, 30^3)", (a_3, a)),
                          ("ER 27,000 x 32 slab", (a_er, a_er))):
        plan = slab.slab_config(x, y)
        offs, streams = slab.survivor_streams(x, y, plan)
        fills = [x.n_rows, INT32_SENTINEL] + [0] * (len(streams) - 2)
        out[label] = (offs, streams, plan.out_cap, fills)
    return out


def byte_counts(offs: torch.Tensor, streams: Sequence[torch.Tensor], out_cap: int):
    """(data bytes, format bytes): each survivor read once and written once
    in every stream with its 4-byte block id, the rest of out_cap written
    once, offs read once; the data carries 4 B a stream, the format each
    stream's element size."""
    kept = min(int(offs[-1]), out_cap)

    def count(es):
        return kept * (2 * es + 4) + (out_cap - kept) * (es + 4) + offs.numel() * 4

    return count(4 * len(streams)), count(sum(s.element_size() for s in streams))


def build_source(source: str, out_dir: str, tag: str):
    """(library, ptxas report): nvcc ``source`` into ``out_dir``/lib``tag``.so."""
    lib = os.path.join(out_dir, f"lib{tag}.so")
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
                          "-o", lib, source], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{res.stderr}")
    cdll = ctypes.CDLL(lib)
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    cdll.coalesce_blocks.argtypes = [vp, i64, i64, i64, i32, i32, *[vp] * 9, *[i64] * 4, vp]
    cdll.coalesce_blocks.restype = i32
    report = [line.strip() for line in (res.stdout + res.stderr).splitlines()
              if "registers" in line or "spill" in line]
    return cdll, report


def caller(cdll, offs, streams, out_cap: int, fills):
    """A call of ``cdll``'s kernel on fresh outputs, as the wrapper makes it."""
    dev = offs.device
    nb, L = streams[0].shape
    k = len(streams)
    pad = coalesce.MAX_STREAMS - k
    wide = sum(1 << q for q, s in enumerate(streams) if s.element_size() == 8)
    bits = [coalesce._fill_bits(f, s.dtype) for f, s in zip(fills, streams)] + [0] * pad
    outs = [torch.empty(out_cap, dtype=s.dtype, device=dev) for s in streams]
    bid = torch.empty(out_cap, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call():
        err = cdll.coalesce_blocks(offs.data_ptr(), nb, L, out_cap, k, wide,
                                   *(s.data_ptr() for s in streams), *[None] * pad,
                                   *(o.data_ptr() for o in outs), *[None] * pad,
                                   bid.data_ptr(), *bits, stream)
        if err:
            raise RuntimeError(f"coalesce_blocks launch failed ({err})")
        return (*outs, bid)

    return call


def run(sources: Sequence[str], reps: int = 20) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("coalesce_sources needs a CUDA card")
    from .chain import build_torus_host, sparse_operand

    dev = torch.device("cuda", 0)
    (_, _, _, coo), = spgemm_bench.make_cases(sides=(27000,), e_per_n=(32,),
                                             power_law_sides=())
    inputs = real_inputs(sparse_operand(build_torus_host((30, 30, 30)), dev),
                         spgemm_bench.case_operand(coo, dev))
    result = {"inputs": {}, "ptxas": {}, "times_ms": []}
    for label, (offs, streams, out_cap, fills) in inputs.items():
        data, fmt = byte_counts(offs, streams, out_cap)
        result["inputs"][label] = dict(
            nb=streams[0].shape[0], L=streams[0].shape[1], survivors=int(offs[-1]),
            out_cap=out_cap, dtypes=[str(s.dtype)[6:] for s in streams],
            bound_ms=data / HBM_BYTES_PER_S * 1e3, format_bound_ms=fmt / HBM_BYTES_PER_S * 1e3)
    with tempfile.TemporaryDirectory() as tmp:
        libs = {}
        for source in sources:
            if source not in libs:
                libs[source], result["ptxas"][source] = build_source(source, tmp, str(len(libs)))
        for source in sources:
            row = {"source": source}
            for label, (offs, streams, out_cap, fills) in inputs.items():
                call = caller(libs[source], offs, streams, out_cap, fills)
                got = call()
                want = coalesce.coalesce_blocks_reference(offs, streams, out_cap, fills)
                torch.cuda.synchronize()
                for i, (g, w) in enumerate(zip(got, want)):
                    if not torch.equal(g, w):
                        raise RuntimeError(f"{source} on {label}: output {i} != plain version")
                row[label] = time_ms(call, reps)
            result["times_ms"].append(row)
    return result


def main(argv: Optional[List[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--source", nargs="+",
                        default=[os.path.join(_build.CSRC, "coalesce_blocks.cu")])
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args(argv)
    t0 = time.perf_counter()
    res = run(args.source, args.reps)
    res["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    res["seconds"] = time.perf_counter() - t0
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
