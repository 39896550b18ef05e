"""Where the sort-merge kernel's time goes: the kernel against itself with
its bitonic sort switched off, on the slab of the largest kernel-covered
row category of the ER 27,000 x 32 product (L = 4,096).

Run on a card from the repository root::

    python -m sparsetpu_torch.bench.sortmerge_phases [--source A.cu B.cu ...]

For each source (default: the package's ``csrc/sortmerge_rows.cu``; any
version with the same C entry point ``sortmerge_rows`` and the sort loop
``for (int k = 2; k <= L; k <<= 1)``), nvcc builds two libraries: the
kernel as written, and the kernel with that loop run zero times.  Both run
on the same u64 slab, timed by CUDA events behind a device sleep.  The
difference is the sort's time; the no-sort time is the rest (the loads,
the merge and pack scans, the writes).  Prints one JSON line.
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

from ..kernels import _build
from ..ops import rowcat
from . import spgemm_bench

SORT_LOOP = "for (int k = 2; k <= L; k <<= 1)"


def largest_kernel_slab(a):
    """The padded (rows, L) u64 slab of A x A's largest row category the
    kernel takes, built as ``rowcat.numeric_cat`` builds it; returns
    (cols, limbs, L, padded rows, real rows)."""
    from ..kernels import sortmerge

    fr, _, perm, cats, _, cap_g, _ = rowcat.rowcat_config(a, a)
    L, rp, nr, off = max((c for c in cats if sortmerge.available(c[0], 2)),
                         key=lambda c: c[0])
    shared = rowcat.shared_stream(a, a, cap_g)
    cols, limbs = rowcat.expand_cat(a, a, rowcat.category_rows(perm, a.n_rows, rp, nr, off),
                                    fr, L, shared)
    return cols, limbs, L, rp, nr


def time_ms(fn, reps: int) -> float:
    """Mean device ms of fn() over reps calls queued behind a device sleep,
    after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e7))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def build_variant(source: str, out_dir: str, no_sort: bool, tag: str) -> ctypes.CDLL:
    """nvcc ``source`` (its sort loop run zero times when ``no_sort``) into
    ``out_dir``/lib``tag``.so."""
    text = open(source).read()
    if SORT_LOOP not in text:
        raise ValueError(f"{source} has no '{SORT_LOOP}' loop")
    if no_sort:
        text = text.replace(SORT_LOOP, "for (int k = 2; k <= (L & 0); k <<= 1)")
    src = os.path.join(out_dir, f"{tag}.cu")
    lib = os.path.join(out_dir, f"lib{tag}.so")
    with open(src, "w") as f:
        f.write(text)
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", lib, src],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{res.stderr}")
    cdll = ctypes.CDLL(lib)
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    cdll.sortmerge_rows.argtypes = [vp, vp, vp, vp, vp, vp, i64, i64, i32, vp]
    cdll.sortmerge_rows.restype = i32
    return cdll


def run(sources: Sequence[str], reps: int = 10) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("sortmerge_phases needs a CUDA card")
    dev = torch.device("cuda", 0)
    (_, _, _, coo), = spgemm_bench.make_cases(sides=(27000,), e_per_n=(32,),
                                             power_law_sides=())
    a = spgemm_bench.case_operand(coo, dev)
    cols, (lo, hi), L, rp, nr = largest_kernel_slab(a)
    out = [torch.empty_like(cols), torch.empty_like(lo), torch.empty_like(hi)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    result = {"slab": f"ER 27,000 x 32 category L={L}: ({rp}, {L}) u64, {nr} real rows",
              "times_ms": {}}
    with tempfile.TemporaryDirectory() as tmp:
        for i, source in enumerate(sources):
            row = {}
            for no_sort in (False, True):
                lib = build_variant(source, tmp, no_sort, f"{i}_{int(no_sort)}")

                def call():
                    err = lib.sortmerge_rows(cols.data_ptr(), lo.data_ptr(), hi.data_ptr(),
                                             *(x.data_ptr() for x in out), rp, L, 0, stream)
                    if err:
                        raise RuntimeError(f"launch failed ({err})")

                row["no_sort" if no_sort else "full"] = time_ms(call, reps)
            row["sort"] = row["full"] - row["no_sort"]
            result["times_ms"][source] = row
    return result


def main(argv: Optional[List[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--source", nargs="+",
                        default=[os.path.join(_build.CSRC, "sortmerge_rows.cu")])
    parser.add_argument("--reps", type=int, default=10)
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
