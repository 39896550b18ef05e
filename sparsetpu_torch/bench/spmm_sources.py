"""The dense-accumulator SpMM kernel's sources side by side on its callers'
shapes: a full step of the 30^3 thinned torus chain (3 entries a row, a
random P < 5), and A times its dense self for the general-SpGEMM sweep's ER
27,000 x 32, power-law 27,000 (seed 17) and ER 27,000 x 2 operands.

Run on a card from the repository root::

    python -m sparsetpu_torch.bench.spmm_sources [--source A.cu B.cu ...]

Each source (default: the package's ``csrc/spmm_dense_acc.cu``; any version
with the same C entry point ``spmm_dense_acc_f32``, such as a parent
commit's written to a git-ignored directory) is built by nvcc into a library
of its own, with ptxas's register and spill report.  On each shape, the
sources are then called in the order given (name one twice for an A / B /
B / A order): each call's whole C is held against the plain version for
exact equality first (integer values below 2^24: every order is exact),
then timed by CUDA events behind a device sleep.  Beside each shape: its
compulsory-byte bound at 3.35 TB/s, its gather traffic (nnz x m x 4 B, one
P row an entry), ``torch.sparse.mm``'s time on the same product, and once
the card's L2 re-read rate (``l2_gather_rate``).  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import tempfile
import time
from typing import Iterator, List, Optional, Sequence, Tuple

import torch

from ..kernels import _build, spmm
from . import spgemm_bench
from .sortmerge_phases import time_ms

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
CHECK_BYTES = 1 << 31      # the plain version's gather, at most, a row chunk


def sweep_operand(case: str, n: int, e_per_n: int, device) -> Tuple[spmm.SparseOperand,
                                                                    torch.Tensor]:
    """(A, P): one sweep graph (``spgemm_bench.make_cases``) as the dense
    accumulator's operand, and its dense f32 self, as ``denseacc`` runs it."""
    from ..ops import denseacc
    from .chain import tuple_to_f32_dense

    (*_, coo), = spgemm_bench.make_cases(
        sides=(n,) if case == "er" else (), e_per_n=(e_per_n,),
        power_law_sides=(n,) if case == "powerlaw" else ())
    a = spgemm_bench.case_operand(coo, device)
    return denseacc.plan_dense_acc(a), tuple_to_f32_dense(a)


def shapes(device) -> Iterator[Tuple[str, spmm.SparseOperand, torch.Tensor]]:
    """(label, A, P) of the four shapes, built one at a time."""
    from .chain import build_torus_host

    h = build_torus_host((30, 30, 30))
    gen = torch.Generator(device=device).manual_seed(0)
    yield ("30^3 torus full step (3 entries a row)", spmm.prepare_sparse_operand(h, device),
           torch.randint(0, 5, (h.n_cols, h.n_cols), generator=gen, device=device,
                         dtype=torch.float32))
    for label, case, e_per_n in (("ER 27,000 x 32 x its dense self", "er", 32),
                                 ("power-law 27,000 x its dense self", "powerlaw", 8),
                                 ("ER 27,000 x 2 x its dense self", "er", 2)):
        yield (label, *sweep_operand(case, 27000, e_per_n, device))


def compulsory_bytes(op: spmm.SparseOperand, m: int) -> int:
    """A's arrays, each distinct P row A references once, C once."""
    distinct = torch.unique(op.col_idx).numel()
    return (op.row_ptr.numel() + 2 * op.col_idx.numel() + distinct * m + op.n_rows * m) * 4


def gather_bytes(op: spmm.SparseOperand, m: int) -> int:
    """The P bytes the product reads: one m-float P row an entry of A."""
    return op.col_idx.numel() * m * 4


def plain_product(op: spmm.SparseOperand, p: torch.Tensor) -> torch.Tensor:
    """The plain version's whole C, in row chunks whose (nnz, m) gather stays
    within CHECK_BYTES."""
    out = torch.empty(op.n_rows, p.shape[1], dtype=torch.float32, device=p.device)
    ptr = op.row_ptr.cpu().long()
    per_chunk = max(CHECK_BYTES // (4 * p.shape[1]), 1)
    lo = 0
    while lo < op.n_rows:
        hi = int(torch.searchsorted(ptr, ptr[lo] + per_chunk, right=True)) - 1
        hi = min(max(hi, lo + 1), op.n_rows)
        out[lo:hi] = spmm.spmm_dense_acc_reference(spmm.row_slice(op, lo, hi), p)
        lo = hi
    return out


def l2_gather_rate(p: torch.Tensor, width: int = 128, rows: int = 32768,
                   bag: int = 32, reps: int = 50) -> dict:
    """The card's L2 re-read rate, as a reference for the gather floor (not a
    bound), from a (n_p, width) panel of P that stays in L2 (13.8 MB at
    n_p = 27,000), random rows (seed 0):

    - ``index_select`` of ``rows`` rows into an output written in place
      (16.8 MB, also L2-resident);
    - ``embedding_bag`` summing ``bag`` x ``rows`` rows in bags of ``bag``
      (537 MB of gathers, a 1/``bag`` output), the gather-and-add of a
      dense accumulator's row.

    Returns the panel bytes and, for each, the gathered bytes, the ms of one
    call and the gathered bytes' rate in TB/s."""
    panel = p[:, :width].contiguous()
    gen = torch.Generator(device=p.device).manual_seed(0)
    idx = torch.randint(0, p.shape[0], (rows * bag,), generator=gen, device=p.device)
    out = torch.empty(rows, width, dtype=p.dtype, device=p.device)
    bags = idx.view(rows, bag)
    calls = {"index_select": (rows, lambda: torch.index_select(panel, 0, idx[:rows], out=out)),
             "embedding_bag": (rows * bag, lambda: torch.nn.functional.embedding_bag(
                 bags, panel, mode="sum"))}
    res = {"panel_bytes": panel.numel() * 4}
    for name, (n, fn) in calls.items():
        ms = time_ms(fn, reps)
        res[name] = dict(gathered_bytes=n * width * 4, ms=ms, tb_per_s=n * width * 4 / ms / 1e9)
    return res


def build_sources(sources: Sequence[str], out_dir: str) -> dict:
    """{source: (library, ptxas report)}: each distinct source by its own
    nvcc, all started together, into ``out_dir``."""
    distinct = list(dict.fromkeys(sources))
    libs = [os.path.join(out_dir, f"lib{i}.so") for i in range(len(distinct))]
    procs = [subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
                               "-o", lib, src], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for src, lib in zip(distinct, libs)]
    built = {}
    for src, lib, proc in zip(distinct, libs, procs):
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{err}")
        cdll = ctypes.CDLL(lib)
        vp, i64 = ctypes.c_void_p, ctypes.c_int64
        cdll.spmm_dense_acc_f32.argtypes = [vp, vp, vp, vp, vp, i64, i64, vp]
        cdll.spmm_dense_acc_f32.restype = ctypes.c_int
        report = [line.strip() for line in (out + err).splitlines()
                  if "registers" in line or "spill" in line]
        built[src] = (cdll, report)
    return built


def panel_cols(cdll, n_rows: int, m: int) -> Optional[int]:
    """The source's panel width for this launch, where it exports one."""
    if not hasattr(cdll, "spmm_dense_acc_panel_cols"):
        return None
    fn = cdll.spmm_dense_acc_panel_cols
    fn.argtypes, fn.restype = [ctypes.c_int64, ctypes.c_int64], ctypes.c_int64
    return int(fn(n_rows, m))


def caller(cdll, op: spmm.SparseOperand, p: torch.Tensor, out: torch.Tensor):
    """A call of ``cdll``'s kernel into ``out``, as the wrapper makes it."""
    stream = torch.cuda.current_stream(p.device).cuda_stream

    def call():
        err = cdll.spmm_dense_acc_f32(op.row_ptr.data_ptr(), op.col_idx.data_ptr(),
                                      op.vals.data_ptr(), p.data_ptr(), out.data_ptr(),
                                      op.n_rows, p.shape[1], stream)
        if err:
            raise RuntimeError(f"spmm_dense_acc_f32 launch failed ({err})")
        return out

    return call


def run(sources: Sequence[str], reps: int = 5) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("spmm_sources needs a CUDA card")
    dev = torch.device("cuda", 0)
    result = {"shapes": {}, "ptxas": {}, "times_ms": {}}
    with tempfile.TemporaryDirectory() as tmp:
        built = build_sources(sources, tmp)
        result["ptxas"] = {src: report for src, (_, report) in built.items()}
        for label, op, p in shapes(dev):
            m = p.shape[1]
            if "l2_gather" not in result:
                result["l2_gather"] = l2_gather_rate(p)
            lib_a = torch.sparse_csr_tensor(op.row_ptr, op.col_idx, op.vals, size=(op.n_rows, m))
            gathered = gather_bytes(op, m)
            info = dict(n_rows=op.n_rows, m=m, nnz=op.col_idx.numel(),
                        bound_ms=compulsory_bytes(op, m) / HBM_BYTES_PER_S * 1e3,
                        gather_gb=gathered / 1e9,
                        library_ms=time_ms(lambda: torch.sparse.mm(lib_a, p), reps))
            info["library_gather_tb_per_s"] = gathered / info["library_ms"] / 1e9
            want = plain_product(op, p)
            out = torch.empty_like(want)
            rows = []
            for src in sources:
                cdll = built[src][0]
                call = caller(cdll, op, p, out)
                out.fill_(float("nan"))
                call()
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    raise RuntimeError(f"{src} on {label}: C != plain version "
                                       f"(max |err| {float((out - want).abs().nan_to_num(1e30).max())})")
                ms = time_ms(call, reps)
                rows.append(dict(source=src, ms=ms, gather_tb_per_s=gathered / ms / 1e9,
                                 panel_cols=panel_cols(cdll, op.n_rows, m)))
            result["shapes"][label] = info
            result["times_ms"][label] = rows
            print(f"{label}: n={op.n_rows} nnz={info['nnz']} m={m} bound "
                  f"{info['bound_ms']:.4f} ms, gather {info['gather_gb']:.2f} GB, "
                  f"torch.sparse.mm {info['library_ms']:.4f} ms; "
                  + "; ".join(f"{r['source']} {r['ms']:.4f} ms (W={r['panel_cols']}, "
                              f"{r['gather_tb_per_s']:.2f} TB/s)" for r in rows), flush=True)
            del op, p, lib_a, want, out
            torch.cuda.empty_cache()
    return result


def main(argv: Optional[List[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--source", nargs="+",
                        default=[os.path.join(_build.CSRC, "spmm_dense_acc.cu")])
    parser.add_argument("--reps", type=int, default=5)
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
