"""Build and load the port's CUDA kernels (``sparsetpu_torch/csrc``).

On first use, nvcc compiles every ``*.cu`` in ``csrc/`` for Hopper (sm_90a),
one nvcc process per source, all started together, and links the objects
into one shared library with a plain C interface, loaded with ctypes; no
PyTorch headers are involved, so a build takes seconds.  The library goes
into the git-ignored ``sparsetpu_torch/_build/``, is rebuilt whenever a
source or header (``*.cu``, ``*.cuh``) is newer, and is written under a
temporary name and renamed into place, so concurrent first uses never load a
half-written file.  Nothing here runs at import time: the CPU tests import
every module on hosts that have no nvcc.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import tempfile
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB = os.path.join(BUILD_DIR, "libsparsetpu_kernels.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA "
                           "kernels need the CUDA toolkit")
    return path


def build() -> str:
    """Compile the kernels if the library is missing or older than a source
    or header.  Returns nvcc's report (ptxas registers, spills) of this
    build, or "" if the library was up to date.  Raises RuntimeError with
    nvcc's stderr on failure."""
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    inputs = sources + sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    if os.path.exists(LIB) and all(
            os.path.getmtime(LIB) >= os.path.getmtime(s) for s in inputs):
        return ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp_dir = tempfile.mkdtemp(dir=BUILD_DIR)
    nvcc = _nvcc()
    try:
        objs = [os.path.join(tmp_dir, os.path.basename(s) + ".o") for s in sources]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", o, s],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for s, o in zip(sources, objs)]
        report = []
        for src, proc in zip(sources, procs):
            out, err = proc.communicate()
            report.append(out + err)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {os.path.basename(src)} "
                                   f"(exit {proc.returncode}):\n{err}")
        tmp_lib = os.path.join(tmp_dir, "lib.so")
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp_lib, *objs],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed (exit {res.returncode}):\n{res.stderr}")
        os.replace(tmp_lib, LIB)
    finally:
        shutil.rmtree(tmp_dir, ignore_errors=True)
    return "".join(report)


def load() -> ctypes.CDLL:
    """The kernel library, built on first use, with every C entry point typed
    (pointers and the stream as c_void_p, so none is cut to 32 bits)."""
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(LIB)
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.spmm_dense_acc_f32.argtypes = [vp, vp, vp, vp, vp, i64, i64, vp]
        lib.spmm_dense_acc_csr_panel_f32.argtypes = [*[vp] * 6, i64, i64, vp, i64, vp, i64,
                                                     i64, i64, vp]
        lib.spmm_band_f32.argtypes = [vp, vp, vp, vp, vp, vp, vp, i64, i64, i64, i32, vp]
        lib.spmm_group_dot_u8.argtypes = [vp, vp, vp, vp, vp, vp, i64, i64, i64, i32, i32, vp]
        lib.sdd_block_scores_f32.argtypes = [vp, vp, vp, vp, vp, i64, i64, i64, i64, vp]
        lib.sortmerge_rows.argtypes = [vp, vp, vp, vp, vp, vp, i64, i64, i32, vp]
        lib.coalesce_blocks.argtypes = [vp, i64, i64, i64, i32, i32, *[vp] * 9, *[i64] * 4, vp]
        lib.esc_counts.argtypes = [vp, vp, i64, vp, i64, vp, vp]
        lib.esc_expand.argtypes = [vp, i64, vp, i64, vp, vp, vp, vp, i64, i64, vp, vp, vp,
                                   i64, i64, vp, vp, i32, vp]
        lib.esc_merge_tiles.argtypes = [vp, vp, vp, i64, vp, i64, i32, vp]
        lib.esc_merge_carry.argtypes = [vp, i64, i64, vp, i64, vp, vp, i64, i64, vp, i32, vp]
        lib.esc_merge_emit.argtypes = [vp, vp, vp, i64, vp, i64, vp, i64, i64, vp, vp, vp, vp,
                                       i32, vp]
        lib.esc_merge_rows.argtypes = [vp, vp, i64, i64, vp, vp]
        lib.panel_count.argtypes = [vp, i64, i64, vp, vp, i32, vp]
        lib.panel_pack.argtypes = [vp, i64, i64, i64, vp, vp, vp, vp, vp, i32, vp]
        for fn in (lib.spmm_dense_acc_f32, lib.spmm_dense_acc_csr_panel_f32, lib.spmm_band_f32,
                   lib.spmm_group_dot_u8, lib.sdd_block_scores_f32, lib.sortmerge_rows,
                   lib.coalesce_blocks, lib.esc_counts, lib.esc_expand, lib.esc_merge_tiles,
                   lib.esc_merge_carry, lib.esc_merge_emit, lib.esc_merge_rows, lib.panel_count,
                   lib.panel_pack):
            fn.restype = i32
        for fn in (lib.spmm_dense_acc_max_cols, lib.spmm_band_max_cols,
                   lib.spmm_group_dot_max_cols, lib.sdd_block_scores_max_pairs,
                   lib.sortmerge_rows_max_l):
            fn.argtypes = []
            fn.restype = i64
        lib.spmm_dense_acc_panel_cols.argtypes = [i64, i64]
        lib.spmm_dense_acc_panel_cols.restype = i64
        lib.spmm_error_string.argtypes = [i32]
        lib.spmm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib
