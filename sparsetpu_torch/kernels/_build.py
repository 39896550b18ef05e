"""Build and load the port's CUDA kernels (``sparsetpu_torch/csrc``).

On first use, nvcc compiles every source in ``csrc/`` for Hopper (sm_90a)
into one shared library with a plain C interface, loaded with ctypes; no
PyTorch headers are involved, so a build takes seconds.  The library goes
into the git-ignored ``sparsetpu_torch/_build/``, is rebuilt whenever a
source is newer, and is written under a temporary name and renamed into
place, so concurrent first uses never load a half-written file.  Nothing
here runs at import time: the CPU tests import every module on hosts that
have no nvcc.
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
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

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
    """Compile the kernels if the library is missing or older than a source.
    Returns nvcc's report (ptxas registers, spills) of this build, or "" if
    the library was up to date.  Raises RuntimeError with nvcc's stderr on
    failure."""
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    if os.path.exists(LIB) and all(
            os.path.getmtime(LIB) >= os.path.getmtime(s) for s in sources):
        return ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources],
            capture_output=True, text=True,
        )
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed (exit {res.returncode}):\n{res.stderr}")
        os.replace(tmp, LIB)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return res.stdout + res.stderr


def load() -> ctypes.CDLL:
    """The kernel library, built on first use, with every C entry point typed
    (pointers and the stream as c_void_p, so none is cut to 32 bits)."""
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(LIB)
        vp, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.spmm_dense_acc_f32.argtypes = [vp, vp, vp, vp, vp, i64, i64, vp]
        lib.spmm_dense_acc_f32.restype = ctypes.c_int
        lib.spmm_dense_acc_max_cols.argtypes = []
        lib.spmm_dense_acc_max_cols.restype = i64
        lib.spmm_error_string.argtypes = [ctypes.c_int]
        lib.spmm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib
