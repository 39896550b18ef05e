"""ctypes loader for the shared C++ CSR oracle (``sparsetpu/native/oracle.cpp``).

The port compiles the JAX package's oracle source by path, without importing
``sparsetpu`` (which would import jax), with the same g++ flags.  The library
goes into the port's own git-ignored build directory and is built under a
temporary name and then renamed into place, so concurrent first uses (test
workers) never load a half-written file.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from typing import Optional, Tuple

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(os.path.dirname(_PKG), "sparsetpu", "native", "oracle.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
_SO = os.path.join(BUILD_DIR, "liboracle.so")

_lib: Optional[ctypes.CDLL] = None


def _build() -> str:
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(SRC):
        return _SO
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run(
            ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
             "-pthread", "-o", tmp, SRC],
            capture_output=True, text=True,
        )
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SRC}:\n{res.stderr}")
        os.replace(tmp, _SO)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return _SO


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(_build())
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        _lib.spgemm_u64_symbolic.restype = ctypes.c_int64
        _lib.spgemm_u64_symbolic.argtypes = [
            ctypes.c_int64, i64p, i32p, u64p, i64p, i32p, u64p, i64p,
            ctypes.c_int32,
        ]
        _lib.spgemm_u64_numeric.restype = None
        _lib.spgemm_u64_numeric.argtypes = [
            ctypes.c_int64, i64p, i32p, u64p, i64p, i32p, u64p, i64p, i32p,
            u64p, ctypes.c_int32,
        ]
    return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


HostCsr = Tuple[np.ndarray, np.ndarray, np.ndarray]  # row_ptr i64, col i32, val u64


def as_host_csr(row_ptr, col_idx, values) -> HostCsr:
    return (
        np.ascontiguousarray(row_ptr, np.int64),
        np.ascontiguousarray(col_idx, np.int32),
        np.ascontiguousarray(values, np.uint64),
    )


def spgemm(a: HostCsr, b: HostCsr, n: int, n_threads: int = 0) -> HostCsr:
    """C = A x B on the saturating-u64 semiring (two-pass native kernel)."""
    if n_threads <= 0:
        n_threads = os.cpu_count() or 1
    L = lib()
    arp, ac, av = a
    brp, bc, bv = b
    crp = np.zeros(n + 1, np.int64)
    nnz = L.spgemm_u64_symbolic(
        n, _ptr(arp, ctypes.c_int64), _ptr(ac, ctypes.c_int32),
        _ptr(av, ctypes.c_uint64), _ptr(brp, ctypes.c_int64),
        _ptr(bc, ctypes.c_int32), _ptr(bv, ctypes.c_uint64),
        _ptr(crp, ctypes.c_int64), n_threads,
    )
    cc = np.zeros(max(nnz, 1), np.int32)
    cv = np.zeros(max(nnz, 1), np.uint64)
    L.spgemm_u64_numeric(
        n, _ptr(arp, ctypes.c_int64), _ptr(ac, ctypes.c_int32),
        _ptr(av, ctypes.c_uint64), _ptr(brp, ctypes.c_int64),
        _ptr(bc, ctypes.c_int32), _ptr(bv, ctypes.c_uint64),
        _ptr(crp, ctypes.c_int64), _ptr(cc, ctypes.c_int32),
        _ptr(cv, ctypes.c_uint64), n_threads,
    )
    return crp, cc[:nnz], cv[:nnz]
