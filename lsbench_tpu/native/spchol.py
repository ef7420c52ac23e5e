"""ctypes binding for the native sparse-Cholesky symbolic and numeric
factorization and triangular solve (spchol.cpp)."""

from __future__ import annotations

import ctypes

import numpy as np

from lsbench_tpu.native import load_library

_lib = None


def _get_lib():
    global _lib
    if _lib is None:
        lib = load_library("spchol.cpp", "libspchol.so")
        i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        lib.lsb_chol_numeric.argtypes = [ctypes.c_longlong, i64, i32, f64,
                                         i64, i64, i64, i64, f64]
        lib.lsb_chol_numeric.restype = ctypes.c_longlong
        lib.lsb_tri_solve.argtypes = [ctypes.c_longlong, ctypes.c_longlong,
                                      i64, i64, f64, f64, f64]
        lib.lsb_tri_solve.restype = None
        lib.lsb_etree.argtypes = [ctypes.c_longlong, i64, i32, i64]
        lib.lsb_etree.restype = None
        lib.lsb_symbolic_rows.argtypes = [
            ctypes.c_longlong, i64, i32, i64, i64,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.lsb_symbolic_rows.restype = None
        _lib = lib
    return _lib


def tri_solve(cp, ci, cx, b) -> np.ndarray:
    """Host CSC triangular solve x = (L Lᵀ)⁻¹ b; b (n,) or (n, k) —
    the CPU solve the reference's default CHOLMOD backend times
    (cholmod-impl.h:44-63, useGPU=0)."""
    lib = _get_lib()
    b = np.asarray(b, dtype=np.float64)
    squeeze = b.ndim == 1
    b2 = b[:, None] if squeeze else b
    n, k = b2.shape
    x = np.empty((k, n), dtype=np.float64)
    lib.lsb_tri_solve(int(n), int(k),
                      np.ascontiguousarray(cp, np.int64),
                      np.ascontiguousarray(ci, np.int64),
                      np.ascontiguousarray(cx, np.float64),
                      np.ascontiguousarray(b2.T), x)
    return x[0] if squeeze else x.T


def etree(n, offs, cols) -> np.ndarray:
    """Native elimination tree (sparse_cholesky.elimination_tree)."""
    lib = _get_lib()
    parent = np.empty(int(n), dtype=np.int64)
    lib.lsb_etree(int(n), np.ascontiguousarray(offs, np.int64),
                  np.ascontiguousarray(cols, np.int32), parent)
    return parent


def symbolic_rows(n, offs, cols, parent) -> tuple[np.ndarray, np.ndarray]:
    """Native strictly-lower row pattern of L
    (sparse_cholesky.symbolic_rows): (loffs, lcols), rows ascending."""
    lib = _get_lib()
    offs = np.ascontiguousarray(offs, np.int64)
    cols = np.ascontiguousarray(cols, np.int32)
    parent = np.ascontiguousarray(parent, np.int64)
    counts = np.zeros(int(n), dtype=np.int64)
    lib.lsb_symbolic_rows(int(n), offs, cols, parent, counts, None, None)
    loffs = np.zeros(int(n) + 1, dtype=np.int64)
    np.cumsum(counts, out=loffs[1:])
    lcols = np.empty(int(loffs[-1]), dtype=np.int64)
    lib.lsb_symbolic_rows(int(n), offs, cols, parent, counts,
                          loffs.ctypes.data, lcols.ctypes.data)
    return loffs, lcols


def chol_numeric(n, a_offs, a_cols, a_vals, cp, ci, lrow_offs, lrow_cols
                 ) -> np.ndarray:
    """Native numeric factorization over the symbolic pattern. Same
    algorithm as sparse_cholesky.numeric_factor; raises LinAlgError on a
    non-positive pivot with the same message shape."""
    lib = _get_lib()
    cx = np.zeros(int(cp[-1]), dtype=np.float64)
    rc = lib.lsb_chol_numeric(
        int(n),
        np.ascontiguousarray(a_offs, np.int64),
        np.ascontiguousarray(a_cols, np.int32),
        np.ascontiguousarray(a_vals, np.float64),
        np.ascontiguousarray(cp, np.int64),
        np.ascontiguousarray(ci, np.int64),
        np.ascontiguousarray(lrow_offs, np.int64),
        np.ascontiguousarray(lrow_cols, np.int64),
        cx)
    if rc != 0:
        raise np.linalg.LinAlgError(
            f"matrix not positive definite at column {rc - 1}")
    return cx
