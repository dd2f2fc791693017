"""Native host helpers, bound with ctypes: copies of the reference's
``core/native/sort_native.cpp`` (stable LSD radix argsort) and
``scatter_native.cpp`` (grid scatter at unique positions), which the layout
builders use, ``logfmt_native.cpp`` (report blocks to TSV), which
``harness/logfmt.py`` uses, and ``factor_native.cpp`` (ILU(0), IC(0) and
the levels of a triangular solve), which ``ops/ilu.py`` and
``ops/sptrsv.py`` use.

Each source builds at first use with the host's C++ compiler (``g++ -O3
-fopenmp``) into the package's git-ignored ``_build/`` directory, under a
name that carries a hash of the source and the flags.  Where no compiler is
present, or the build fails, the callers in ``core/hostmem.py``,
``ops/ilu.py`` and ``ops/sptrsv.py`` use numpy, which gives the same
arrays, and ``harness/logfmt.py`` its Python formatter, which gives the
same table.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "_build")
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-fopenmp")

_lock = threading.Lock()
_libs = {}


def _build(src: str) -> Optional[str]:
    """The shared library of ``src``, built unless a build of the same
    source and flags exists; None when the build fails."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(" ".join(FLAGS).encode() + f.read())
    stem = os.path.splitext(os.path.basename(src))[0]
    lib = os.path.join(BUILD_DIR, f"{stem}_{digest.hexdigest()[:16]}.so")
    if os.path.exists(lib):
        return lib
    tmp = f"{lib}.{os.getpid()}.tmp"
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        subprocess.run(["g++", *FLAGS, src, "-o", tmp], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, lib)
        return lib
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.remove(tmp)
        return None


def _get_lib(src_name: str) -> Optional[ctypes.CDLL]:
    with _lock:
        if src_name not in _libs:
            path = _build(os.path.join(_DIR, src_name))
            try:
                _libs[src_name] = ctypes.CDLL(path) if path else None
            except OSError:
                _libs[src_name] = None
        return _libs[src_name]


def radix_argsort(keys: np.ndarray) -> Optional[np.ndarray]:
    """Stable argsort of non-negative integer keys (int64 permutation), or
    None when the library is unavailable."""
    lib = _get_lib("sort_native.cpp")
    if lib is None:
        return None
    fn = lib.radix_argsort_u64
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS"),
                       ctypes.c_int64,
                       np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")]
    k = np.ascontiguousarray(keys).view(np.uint64) \
        if keys.dtype == np.int64 else \
        np.ascontiguousarray(keys.astype(np.uint64))
    out = np.zeros(len(k), dtype=np.int64)
    return out if fn(k, len(k), out) == 0 else None


_SCATTER = {np.dtype(np.int8): "grid_scatter_i8",
            np.dtype(np.float32): "grid_scatter_f32",
            np.dtype(np.float64): "grid_scatter_f64"}


def grid_scatter(grid: np.ndarray, rows: np.ndarray, lanes: np.ndarray,
                 vals) -> bool:
    """grid[rows, lanes] = vals over a C-contiguous 2-D grid, positions
    unique; False when the library or the grid's type is unavailable."""
    name = _SCATTER.get(grid.dtype)
    if name is None or grid.ndim != 2 or not grid.flags.c_contiguous:
        return False
    lib = _get_lib("scatter_native.cpp")
    if lib is None:
        return False
    fn = getattr(lib, name)
    if fn.argtypes is None:
        p = np.ctypeslib.ndpointer(grid.dtype, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        fn.restype = ctypes.c_int
        fn.argtypes = [p, ctypes.c_int64, i64p, i64p, p, ctypes.c_int64]
    rows = np.ascontiguousarray(rows, np.int64)
    lanes = np.ascontiguousarray(lanes, np.int64)
    vals_a = np.ascontiguousarray(np.broadcast_to(vals, rows.shape),
                                  grid.dtype)
    fn(grid, grid.shape[1], rows, lanes, vals_a, len(rows))
    return True


def format_logs(text: str, extra_keys=None) -> Optional[str]:
    """The TSV table of the report blocks in ``text`` (``extra_keys``
    after the default columns), or None when the library is unavailable."""
    lib = _get_lib("logfmt_native.cpp")
    if lib is None:
        return None
    fn, free = lib.spmv_format_logs, lib.spmv_free_text
    if fn.argtypes is None:
        fn.restype = ctypes.c_void_p
        fn.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        free.restype = None
        free.argtypes = [ctypes.c_void_p]
    ptr = fn(text.encode(), "\n".join(extra_keys or []).encode())
    if not ptr:
        return None
    try:
        return ctypes.string_at(ptr).decode()
    finally:
        free(ptr)


_I64P = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_F64P = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")


def _factor(name: str):
    """``name`` of the factor library with its argument types set, or None
    when the library is unavailable."""
    lib = _get_lib("factor_native.cpp")
    if lib is None:
        return None
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int64
        fn.argtypes = ([ctypes.c_int64, _I64P, _I64P, ctypes.c_int64, _I64P]
                       if name == "spmv_tri_levels" else
                       [ctypes.c_int64, _I64P, _I64P, _F64P])
    return fn


def ilu0_csr(rp: np.ndarray, cols: np.ndarray, vals: np.ndarray):
    """ILU(0) in place on the float64 ``vals`` of row-sorted CSR arrays:
    0 on success, the failing row + 1 at a zero or absent pivot, None when
    the library is unavailable."""
    fn = _factor("spmv_ilu0")
    if fn is None:
        return None
    return int(fn(len(rp) - 1, np.ascontiguousarray(rp, np.int64),
                  np.ascontiguousarray(cols, np.int64), vals))


def ic0_csr(rp: np.ndarray, cols: np.ndarray, vals: np.ndarray):
    """IC(0) in place on lower-triangular CSR arrays; returns as
    ``ilu0_csr`` (the failing row + 1 at a non-positive pivot or a row with
    no diagonal)."""
    fn = _factor("spmv_ic0")
    if fn is None:
        return None
    return int(fn(len(rp) - 1, np.ascontiguousarray(rp, np.int64),
                  np.ascontiguousarray(cols, np.int64), vals))


def tri_levels(rp: np.ndarray, cols: np.ndarray, *, lower: bool):
    """The dependency level of each row of a triangular matrix's
    off-diagonal CSR pattern (1 + the deepest level it reads, 0 for none),
    int64; None when the library is unavailable."""
    fn = _factor("spmv_tri_levels")
    if fn is None:
        return None
    level = np.zeros(len(rp) - 1, dtype=np.int64)
    fn(len(rp) - 1, np.ascontiguousarray(rp, np.int64),
       np.ascontiguousarray(cols, np.int64), 1 if lower else 0, level)
    return level
