"""Build the CUDA sources of ``csrc/`` at first use and load them with ctypes.

Every ``csrc/*.cu`` compiles, with ``nvcc -gencode arch=compute_90a,code=sm_90a
-O3 -Xcompiler -fPIC -c``, into an object of its own (one nvcc per source, all
started together), and ``nvcc -shared`` links the objects into one shared
library with a plain C interface under ``_build/`` (listed in .gitignore).
The file name carries ``sources_digest()``, a hash of the flags and of every
file under ``csrc/`` (sources and the headers they share), so an unchanged
tree reuses its build and an edited header rebuilds it.  The sources include
only the CUDA runtime's headers: no PyTorch headers, and nothing is
downloaded.  Building needs the CUDA toolkit (``nvcc`` on PATH, or under
``$CUDA_HOME`` or ``/usr/local/cuda``).

A build that fails, and a launch that a wrapper's check finds failed, raise
``KernelError``.  It subclasses ``RuntimeError`` but is never one of the
guard errors (``ValueError``, ``TypeError``, ``MemoryError``, a CUDA
out-of-memory error) on which ``auto`` and the driver's retry exclude a
candidate: a broken kernel stops the run instead of handing the matrix to
another engine.
"""
from __future__ import annotations

import ctypes
import dataclasses
import glob
import hashlib
import os
import shutil
import subprocess
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
SOURCE_SUFFIXES = (".cu", ".cuh", ".h")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class KernelError(RuntimeError):
    """A CUDA kernel of the port failed to build or to launch."""


_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    # uids sg0 sg1 win lane sub val hm1 idx x out | H T m planes | stream
    "slab_spmv_f32": [_P] * 11 + [_I] * 4 + [_P],
    "slab_spmv_f64": [_P] * 11 + [_I] * 4 + [_P],
    # uids win lane sub val hm1 idx sig x out | H T m planes kblk | stream
    "slab_spmv_blk_f32": [_P] * 10 + [_I] * 5 + [_P],
    # ybase win lane sub val hm1 dest x y | H T m planes n_y span | stream
    "slab_spmv_rows_f32": [_P] * 9 + [_I] * 6 + [_P],
    "slab_spmv_rows_f64": [_P] * 9 + [_I] * 6 + [_P],
    "slab_spmv_rows_bf16": [_P] * 9 + [_I] * 6 + [_P],
    # uids sg0 sg1 win lane sub val hm1 idx x out | H T m planes B | stream
    "slab_spmm_f32": [_P] * 11 + [_I] * 5 + [_P],
    "slab_spmm_bf16": [_P] * 11 + [_I] * 5 + [_P],
    # win lane sub val x out | H T m | stream
    "xch_mul_f32": [_P] * 6 + [_I] * 3 + [_P],
    "xch_mul_f64": [_P] * 6 + [_I] * 3 + [_P],
    "xch_mul_bf16": [_P] * 6 + [_I] * 3 + [_P],
    # gids off cs win lane sub hm1 sig idx prod out
    # | H T m kblk p_oh n_grp gb p1 | stream
    "xch_route4_f32": [_P] * 11 + [_I] * 8 + [_P],
    "xch_route4_f64": [_P] * 11 + [_I] * 8 + [_P],
    # base cs win lane sub hm1 dest prod y | H T m p1 n_y span | stream
    "xch_route4_rows_f32": [_P] * 9 + [_I] * 6 + [_P],
    "xch_route4_rows_f64": [_P] * 9 + [_I] * 6 + [_P],
    "xch_route4_rows_bf16": [_P] * 9 + [_I] * 6 + [_P],
    # base val2 col2 hm1 dest x y | H T n_y span | stream
    "xch_fused_rows_f32": [_P] * 7 + [_I] * 4 + [_P],
    "xch_fused_rows_f64": [_P] * 7 + [_I] * 4 + [_P],
    "xch_fused_rows_bf16": [_P] * 7 + [_I] * 4 + [_P],
    # win lane sub val x out | H T m B | stream
    "xch_mul_panel_f32": [_P] * 6 + [_I] * 4 + [_P],
    "xch_mul_panel_bf16": [_P] * 6 + [_I] * 4 + [_P],
    # gids off cs win lane sub hm1 sig idx prod out
    # | H T m kblk p_oh n_grp gb p1 B n_chunks | stream
    "xch_route4_panel_f32": [_P] * 11 + [_I] * 10 + [_P],
    "xch_route4_panel_bf16": [_P] * 11 + [_I] * 10 + [_P],
    # uids cs sg0 sg1 win lane sub hm1 idx prod out
    # | H T m planes pg p1 n_out R | stream
    "xch_route_f32": [_P] * 11 + [_I] * 8 + [_P],
    "xch_route_bf16": [_P] * 11 + [_I] * 8 + [_P],
    # members lane src val x out | H W gran m | stream
    "block_gather_mul_f32": [_P] * 6 + [_I] * 4 + [_P],
    "block_gather_mul_bf16": [_P] * 6 + [_I] * 4 + [_P],
    # prod hm1 idx out | rb_pad G K | stream
    "bucket_reduce_f32": [_P] * 4 + [_I] * 3 + [_P],
    # prod hm1 idx out | CB nu_pad K | stream
    "bucket_reduce_grouped_f32": [_P] * 4 + [_I] * 3 + [_P],
    # prod hm1r dest yrow y | H sh nu_pad rg n_y parts | stream
    "bucket_rows_f32": [_P] * 5 + [_I] * 6 + [_P],
    "bucket_rows_bf16": [_P] * 5 + [_I] * 6 + [_P],
    # members lane src val x hm1r dest yrow y
    # | H gran m sh nu_pad rg n_y parts | stream
    "bucket_fused_rows_f32": [_P] * 9 + [_I] * 8 + [_P],
    "bucket_fused_rows_bf16": [_P] * 9 + [_I] * 8 + [_P],
    # ptrs ints (host) | n_pass | y | rb n_y | stream
    "ellg_rows_f32": [_P, _P, _I, _P, _I, _I, _P],
    "ellg_rows_bf16": [_P, _P, _I, _P, _I, _I, _P],
    # yt src_lane src_chunk out | rows cols | stream
    "lane_unpermute_f32": [_P] * 4 + [_I] * 2 + [_P],
    # prod heads out | H W | stream
    "segmented_scan_tiles_f32": [_P] * 3 + [_I] * 2 + [_P],
    "segmented_scan_tiles_f64": [_P] * 3 + [_I] * 2 + [_P],
    "segmented_scan_tiles_bf16": [_P] * 3 + [_I] * 2 + [_P],
    # bids col val heads x out | H W B | stream
    "block_gather_scan_f32": [_P] * 6 + [_I] * 3 + [_P],
    "block_gather_scan_f64": [_P] * 6 + [_I] * 3 + [_P],
    "block_gather_scan_bf16": [_P] * 6 + [_I] * 3 + [_P],
    # col val x blk sub sel out | n w kind a b | stream
    "probe_gather_f32": [_P] * 7 + [_I] * 5 + [_P],
    "probe_gather_bf16": [_P] * 7 + [_I] * 5 + [_P],
    # bins val out | G | stream
    "probe_onehot_f32": [_P] * 3 + [_I] + [_P],
    # offs v out | T rows | stream
    "probe_dynslice_f32": [_P] * 3 + [_I] * 2 + [_P],
    # heads val out | G steps heads_i8 | stream
    "probe_segscan_f32": [_P] * 3 + [_I] * 3 + [_P],
    # in out | CB NU S | stream
    "probe_transpose_f32": [_P] * 2 + [_I] * 3 + [_P],
    # uids base lane sub val hm1 idx x out | H T S8 NU stage R | stream
    "probe_slab_f32": [_P] * 9 + [_I] * 6 + [_P],
}


@dataclasses.dataclass(frozen=True)
class Build:
    path: str             # the shared library
    commands: tuple       # the nvcc commands that build it, link last
    seconds: float        # compile time; 0.0 when a cached build was reused
    log: str              # nvcc's output: ptxas registers and shared memory


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise KernelError("nvcc not found: the CUDA kernels build only where "
                      "the CUDA toolkit is installed")


def sources_digest(csrc_dir: str = CSRC_DIR) -> str:
    """Hash of the flags and of every source and header under ``csrc_dir``:
    the build's identity."""
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(csrc_dir, "**", "*"),
                                 recursive=True)):
        if path.endswith(SOURCE_SUFFIXES):
            with open(path, "rb") as f:
                digest.update(os.path.relpath(path, csrc_dir).encode()
                              + b"\0" + f.read())
    return digest.hexdigest()[:16]


def _run_all(cmds):
    """Runs the commands in parallel; raises on the first that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    for c, p, log in zip(cmds, procs, logs):
        if p.returncode != 0:
            raise KernelError(f"nvcc failed (exit {p.returncode}):\n"
                              f"{' '.join(c)}\n{log}")
    return "".join(logs)


def build() -> Build:
    """Compile ``csrc/*.cu`` unless a build of the same sources exists."""
    srcs = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    lib = os.path.join(BUILD_DIR, f"kernels_{sources_digest()}.so")
    work = f"{lib}.{os.getpid()}.tmp"
    objs = [os.path.join(work, os.path.basename(s) + ".o") for s in srcs]
    compiles = tuple((nvcc(), *FLAGS, "-c", "-o", o, s)
                     for s, o in zip(srcs, objs))
    linked = os.path.join(work, "kernels.so")
    link = (nvcc(), *FLAGS[:2], "-shared", "-o", linked, *objs)
    if os.path.exists(lib):
        with open(lib + ".log") as f:
            return Build(lib, (*compiles, link), 0.0, f.read())
    os.makedirs(work, exist_ok=True)
    try:
        t0 = time.perf_counter()
        log = _run_all(compiles) + _run_all([link])
        seconds = time.perf_counter() - t0
        with open(lib + ".log", "w") as f:
            f.write(log)
        os.replace(linked, lib)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return Build(lib, (*compiles, link), seconds, log)


_lib = None


def load() -> ctypes.CDLL:
    """The kernels' library, built on first use and loaded once."""
    global _lib
    if _lib is None:
        path = build().path
        try:
            lib = ctypes.CDLL(path)
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        except (OSError, AttributeError) as e:
            raise KernelError(f"kernel library {path}: {e}") from e
        _lib = lib
    return _lib
