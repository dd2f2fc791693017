"""Slab SpMV kernels: the wrappers of ``csrc/slab.cu`` and their plain
PyTorch versions.

``slab_spmv_rows`` is the spmv path, for the unit and the block route
alike: the function of the Pallas ``slab_spmv``, ``slab_spmv_blk`` and
``slab_spmv_df`` (``singlespmv_tpu/ops/pallas/slab.py`` :263, :310 and
:463), routed by a run-end destination stream (``ybase``, ``dest``) that
``formats/slab.py:route_rows`` derives from the reference's ``uids``,
``idx``, ``sig``/``sg0``/``sg1`` and ``unit_ids``, adding into the
caller's y where the Pallas functions return out blocks.

``slab_spmv`` (unit route), ``slab_spmv_blk`` (block route) and
``slab_spmm`` (unit route over a panel of columns) take the arguments of their
Pallas counterparts (:263, :310 and :228) and return the same out blocks,
but for the panel's layouts:
``slab_spmm`` takes the interleaved (CB, 128, B) panel, whose slot column
holds its B values contiguously, where the reference takes B (CB, 128)
tables, returns its out blocks as (nu·planes, 128, B), each row's B
columns contiguous, where the reference returns (nu·B·planes, 128), and it
takes the steps' sg0/sg1, as ``slab_spmv`` does, to route only their
planes.  The kernels of ``slab_spmv`` and ``slab_spmv_blk``, the first
port, run on no path: they stay for ``harness/slab_ab.py`` and the parity
tests, whose plain versions hold them against the Pallas kernels.  On a
CUDA tensor a wrapper launches its kernel, or raises; on a CPU tensor it
runs the plain version (``<wrapper>_ref``), which the tests hold against
the Pallas kernels and ``chip_smoke.py`` holds against the kernels on the
card.

The value type is float32 or float64, the same for val, the x table and the
out blocks or y.  At float64 ``slab_spmv_rows`` and ``slab_spmv`` launch
the native-fp64 builds of their kernels, which stand for the df64 kernel
``slab_spmv_df`` of the reference; ``slab_spmv_blk`` is float32 only, as
the reference's float64 plans are unit mode only.  ``slab_spmv_rows`` also
takes bfloat16 val and x table (``SPMV_TYPES``), and the panel ``slab_spmm``
takes float32 or bfloat16 (``PANEL_TYPES``), as the TPU ran it: their
bfloat16 kernels read val and x as 2 bytes a value and sum in float32 into
a float32 y or out (``acc_dtype``), which the caller rounds once; they never
widen them to run the float32 kernel.

Each wrapper counts the launches of its float32 kernel in
``<wrapper>.launches``, of its float64 kernel in ``<wrapper>.launches_f64``
and of its bfloat16 kernel in ``<wrapper>.launches_bf16``.

Out blocks that no grid step owns (``lo_mask`` of the format is 0 there) come
back zero here, where the TPU leaves them unwritten.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.dtypes import acc, acc_dtype
from . import _build

LANES = 128
VALUE_TYPES = (torch.float32, torch.float64)
SPMV_TYPES = VALUE_TYPES + (torch.bfloat16,)   # the spmv kernels' values
# the SpMM panel kernels': the TPU's (singlespmv_tpu/ops/pallas/__init__.py:
# supports admits float32 and bfloat16; its float64 SpMM loops the spmv)
PANEL_TYPES = (torch.float32, torch.bfloat16)
UNIT_PLANES = (8, 16)
BLK_PLANES = (8, 16, 32)
BLK_KBLK = (1, 2, 4)
ROWS_PLANES_MAX = 32      # ybase entries a step: one lane of a warp each
MERGE_SMEM = 128 * 1024   # the merge kernel's 8 spans of shared memory
MERGE_WARPS = 8


def _check(name, t, dtype, shape, device, aligned=True):
    """Raises unless ``t`` is a contiguous tensor of ``dtype`` and ``shape``
    on ``device``, on a card starting on 16 bytes unless not ``aligned``."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the call on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous (copy with .contiguous())")
    if aligned and t.device.type == "cuda" and t.data_ptr() % 16:
        raise ValueError(f"{name} is not 16-byte aligned")


def value_type(t, types=VALUE_TYPES):
    """The value type of a kernel call, from one of its value tensors."""
    if t.dtype not in types:
        raise TypeError(f"the kernels take values of {types}, not {t.dtype}")
    return t.dtype


def _check_table(name, t, vt, dev, rank=2):
    """``t`` is a contiguous (CB, 128) x table (rank 2) or interleaved
    (CB, 128, B) panel (rank 3) of type ``vt`` on ``dev``, with B ≥ 1."""
    if t.dim() != rank or t.shape[1] != LANES or not all(t.shape):
        want = "(CB, 128)" if rank == 2 else "(CB, 128, B)"
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {want}")
    _check(name, t, vt, t.shape, dev)


def _check_stream(lane, val, hm1, sub, win, x_table, T, types=VALUE_TYPES,
                  rank=2):
    """Checks shared by the kernels; ``x_table`` is a table or, at rank 3, a
    panel of tables.  Returns (H, n_steps, device, value type)."""
    dev = x_table.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"slab kernels run on cuda (or cpu: plain version), "
                         f"not {dev.type}")
    h = lane.shape[0]
    if T < 1 or h % T:
        raise ValueError(f"stream rows {h} are not a multiple of T={T}")
    vt = value_type(val, types)
    for name, t, dt in (("lane", lane, torch.int8), ("sub", sub, torch.int8),
                        ("hm1", hm1, torch.int8), ("val", val, vt)):
        _check(name, t, dt, (h, LANES), dev)
    _check("win", win, torch.int32, (h,), dev)
    _check_table("x_table", x_table, vt, dev, rank)
    return h, h // T, dev, vt


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _raise_on(rc, name):
    if rc != 0:
        raise _build.KernelError(f"{name}: CUDA kernel launch failed with "
                                 f"cudaError {rc}")


_SUFFIX = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16"}


def _entry(name, vt):
    """The C entry of kernel ``name`` for value type ``vt``."""
    return getattr(_build.load(), f"{name}_{_SUFFIX[vt]}")


def _count(wrapper, vt):
    """One more launch of ``wrapper``'s kernel for value type ``vt``."""
    if vt == torch.float64:
        wrapper.launches_f64 += 1
    elif vt == torch.bfloat16:
        wrapper.launches_bf16 += 1
    else:
        wrapper.launches += 1


# ----------------------------------------------------- plain PyTorch versions

def _gather(win, lane, sub, table, m):
    """g[r, l] = table[win[r] + sub[r, l], lane[r, l]] (sub unread if
    m == 1), for any int tensor of window rows ``win``."""
    col = win.long()[:, None] * LANES + lane.long()
    if m > 1:
        col = col + sub.long() * LANES
    return table.reshape(-1)[col]


def _totals(p, hm1):
    """W[r, l] = P[r, l] − P[r, hm1[r, l]], P the row prefix of p."""
    prefix = torch.cumsum(p, dim=1)
    h = hm1.long()
    head = torch.gather(prefix, 1, h.clamp(min=0))
    return prefix - torch.where(h >= 0, head, 0.0)


def _picked(w, e):
    """w[r, e[r, l]] where e >= 0, else 0."""
    e = e.long()
    return torch.where(e >= 0, torch.gather(w, 1, e.clamp(min=0)), 0.0)


def slab_spmv_ref(uids, sg0, sg1, win, lane, sub, val, hm1, idx, x_table,
                  nu: int, m: int, T: int = 64):
    """Plain version of ``slab_spmv``.  It routes every plane; sg0/sg1 only
    prune planes that hold no end-lane, so ignoring them changes nothing.
    bfloat16 values (the panel's, column by column) are widened and summed
    in float32, into float32 out blocks."""
    planes, h = idx.shape[0], lane.shape[0]
    w = _totals(acc(val) * acc(_gather(win, lane, sub, x_table, m)), hm1)
    step = torch.arange(h, device=w.device) // T
    base = uids.long()[step] * planes                      # (H,)
    out = torch.zeros(nu * planes, LANES, dtype=w.dtype, device=w.device)
    for s in range(planes):
        out.index_add_(0, base + s, _picked(w, idx[s]))
    return out


def slab_spmv_blk_ref(uids, win, lane, sub, val, hm1, idx, sig, x_table,
                      nb: int, m: int, planes: int, T: int = 128):
    """Plain version of ``slab_spmv_blk``."""
    h = lane.shape[0]
    w = _totals(val * _gather(win, lane, sub, x_table, m), hm1)
    step = torch.arange(h, device=w.device) // T
    base = uids.long()[step] * planes                      # (H,)
    s = sig[:, 0].long()
    out = torch.zeros(nb * planes, LANES, dtype=val.dtype, device=w.device)
    for j in range(idx.shape[0]):
        p = s + j
        keep = ((p >= 0) & (p < planes))[:, None]          # one-hot range
        out.index_add_(0, base + p.clamp(0, planes - 1),
                       torch.where(keep, _picked(w, idx[j]), 0.0))
    return out


def slab_spmv_rows_ref(ybase, win, lane, sub, val, hm1, dest, x_table, y,
                       m: int, T: int = 64, span: int = 0):
    """Plain version of ``slab_spmv_rows``: ``index_add_`` of the run totals
    at their destinations (``span`` picks a kernel, not a function);
    bfloat16 values are widened and summed in float32."""
    h = lane.shape[0]
    w = _totals(acc(val) * acc(_gather(win, lane, sub, x_table, m)), hm1)
    step = torch.arange(h, device=w.device) // T
    d = dest.long()
    base = ybase.long()[step[:, None], d.clamp(min=0) >> 7]
    pos = base + (d & (LANES - 1))
    keep = (d >= 0) & (base >= 0) & (pos < y.numel())
    return y.index_add_(0, pos[keep], w[keep])


def slab_spmm_ref(uids, sg0, sg1, win, lane, sub, val, hm1, idx, x_panel,
                  nu: int, m: int, T: int = 64):
    """Plain version of ``slab_spmm``: ``slab_spmv_ref`` of each column over
    the planes [sg0[t], sg1[t]] of each step t, as column b of the out
    blocks; at bfloat16 float32 products and sums into float32 out, as the
    kernel takes them."""
    planes, h, n_cols = idx.shape[0], lane.shape[0], x_panel.shape[-1]
    step = torch.arange(h, device=val.device) // T
    s = torch.arange(planes, device=val.device)[:, None]
    routed = (sg0.long()[step] <= s) & (s <= sg1.long()[step])  # (planes, H)
    pruned = torch.where(routed[..., None], idx, -1)
    return torch.stack([
        slab_spmv_ref(uids, sg0, sg1, win, lane, sub, val, hm1, pruned,
                      x_panel[..., b], nu, m, T) for b in range(n_cols)], -1)


# --------------------------------------------------------------- wrappers ---

def slab_spmv_rows(ybase, win, lane, sub, val, hm1, dest, x_table, y,
                   m: int, T: int = 64, span: int = 0):
    """Slab SpMV over one stream chunk, unit or block route: adds each run
    total of the stream into ``y`` at its destination; returns ``y``.

    ybase:   (n_steps, planes) int32 — y position of row 0 of each 128-row
             block p of the step's out block (planes ≤ 32), −1 where the
             block is dropped.
    win:     (H,) int32 — window base col-block per stream row.
    lane, sub, hm1: (H, 128) int8; val: (H, 128) float32, float64 or
             bfloat16.
    dest:    (H, 128) int16 — at a run's end slot, its position p·128 + l
             in the step's out block; −1 on every other slot.
    x_table: (CB, 128) of val's type.
    y:       (n,) of ``acc_dtype(val.dtype)`` (float32 for bfloat16 values),
             zeroed by the caller before its first call; positions at or
             past n are dropped.
    span:    0, each run end adds into y; or planes·128, where the stream's
             run ends pile onto few y rows (``formats/slab.py:route_rows``):
             the merge kernel sums a block's rows in shared memory first.
             The function is the same.
    The sums of a y position add in run-dependent order on the card."""
    h, n_steps, dev, vt = _check_stream(lane, val, hm1, sub, win, x_table,
                                        T, types=SPMV_TYPES)
    planes = ybase.shape[1] if ybase.dim() == 2 else 0
    if not 1 <= planes <= ROWS_PLANES_MAX:
        raise ValueError(f"ybase has shape {tuple(ybase.shape)}, expected "
                         f"(n_steps, planes) with planes in [1, "
                         f"{ROWS_PLANES_MAX}]")
    _check("ybase", ybase, torch.int32, (n_steps, planes), dev)
    _check("dest", dest, torch.int16, (h, LANES), dev)
    if span not in (0, planes * LANES):
        raise ValueError(f"merge span {span} is neither 0 nor planes·128 = "
                         f"{planes * LANES}")
    if MERGE_WARPS * span * acc_dtype(vt).itemsize > MERGE_SMEM:
        raise ValueError(f"merge span {span} of {vt} passes the merge "
                         f"kernel's {MERGE_SMEM} bytes of shared memory")
    if y.dim() != 1 or y.numel() >= 2 ** 31:
        raise ValueError(f"y has shape {tuple(y.shape)}, expected (n,) with "
                         "n < 2**31")
    _check("y", y, acc_dtype(vt), y.shape, dev)
    if dev.type == "cpu":
        return slab_spmv_rows_ref(ybase, win, lane, sub, val, hm1, dest,
                                  x_table, y, m, T, span)
    if h:
        rc = _entry("slab_spmv_rows", vt)(
            *map(_ptr, (ybase, win, lane, sub, val, hm1, dest, x_table, y)),
            h, T, m, planes, y.numel(), span,
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
        _raise_on(rc, "slab_spmv_rows")
        _count(slab_spmv_rows, vt)
    return y


def slab_spmv(uids, sg0, sg1, win, lane, sub, val, hm1, idx, x_table,
              nu: int, m: int, T: int = 64):
    """Unit-route slab SpMV over one stream chunk.

    uids:    (n_steps,) int32 — compact first unit per grid step.
    sg0/sg1: (n_steps,) int32 — first/last active σ plane per step.
    win:     (H,) int32 — window base col-block per stream row.
    lane, sub, hm1: (H, 128) int8; val: (H, 128) float32 or float64.
    idx:     (planes, H, 128) int8 — σ-plane end-lanes, −1 masked;
             planes 8 (one unit per block) or 16 (unit pairs).
    x_table: (CB, 128) of val's type.
    Returns (nu·planes, 128) of val's type."""
    h, n_steps, dev, vt = _check_stream(lane, val, hm1, sub, win, x_table,
                                        T)
    planes = idx.shape[0]
    if planes not in UNIT_PLANES:
        raise ValueError(f"unit route takes {UNIT_PLANES} planes, "
                         f"not {planes}")
    _check("idx", idx, torch.int8, (planes, h, LANES), dev)
    for name, t in (("uids", uids), ("sg0", sg0), ("sg1", sg1)):
        _check(name, t, torch.int32, (n_steps,), dev)
    if dev.type == "cpu":
        return slab_spmv_ref(uids, sg0, sg1, win, lane, sub, val, hm1, idx,
                             x_table, nu, m, T)
    out = torch.zeros(nu * planes, LANES, dtype=vt, device=dev)
    if h:
        rc = _entry("slab_spmv", vt)(
            *map(_ptr, (uids, sg0, sg1, win, lane, sub, val, hm1, idx,
                        x_table, out)),
            h, T, m, planes,
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
        _raise_on(rc, "slab_spmv")
        _count(slab_spmv, vt)
    return out


def slab_spmv_blk(uids, win, lane, sub, val, hm1, idx, sig, x_table,
                  nb: int, m: int, planes: int, T: int = 128):
    """Block-route slab SpMV over one stream chunk.

    uids: (n_steps,) int32 — compact first block slot per step.
    idx:  (kblk, H, 128) int8 — per group-block end-lanes, −1 masked.
    sig:  (H, 128) int8 — per stream row its block-slot offset from the
          step's first block slot, lane-replicated.
    Other arguments as in ``slab_spmv``, at float32 only.  Returns
    (nb·planes, 128) float32: out block f plane p sums the contributions to
    compact block slot f + p."""
    h, n_steps, dev, _ = _check_stream(lane, val, hm1, sub, win, x_table, T,
                                       types=(torch.float32,))
    kblk = idx.shape[0]
    if planes not in BLK_PLANES or kblk not in BLK_KBLK or planes % kblk:
        raise ValueError(f"block route takes planes {BLK_PLANES} and kblk "
                         f"{BLK_KBLK} dividing them, not {planes}, {kblk}")
    _check("idx", idx, torch.int8, (kblk, h, LANES), dev)
    _check("sig", sig, torch.int8, (h, LANES), dev)
    _check("uids", uids, torch.int32, (n_steps,), dev)
    if dev.type == "cpu":
        return slab_spmv_blk_ref(uids, win, lane, sub, val, hm1, idx, sig,
                                 x_table, nb, m, planes, T)
    out = torch.zeros(nb * planes, LANES, dtype=torch.float32, device=dev)
    if h:
        rc = _build.load().slab_spmv_blk_f32(
            *map(_ptr, (uids, win, lane, sub, val, hm1, idx, sig, x_table,
                        out)),
            h, T, m, planes, kblk,
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
        _raise_on(rc, "slab_spmv_blk")
        slab_spmv_blk.launches += 1
    return out


def slab_spmm(uids, sg0, sg1, win, lane, sub, val, hm1, idx, x_panel,
              nu: int, m: int, T: int = 64):
    """Unit-route slab SpMM over one stream chunk, float32 or bfloat16.

    val:     (H, 128) float32 or bfloat16.
    x_panel: (CB, 128, B) of val's type — the interleaved panel:
             x_panel[c, l] holds the B column values of x row c·128 + l.
    Other arguments as in ``slab_spmv``, which routes the same streams for
    one column; the panel too routes only the planes [sg0[t], sg1[t]] of
    each step (the converts leave idx −1 outside them; the TPU's panel
    routed every plane).  Returns (nu·planes, 128, B) float32, the
    accumulator of either value type (the caller rounds Y once): block u
    rows [u·planes, (u+1)·planes) hold its σ-planes, each lane's B columns
    contiguous (Y's own layout).  The sums of an out position add in
    run-dependent order on the card."""
    h, n_steps, dev, vt = _check_stream(lane, val, hm1, sub, win, x_panel,
                                        T, types=PANEL_TYPES, rank=3)
    planes, n_cols = idx.shape[0], x_panel.shape[-1]
    if planes not in UNIT_PLANES:
        raise ValueError(f"unit route takes {UNIT_PLANES} planes, "
                         f"not {planes}")
    _check("idx", idx, torch.int8, (planes, h, LANES), dev)
    for name, t in (("uids", uids), ("sg0", sg0), ("sg1", sg1)):
        _check(name, t, torch.int32, (n_steps,), dev)
    if nu * planes * LANES >= 2 ** 31:
        raise ValueError(f"{nu} unit blocks of {planes} planes: the kernel "
                         "indexes out positions with 32-bit ints")
    if dev.type == "cpu":
        return slab_spmm_ref(uids, sg0, sg1, win, lane, sub, val, hm1, idx,
                             x_panel, nu, m, T)
    out = torch.zeros(nu * planes, LANES, n_cols, dtype=acc_dtype(vt),
                      device=dev)
    if h:
        rc = _entry("slab_spmm", vt)(
            *map(_ptr, (uids, sg0, sg1, win, lane, sub, val, hm1, idx,
                        x_panel, out)),
            h, T, m, planes, n_cols,
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
        _raise_on(rc, "slab_spmm")
        _count(slab_spmm, vt)
    return out


slab_spmv_rows.launches = slab_spmv_rows.launches_f64 = 0
slab_spmv_rows.launches_bf16 = 0
slab_spmv.launches = slab_spmv.launches_f64 = 0
slab_spmv_blk.launches = 0
slab_spmm.launches = slab_spmm.launches_bf16 = 0
