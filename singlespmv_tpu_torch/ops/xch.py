"""XCH kernels: the wrappers of ``csrc/xch.cu`` and their plain PyTorch
versions.

``xch_mul`` (pass 1) and ``xch_route4`` (pass 2), their panels over B
columns ``xch_mul_panel`` and ``xch_route4_panel``, and the v3 σ-plane route
``xch_route`` take the arguments of their Pallas counterparts in
``singlespmv_tpu/ops/pallas/xch.py`` (:48, :151, :338, :424 and :259) and
return the same arrays, but for ``xch_mul``'s optional ``out`` (a row slice
of the caller's product grid, which the call fills) and the panels' layout:
``xch_mul_panel`` takes the interleaved (CB, 128, B) x panel and returns the
(H, 128, B) products, and ``xch_route4_panel`` takes them as
(n_chunks, P1, 128, B) and returns (n_grp·gb, 128, B), where the reference
keeps one (…, 128) array per column in front.  ``xch_route`` is the v3
format path's pass 2 (``formats/xch.py:_route_phase``, a state converted
under ``plan=estimate_v3(coo, cfg) | {"route_v": 3}``), after ``xch_mul``
writes its product grid; the calibration's ``route_slot_s`` fit
(``harness/calibrate.py``) calls it too.  It returns float32 out rows for
a float32 or bfloat16 grid.

``xch_fused_rows`` is the spmv path: both passes in one launch a pass-2
call.  It takes pass 2's run-end destination stream (``base``, ``dest``)
that ``formats/xch.py:route_rows`` derives from the reference's ``gids``,
``off``, ``sig`` and ``idx`` planes, and the pass-2-ordered value and
x-position streams ``val2``/``col2`` that it composes from the exchange,
gathers x, multiplies in registers and adds each run total into the
caller's y: the function of ``xch_mul`` followed by ``xch_route4_rows``,
product for product, with no product grid.

``xch_route4_rows`` is the pair's pass 2, which the driver's profiling
phases and nothing else on a path run: the function of ``xch_route4``,
routed by the same ``base``/``dest`` stream, adding into the caller's y
where ``xch_route4`` returns out groups.  ``xch_route4`` keeps the idx-plane
contract: its plain version is the bridge that the CPU tests hold against
the Pallas kernel, and its kernel, the first port, runs on no path (it is
the "as before" variant of ``harness/xch_ab.py``).  On a CUDA tensor a
wrapper launches its kernel, or raises; on a CPU tensor it runs the plain
version (``<wrapper>_ref``), which the tests hold against the Pallas kernels
and ``chip_smoke.py`` holds against the kernels on the card.

The value type is float32 or float64, the same for val, the x table, the
products and the out rows or y.  At float64 the wrappers launch the
native-fp64 builds of the kernels, which stand for the df64 kernels
``xch_mul_df`` (:495) and ``xch_route4_df`` (:594) of the reference.
``xch_route`` and the panels take float32 or bfloat16 (``PANEL_TYPES``),
as the TPU ran them.  ``xch_mul``, ``xch_route4_rows``, ``xch_route`` and
both panels run bfloat16 kernels: val, the x table or panel and the
product grid or panel are bfloat16 (2 bytes a slot in device memory, each
product rounded once, as the reference's grid is ``val.dtype``), and the
routes sum in float32 into a float32 y or out (``acc_dtype``), which the
caller rounds once (the reference's v3 route keeps its out rows in
bfloat16).  ``xch_fused_rows`` does the same at bfloat16: each
product rounded once to bfloat16, as the grid stores it, and float32 sums
into a float32 y.

Each wrapper counts the launches of its float32 kernel in
``<wrapper>.launches``, of its float64 kernel in ``<wrapper>.launches_f64``
and of its bfloat16 kernel in ``<wrapper>.launches_bf16``.

Pass 2 reads the products that pass 1 wrote on the same stream, so the
caller needs no synchronisation between the two.
"""
from __future__ import annotations

import ctypes
import weakref

import torch

from ..core.dtypes import acc, acc_dtype
from . import probes
from .slab import (LANES, PANEL_TYPES, SPMV_TYPES, VALUE_TYPES, _check,
                   _check_table, _count, _entry, _gather, _picked, _ptr,
                   _raise_on, _totals, value_type)

M_MAX = 120        # window blocks: int8 sub headroom (formats/xch.M_MAX)
P_OH_MAX = 64      # one-hot rows per step: the kernel's shared accumulator
ROUTE_PLANES_MAX = 64   # xch_route's σ planes: its shared accumulator
MERGE_SMEM = 96 * 1024  # the merge kernel's 8 spans of shared memory
MERGE_SPAN_MAX = P_OH_MAX * LANES


def _device(t):
    dev = t.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"xch kernels run on cuda (or cpu: plain version), "
                         f"not {dev.type}")
    return dev


def _check_rows(h, T, m, dev, win, lane, sub):
    if T < 1 or h % T:
        raise ValueError(f"stream rows {h} are not a multiple of T={T}")
    if not 1 <= m <= M_MAX:
        raise ValueError(f"window of {m} blocks is outside [1, {M_MAX}]")
    _check("win", win, torch.int32, (h,), dev)
    for name, t in (("lane", lane), ("sub", sub)):
        _check(name, t, torch.int8, (h, LANES), dev)


def _stream(dev):
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _check_mul(win, lane, sub, val, x, m, T, types, rank):
    """Checks of pass 1; ``x`` is the x table or, at rank 3, the
    interleaved panel.  Returns (H, device, value type)."""
    dev = _device(x)
    h = lane.shape[0]
    _check_rows(h, T, m, dev, win, lane, sub)
    vt = value_type(val, types)
    _check("val", val, vt, (h, LANES), dev)
    _check_table("x_table", x, vt, dev, rank)
    return h, dev, vt


def _check_route(gids, off, cs, win, lane, sub, hm1, sig, idx, prod, gb,
                 n_grp, m, T, p_oh, types, rank):
    """Checks of pass 2; ``prod`` is (n_chunks, P1, 128) or, at rank 4, the
    interleaved panel (n_chunks, P1, 128, B).  Returns (H, device, value
    type, kblk)."""
    dev = _device(prod)
    h = lane.shape[0]
    _check_rows(h, T, m, dev, win, lane, sub)
    kblk = idx.shape[0] if idx.dim() == 3 else 0
    if kblk < 1 or not 1 <= p_oh <= P_OH_MAX or gb < 1 or n_grp < 0:
        raise ValueError(f"route takes kblk ≥ 1, p_oh in [1, {P_OH_MAX}], "
                         f"gb ≥ 1; not {kblk}, {p_oh}, {gb}")
    for name, t in (("hm1", hm1), ("sig", sig)):
        _check(name, t, torch.int8, (h, LANES), dev)
    _check("idx", idx, torch.int8, (kblk, h, LANES), dev)
    for name, t in (("gids", gids), ("off", off), ("cs", cs)):
        _check(name, t, torch.int32, (h // T,), dev)
    if prod.dim() != rank or prod.shape[2] != LANES or not all(prod.shape):
        want = "(n_chunks, P1, 128)" if rank == 3 else \
            "(n_chunks, P1, 128, B)"
        raise ValueError(f"prod3 has shape {tuple(prod.shape)}, expected "
                         f"{want}")
    vt = value_type(prod, types)
    _check("prod3", prod, vt, prod.shape, dev)
    return h, dev, vt, kblk


def _check_rows_route(base, cs, win, lane, sub, hm1, dest, prod, y, m, T,
                      span):
    """Checks of the spmv route.  Returns (H, device, value type)."""
    dev = _device(prod)
    h = lane.shape[0]
    _check_rows(h, T, m, dev, win, lane, sub)
    if span < 0 or span % LANES or span > MERGE_SPAN_MAX:
        raise ValueError(f"merge span {span} is not a multiple of 128 in "
                         f"[0, {MERGE_SPAN_MAX}]")
    _check("hm1", hm1, torch.int8, (h, LANES), dev)
    _check("dest", dest, torch.int16, (h, LANES), dev)
    for name, t in (("base", base), ("cs", cs)):
        _check(name, t, torch.int32, (h // T,), dev)
    if prod.dim() != 3 or prod.shape[2] != LANES or not all(prod.shape):
        raise ValueError(f"prod3 has shape {tuple(prod.shape)}, expected "
                         "(n_chunks, P1, 128)")
    vt = value_type(prod, SPMV_TYPES)
    _check("prod3", prod, vt, prod.shape, dev)
    if y.dim() != 1 or y.numel() >= 2 ** 31:
        raise ValueError(f"y has shape {tuple(y.shape)}, expected (n,) with "
                         "n < 2**31")
    _check("y", y, acc_dtype(vt), y.shape, dev)
    if span * acc_dtype(vt).itemsize * 8 > MERGE_SMEM:
        raise ValueError(f"merge span {span} of {vt} passes the merge "
                         f"kernel's {MERGE_SMEM} bytes of shared memory")
    return h, dev, vt


_col_ranges = {}   # id(col2) → (its version, min, max): read once a tensor


def _col_range(col2):
    """(min, max) of ``col2``, read from the device once a tensor and
    version (a synchronisation on the card: the first call on a state's
    stream makes it, eagerly, before any CUDA graph captures the call)."""
    key = id(col2)
    hit = _col_ranges.get(key)
    if hit is None or hit[0] != col2._version:
        lo, hi = (int(v) for v in torch.aminmax(col2)) if col2.numel() \
            else (0, -1)
        if hit is None:
            weakref.finalize(col2, _col_ranges.pop, key, None)
        hit = _col_ranges[key] = (col2._version, lo, hi)
    return hit[1:]


def _check_fused(base, val2, col2, hm1, dest, x, y, T, span):
    """Checks of the fused spmv route.  Returns (H, device, value type)."""
    dev = _device(x)
    if val2.dim() != 2 or val2.shape[1] != LANES:
        raise ValueError(f"val2 has shape {tuple(val2.shape)}, expected "
                         "(H, 128)")
    h = val2.shape[0]
    if T < 1 or h % T:
        raise ValueError(f"stream rows {h} are not a multiple of T={T}")
    if span < 0 or span % LANES or span > MERGE_SPAN_MAX:
        raise ValueError(f"merge span {span} is not a multiple of 128 in "
                         f"[0, {MERGE_SPAN_MAX}]")
    vt = value_type(val2, SPMV_TYPES)
    _check("val2", val2, vt, (h, LANES), dev)
    _check("col2", col2, torch.int32, (h, LANES), dev)
    _check("hm1", hm1, torch.int8, (h, LANES), dev)
    _check("dest", dest, torch.int16, (h, LANES), dev)
    _check("base", base, torch.int32, (h // T,), dev)
    for name, t in (("x", x), ("y", y)):
        if t.dim() != 1 or t.numel() >= 2 ** 31:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             "(n,) with n < 2**31")
    _check("x", x, vt, x.shape, dev, aligned=False)   # read a value a slot
    _check("y", y, acc_dtype(vt), y.shape, dev)
    if span * acc_dtype(vt).itemsize * 8 > MERGE_SMEM:
        raise ValueError(f"merge span {span} of {vt} passes the merge "
                         f"kernel's {MERGE_SMEM} bytes of shared memory")
    lo, hi = _col_range(col2)
    if lo < 0 or hi >= x.numel():
        raise ValueError(f"col2 holds x positions in [{lo}, {hi}], outside "
                         f"x's {x.numel()} values")
    return h, dev, vt


# ----------------------------------------------------- plain PyTorch versions

def xch_mul_ref(win, lane, sub, val, x_table, m: int, T: int = 64):
    """Plain version of ``xch_mul``: at bfloat16 the float32 product (exact)
    rounded once."""
    return (acc(val) * acc(_gather(win, lane, sub, x_table, m))).to(
        val.dtype)


def xch_route4_ref(gids, off, cs, win, lane, sub, hm1, sig, idx, prod3,
                   n_grp: int, gb: int, m: int, T: int = 64, p_oh: int = 16):
    """Plain version of ``xch_route4``; bfloat16 products (the panel's,
    column by column) are widened and summed in float32, into float32
    out rows."""
    h = lane.shape[0]
    step = torch.arange(h, device=lane.device) // T
    rows = cs.long()[step] * prod3.shape[1] + win.long()   # product rows
    w = _totals(acc(_gather(rows, lane, sub, prod3, m)), hm1)
    s = sig[:, 0].long()
    base = gids.long()[step] * gb + off.long()[step] + s   # (H,)
    n_out = n_grp * gb
    out = torch.zeros(n_out, LANES, dtype=w.dtype, device=lane.device)
    for j in range(idx.shape[0]):
        keep = ((s + j >= 0) & (s + j < p_oh))[:, None]    # one-hot range
        out.index_add_(0, (base + j).clamp(0, max(n_out - 1, 0)),
                       torch.where(keep, _picked(w, idx[j]), 0.0))
    return out


def _add_runs(w, base, dest, y, T):
    """``index_add_`` of the run totals ``w`` at their destinations."""
    step = torch.arange(w.shape[0], device=w.device) // T
    d = dest.long()
    pos = base.long()[step][:, None] + d
    keep = (d >= 0) & (pos < y.numel())
    return y.index_add_(0, pos[keep], w[keep])


def xch_route4_rows_ref(base, cs, win, lane, sub, hm1, dest, prod3, y,
                        m: int, T: int = 64, span: int = 0):
    """Plain version of ``xch_route4_rows``: ``index_add_`` of the run
    totals at their destinations (``span`` picks a kernel, not a
    function); bfloat16 products are widened and summed in float32."""
    h = lane.shape[0]
    step = torch.arange(h, device=lane.device) // T
    rows = cs.long()[step] * prod3.shape[1] + win.long()   # product rows
    w = _totals(acc(_gather(rows, lane, sub, prod3, m)), hm1)
    return _add_runs(w, base, dest, y, T)


def xch_fused_rows_ref(base, val2, col2, hm1, dest, x, y, T: int = 64,
                       span: int = 0):
    """Plain version of ``xch_fused_rows``: the products val2 · x[col2],
    each rounded to val2's type as ``xch_mul_ref`` rounds it (at bfloat16
    the float32 product, exact, rounded once), then the run totals and
    ``index_add_`` of ``xch_route4_rows_ref``."""
    prod = (acc(val2) * acc(x[col2.long()])).to(val2.dtype)
    return _add_runs(_totals(acc(prod), hm1), base, dest, y, T)


def _active_planes(sg0, sg1, planes, pg):
    """(n_steps, planes) bool: plane s of step t lies in a pg-group that the
    TPU kernel routes, one with sg0[t] < g0 + n_p and sg1[t] >= g0."""
    g0 = torch.arange(planes, device=sg0.device) // pg * pg
    end = torch.clamp(g0 + pg, max=planes)
    return (sg0[:, None] < end) & (sg1[:, None] >= g0)


def active_plane_range(s0: int, s1: int, planes: int, pg: int) -> tuple:
    """(lo, hi): the planes of the pg-groups that a step with sg0 = s0 and
    sg1 = s1 routes, contiguous (lo > hi: none), as ``xch_route``'s kernel
    computes them (``csrc/xch.cu:active_planes``)."""
    if s1 < 0 or s0 >= planes:
        return 0, -1
    jlo, jhi = max(s0, 0) // pg, min(s1, planes - 1) // pg
    if jlo > jhi:
        return 0, -1
    return jlo * pg, min((jhi + 1) * pg, planes) - 1


def xch_route_ref(uids, gids, cs, sg0, sg1, win, lane, sub, hm1, idx, prod3,
                  ngb: int, m: int, planes: int, T: int = 32,
                  g_grp: int = 16, pg: int = 8):
    """Plain version of ``xch_route``; bfloat16 products are widened and
    summed in float32, into float32 out rows."""
    h = lane.shape[0]
    step = torch.arange(h, device=lane.device) // T
    rows = cs.long()[step] * prod3.shape[1] + win.long()   # product rows
    w = _totals(acc(_gather(rows, lane, sub, prod3, m)), hm1)
    active = _active_planes(sg0, sg1, planes, pg)[step]    # (H, planes)
    n_out = ngb * g_grp * planes
    out = torch.zeros(n_out, LANES, dtype=w.dtype, device=lane.device)
    base = uids.long()[step] * planes
    for s in range(planes if n_out else 0):
        row = base + s
        keep = active[:, s] & (row >= 0) & (row < n_out)
        out.index_add_(0, row.clamp(0, n_out - 1),
                       torch.where(keep[:, None], _picked(w, idx[s]), 0.0))
    return out


def xch_mul_panel_ref(win, lane, sub, val, x_panel, m: int, T: int = 64):
    """Plain version of ``xch_mul_panel``: ``xch_mul_ref`` of each
    column (at bfloat16 each float32 product rounded once)."""
    return torch.stack([xch_mul_ref(win, lane, sub, val, x_panel[..., b], m,
                                    T) for b in range(x_panel.shape[-1])], -1)


def xch_route4_panel_ref(gids, off, cs, win, lane, sub, hm1, sig, idx, prod3,
                         n_grp: int, gb: int, m: int, T: int = 64,
                         p_oh: int = 16):
    """Plain version of ``xch_route4_panel``: ``xch_route4_ref`` of each
    column (at bfloat16 float32 sums into float32 out rows)."""
    return torch.stack([
        xch_route4_ref(gids, off, cs, win, lane, sub, hm1, sig, idx,
                       prod3[..., b], n_grp, gb, m, T, p_oh)
        for b in range(prod3.shape[-1])], -1)


# --------------------------------------------------------------- wrappers ---

def xch_mul(win, lane, sub, val, x_table, m: int, T: int = 64, out=None):
    """Pass 1 over one call chunk: products (H, 128) = val · x[window
    gather], written linearly.

    win:      (H,) int32 — x window base col-block per stream row.
    lane/sub: (H, 128) int8; val: (H, 128) float32, float64 or bfloat16.
    x_table:  (CB, 128) of val's type.
    out:      None, or the contiguous (H, 128) of val's type to write: a row
              slice of the caller's product grid.
    Returns the (H, 128) products of val's type (``out`` where given)."""
    h, dev, vt = _check_mul(win, lane, sub, val, x_table, m, T, SPMV_TYPES,
                            2)
    if out is not None:
        _check("out", out, vt, (h, LANES), dev)
    if dev.type == "cpu":
        prod = xch_mul_ref(win, lane, sub, val, x_table, m, T)
        return prod if out is None else out.copy_(prod)
    if out is None:
        out = torch.empty(h, LANES, dtype=vt, device=dev)  # all written
    if h:
        rc = _entry("xch_mul", vt)(
            *map(_ptr, (win, lane, sub, val, x_table, out)), h, T, m,
            _stream(dev))
        _raise_on(rc, "xch_mul")
        _count(xch_mul, vt)
    return out


def xch_route4(gids, off, cs, win, lane, sub, hm1, sig, idx, prod3,
               n_grp: int, gb: int, m: int, T: int = 64, p_oh: int = 16):
    """Pass 2 over one call chunk: returns (n_grp·gb, 128) of prod3's type —
    out row g·gb + i holds the i-th 128-row block of the call's compact
    group g.

    gids: (n_steps,) int32 — call-local out group per step, non-decreasing.
    off:  (n_steps,) int32 — step base block − gids·gb, off + p_oh ≤ gb.
    cs:   (n_steps,) int32 — source chunk per step.
    win:  (H,) int32 — chunk-local product-row window base.
    lane/sub/hm1/sig: (H, 128) int8; sig is lane-replicated.
    idx:  (kblk, H, 128) int8 — end lanes, −1 masked.
    prod3: (n_chunks, P1, 128) float32 or float64 pass-1 products.
    The Pallas kernel's ``msel`` (select width) is ``m`` here: its callers
    pass the two equal."""
    h, dev, vt, kblk = _check_route(
        gids, off, cs, win, lane, sub, hm1, sig, idx, prod3, gb, n_grp, m, T,
        p_oh, VALUE_TYPES, 3)
    if dev.type == "cpu":
        return xch_route4_ref(gids, off, cs, win, lane, sub, hm1, sig, idx,
                              prod3, n_grp, gb, m, T, p_oh)
    out = torch.zeros(n_grp * gb, LANES, dtype=vt, device=dev)
    if h:
        rc = _entry("xch_route4", vt)(
            *map(_ptr, (gids, off, cs, win, lane, sub, hm1, sig, idx, prod3,
                        out)),
            h, T, m, kblk, p_oh, n_grp, gb, prod3.shape[1], _stream(dev))
        _raise_on(rc, "xch_route4")
        _count(xch_route4, vt)
    return out


def xch_route4_rows(base, cs, win, lane, sub, hm1, dest, prod3, y,
                    m: int, T: int = 64, span: int = 0):
    """Pass 2 of the spmv over one call chunk: adds each run total of the
    stream into ``y`` at its destination; returns ``y``.

    base: (n_steps,) int32 — y position of the step's out row 0.
    cs:   (n_steps,) int32 — source chunk per step.
    win:  (H,) int32 — chunk-local product-row window base.
    lane/sub/hm1: (H, 128) int8.
    dest: (H, 128) int16 — at a run's end slot, its y position less
          base[step]; −1 on every other slot.
    prod3: (n_chunks, P1, 128) float32, float64 or bfloat16 pass-1
          products.
    y:    (n,) of ``acc_dtype(prod3.dtype)`` (float32 for bfloat16), zeroed
          by the caller before its first call; positions at or past n are
          dropped.
    span: 0, each run end adds into y; or p_oh·128, every dest below it,
          where the stream's run ends pile onto few y rows
          (``formats/xch.py:route_rows``): the merge kernel sums a block's
          rows in shared memory first.  The function is the same.
    The sums of a y position add in run-dependent order on the card."""
    h, dev, vt = _check_rows_route(base, cs, win, lane, sub, hm1, dest,
                                   prod3, y, m, T, span)
    if dev.type == "cpu":
        return xch_route4_rows_ref(base, cs, win, lane, sub, hm1, dest, prod3,
                                   y, m, T, span)
    if h:
        rc = _entry("xch_route4_rows", vt)(
            *map(_ptr, (base, cs, win, lane, sub, hm1, dest, prod3, y)),
            h, T, m, prod3.shape[1], y.numel(), span, _stream(dev))
        _raise_on(rc, "xch_route4_rows")
        _count(xch_route4_rows, vt)
    return y


def xch_fused_rows(base, val2, col2, hm1, dest, x, y, T: int = 64,
                   span: int = 0):
    """The spmv over one pass-2 call in one launch: the products
    val2 · x[col2] made in registers, each rounded as ``xch_mul`` stores it,
    and their run totals added into ``y`` as ``xch_route4_rows`` adds those
    of the product grid; returns ``y``.

    base: (n_steps,) int32 — y position of the step's out row 0.
    val2: (H, 128) float32, float64 or bfloat16 — at each pass-2 slot the
          value of the pass-1 slot whose product the pair's route reads
          there (0 where that slot's x position lies in the x table's zero
          padding).
    col2: (H, 128) int32 — that slot's position in x (0 where padded);
          every one in [0, x.numel()).
    hm1:  (H, 128) int8 — pass 2's run head lane − 1.
    dest: (H, 128) int16 — at a run's end slot, its y position less
          base[step]; −1 on every other slot.
    x:    (n,) of val2's type — read in place: no x table.
    y:    (n_y,) of ``acc_dtype(val2.dtype)`` (float32 for bfloat16), zeroed
          by the caller before its first call; positions at or past n_y
          are dropped.
    span: 0, or the merge kernel's span, as in ``xch_route4_rows``.
    The sums of a y position add in run-dependent order on the card."""
    h, dev, vt = _check_fused(base, val2, col2, hm1, dest, x, y, T, span)
    if dev.type == "cpu":
        return xch_fused_rows_ref(base, val2, col2, hm1, dest, x, y, T, span)
    if h:
        rc = _entry("xch_fused_rows", vt)(
            *map(_ptr, (base, val2, col2, hm1, dest, x, y)), h, T,
            y.numel(), span, _stream(dev))
        _raise_on(rc, "xch_fused_rows")
        _count(xch_fused_rows, vt)
    return y


def xch_mul_panel(win, lane, sub, val, x_panel, m: int, T: int = 64):
    """Pass 1 over one call chunk for a panel of B columns, float32 or
    bfloat16.

    val:     (H, 128) float32 or bfloat16.
    x_panel: (CB, 128, B) of val's type — the interleaved panel:
             x_panel[c, l] holds the B column values of x row c·128 + l.
    Other arguments as in ``xch_mul``.  Returns the (H, 128, B) products of
    val's type (at bfloat16 each float32 product rounded once): a slot's B
    products are contiguous."""
    h, dev, vt = _check_mul(win, lane, sub, val, x_panel, m, T, PANEL_TYPES,
                            3)
    if dev.type == "cpu":
        return xch_mul_panel_ref(win, lane, sub, val, x_panel, m, T)
    n_cols = x_panel.shape[-1]
    out = torch.empty(h, LANES, n_cols, dtype=vt, device=dev)  # all written
    if h:
        rc = _entry("xch_mul_panel", vt)(
            *map(_ptr, (win, lane, sub, val, x_panel, out)), h, T, m, n_cols,
            _stream(dev))
        _raise_on(rc, "xch_mul_panel")
        _count(xch_mul_panel, vt)
    return out


def xch_route4_panel(gids, off, cs, win, lane, sub, hm1, sig, idx, prod3,
                     n_grp: int, gb: int, m: int, T: int = 64,
                     p_oh: int = 16):
    """Pass 2 over one call chunk for a panel of B columns, float32 or
    bfloat16.

    prod3: (n_chunks, P1, 128, B) float32 or bfloat16 — the interleaved
    pass-1 products.  Other arguments as in ``xch_route4``.  Returns
    (n_grp·gb, 128, B) float32, the accumulator of either type (the caller
    rounds Y once): out row i's B columns are contiguous, as in Y; out rows
    past n_grp·gb are dropped, as in ``xch_route4``, where the Pallas panel
    kernel writes its step's p_oh rows unclipped.  The sums of an out
    position add in run-dependent order on the card."""
    h, dev, vt, kblk = _check_route(
        gids, off, cs, win, lane, sub, hm1, sig, idx, prod3, gb, n_grp, m, T,
        p_oh, PANEL_TYPES, 4)
    if dev.type == "cpu":
        return xch_route4_panel_ref(gids, off, cs, win, lane, sub, hm1, sig,
                                    idx, prod3, n_grp, gb, m, T, p_oh)
    n_chunks, p1, _, n_cols = prod3.shape
    out = torch.zeros(n_grp * gb, LANES, n_cols, dtype=acc_dtype(vt),
                      device=dev)
    if h:
        rc = _entry("xch_route4_panel", vt)(
            *map(_ptr, (gids, off, cs, win, lane, sub, hm1, sig, idx, prod3,
                        out)),
            h, T, m, kblk, p_oh, n_grp, gb, p1, n_cols, n_chunks,
            _stream(dev))
        _raise_on(rc, "xch_route4_panel")
        _count(xch_route4_panel, vt)
    return out


def xch_route(uids, gids, cs, sg0, sg1, win, lane, sub, hm1, idx, prod3,
              ngb: int, m: int, planes: int, T: int = 32, g_grp: int = 16,
              pg: int = 8):
    """The v3 pass 2 over one call chunk: returns (ngb·g_grp·planes, 128)
    float32 — out rows [u·planes, (u+1)·planes) hold the σ planes of
    compact bucket u.

    uids: (n_steps,) int32 — compact bucket per step, non-decreasing.
    gids: (n_steps,) int32 — uids // g_grp, the TPU's out block per step;
          checked, not read: the out row of plane s is uids·planes + s.
    cs:   (n_steps,) int32 — source chunk per step.
    sg0/sg1: (n_steps,) int32 — first/last active σ plane per step; a
          pg-group of planes is routed when it meets [sg0, sg1].
    win:  (H,) int32 — chunk-local product-row window base.
    lane/sub/hm1: (H, 128) int8.  idx: (planes, H, 128) int8 end lanes,
          −1 masked.
    prod3: (n_chunks, P1, 128) float32 or bfloat16 pass-1 products; a
          bfloat16 grid is read at 2 bytes a product and summed in float32.
    Out rows that no step reaches stay 0.  The sums of an out position add
    in run-dependent order on the card."""
    dev = _device(prod3)
    h = lane.shape[0]
    _check_rows(h, T, m, dev, win, lane, sub)
    if not 1 <= planes <= ROUTE_PLANES_MAX or pg < 1 or g_grp < 1 \
            or ngb < 0:
        raise ValueError(f"xch_route takes 1 ≤ planes ≤ {ROUTE_PLANES_MAX}, "
                         f"pg ≥ 1, g_grp ≥ 1 and ngb ≥ 0; not {planes}, "
                         f"{pg}, {g_grp}, {ngb}")
    _check("hm1", hm1, torch.int8, (h, LANES), dev)
    _check("idx", idx, torch.int8, (planes, h, LANES), dev)
    for name, t in (("uids", uids), ("gids", gids), ("cs", cs),
                    ("sg0", sg0), ("sg1", sg1)):
        _check(name, t, torch.int32, (h // T,), dev)
    if prod3.dim() != 3 or prod3.shape[-1] != LANES \
            or not all(prod3.shape[:-1]):
        raise ValueError(f"prod3 has shape {tuple(prod3.shape)}, expected "
                         "(n_chunks, P1, 128)")
    vt = value_type(prod3, PANEL_TYPES)
    _check("prod3", prod3, vt, prod3.shape, dev)
    if dev.type == "cpu":
        return xch_route_ref(uids, gids, cs, sg0, sg1, win, lane, sub, hm1,
                             idx, prod3, ngb, m, planes, T, g_grp, pg)
    n_out = ngb * g_grp * planes
    out = torch.zeros(n_out, LANES, dtype=torch.float32, device=dev)
    if h and n_out:
        rc = _entry("xch_route", vt)(
            *map(_ptr, (uids, cs, sg0, sg1, win, lane, sub, hm1, idx, prod3,
                        out)),
            h, T, m, planes, pg, prod3.shape[1], n_out,
            probes.unit_rows(h, T, dev), _stream(dev))
        _raise_on(rc, "xch_route")
        _count(xch_route, vt)
    return out


xch_mul.launches = xch_mul.launches_f64 = xch_mul.launches_bf16 = 0
xch_route4.launches = xch_route4.launches_f64 = 0
xch_route4_rows.launches = xch_route4_rows.launches_f64 = 0
xch_route4_rows.launches_bf16 = 0
xch_fused_rows.launches = xch_fused_rows.launches_f64 = 0
xch_fused_rows.launches_bf16 = 0
xch_mul_panel.launches = xch_mul_panel.launches_bf16 = 0
xch_route4_panel.launches = xch_route4_panel.launches_bf16 = 0
xch_route.launches = xch_route.launches_bf16 = 0
