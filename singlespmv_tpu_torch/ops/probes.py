"""Hopper probes: the wrappers of ``csrc/probes.cu`` and ``csrc/probe_slab.cu``
and their plain PyTorch versions.

Each wrapper takes the arguments of the Pallas call of one probe of the
reference's microbenchmark suite (``singlespmv_tpu/harness/microbench.py``)
or of its staged slab probe (``scripts/probe_slab.py:make_call``) and returns
what that call returns:

    lane_gather     probe_lane_gather       :118   out = val · x[row, col]
    gather1024      probe_gather1024        :166   x (8, 128), col < levels·128
    palette_gather  probe_palette_gather    :212   x row blk[t·nb + p // per]
    pal2step        probe_pal2step          :265   8-row window, K sublane picks
    onehot_bins     probe_onehot_inkernel   :324   per-tile bin sums
    sublane_gather  probe_sublane_gather    :364   out = val · x[idx, lane]
    dynslice_accum  probe_dynslice_accum    :435   8-row windows summed into y
    seg_scan        probe_seg_scan          :478   7 Hillis–Steele steps
    seg_scan_roll   probe_seg_scan_roll     :520   `steps` steps, int8 heads
    tile_transpose  probe_pallas_tile_transpose :565
    slab_step       make_call (scripts/probe_slab.py:28), by stage

Element (R, c) of an (h, w) probe array lies in lane-row
p = (R % 8)·(w / 128) + c // 128 of its (8, w) tile t = R // 8, at lane
c % 128: the (8, w) → (8w/128, 128) reshape of the TPU kernels.

On a CUDA tensor a wrapper launches its kernel, or raises; on a CPU tensor
it runs the plain version (``<wrapper>_ref``), which the tests hold against
the Pallas kernels and ``chip_smoke.py`` holds against the kernels on the
card.  Values are float32; ``lane_gather`` also takes bfloat16 values with
int16 col, as ``lane_gather_w512_bf16`` runs it.  Each wrapper counts the
launches of its kernel in ``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .slab import LANES, _check, _picked, _ptr, _raise_on, _totals

STAGES = ("all", "window", "gather", "select", "prefix", "route",
          "routeonly")
MULTIPLY_STAGES = STAGES[:4]           # gather from x and multiply
TOTALS_STAGES = ("all", "prefix", "route")
ROUTE_STAGES = ("all", "route", "routeonly")
MAX_S8 = 8                             # σ planes of one (8, 128) unit block
DYN_CHUNK = 16                         # csrc kDynChunk: steps a block
UNIT_BLOCKS_PER_SM = 6   # chunks a multiprocessor of the unit kernels
_LANE, _LEVELS, _PALETTE, _PAL2STEP, _SUBLANE = range(5)   # csrc kinds
F32 = torch.float32


def _device(t):
    dev = t.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"probe kernels run on cuda (or cpu: plain version), "
                         f"not {dev.type}")
    return dev


def _stream(dev):
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _null():
    return ctypes.c_void_p(None)


def _tile_shape(name, t, dev, dtype):
    """(h, w) of an (h, w) probe array of 8-row tiles, w a multiple of 128."""
    if t.dim() != 2 or t.shape[0] % 8 or t.shape[1] % LANES \
            or not t.shape[1]:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         "(h, w) with 8 | h and 128 | w")
    _check(name, t, dtype, t.shape, dev)
    return tuple(t.shape)


def _table(name, t, dev, dtype):
    if t.dim() != 2 or t.shape[1] != LANES or not t.shape[0]:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         "(rows, 128)")
    _check(name, t, dtype, t.shape, dev)


def _lane_rows(h, w, dev):
    """(h, w) int64: the lane-row p of each element within its tile."""
    r = torch.arange(h, device=dev)[:, None] % 8
    c = torch.arange(w, device=dev)[None, :]
    return r * (w // LANES) + c // LANES


def _tiles(h, dev):
    """(h, 1) int64: the tile t of each row."""
    return torch.arange(h, device=dev)[:, None] // 8


# ----------------------------------------------------- plain PyTorch versions

def lane_gather_ref(col, val, x, table_rows: int = 1):
    """Plain version of ``lane_gather``."""
    h, w = col.shape
    row = 0 if table_rows == 1 else _lane_rows(h, w, col.device)
    return val * x[row, col.long()]


def gather1024_ref(col, val, x, levels: int = 8):
    """Plain version of ``gather1024``."""
    c = col.long()
    sub = torch.div(c, LANES, rounding_mode="floor")
    hit = (sub >= 0) & (sub < levels)
    return val * torch.where(hit, x[sub % 8, c % LANES], 0.0)


def palette_gather_ref(blk, col, val, x, per: int = 1):
    """Plain version of ``palette_gather``."""
    h, w = col.shape
    nb = 8 * w // LANES // per
    p = _lane_rows(h, w, col.device)
    row = blk.long()[_tiles(h, col.device) * nb + p // per]
    return val * x[row, col.long()]


def pal2step_ref(blk, col, val, sub, sel, x):
    """Plain version of ``pal2step``."""
    n_k, (h, w) = sub.shape[0], col.shape
    dev = col.device
    c = torch.arange(w, device=dev)[None, :]
    k = torch.where((sel >= 1) & (sel < n_k), sel, 0).long()
    picked = sub[k, torch.arange(h, device=dev)[:, None],
                 c - c % LANES + col.long()]
    g = 8 * w // LANES
    row = blk.long()[_tiles(h, dev) * g + _lane_rows(h, w, dev)] + picked
    return val * x[row, col.long()]


def sublane_gather_ref(idx, val, x):
    """Plain version of ``sublane_gather``."""
    return val * x[idx.long(), torch.arange(LANES, device=idx.device)]


def onehot_bins_ref(bins, val):
    """Plain version of ``onehot_bins``, in the kernel's order: each row of
    a tile (a warp's) sums its 128 values by bin, then the tile's 8 row sums
    add in row order.  A bin outside [0, 128) adds nowhere."""
    tiles = bins.shape[0] // 8
    hit = (bins >= 0) & (bins < LANES)
    rows = torch.zeros(tiles, 8, LANES, dtype=val.dtype, device=val.device)
    rows.scatter_add_(2, bins.clamp(0, LANES - 1).long().view(tiles, 8, -1),
                      torch.where(hit, val, 0.0).view(tiles, 8, -1))
    sums = rows[:, 0]
    for r in range(1, 8):
        sums = sums + rows[:, r]
    return sums.repeat_interleave(8, dim=0)


def dynslice_starts(offs, rows: int = 1024):
    """(T,) int64: the first y row of each step's window, as the
    reference's dynamic slice takes it: offs[t], plus ``rows`` where
    negative (a negative index counts from the end), clamped to
    [0, rows − 8]."""
    off = offs.long()
    return torch.where(off < 0, off + rows, off).clamp(0, rows - 8)


def dynslice_accum_ref(offs, v, rows: int = 1024):
    """Plain version of ``dynslice_accum``."""
    off = dynslice_starts(offs, rows)
    dst = (off[:, None] + torch.arange(8, device=v.device)).reshape(-1)
    out = torch.zeros(rows, LANES, dtype=v.dtype, device=v.device)
    return out.index_add_(0, dst, v)


def dynslice_accum_chunks_ref(offs, v, rows: int = 1024,
                              chunk: int = DYN_CHUNK):
    """A model of the kernel's sums, used by no path: each run of ``chunk``
    steps sums its steps in order into a window of 8 rows [cur, cur + 8);
    a step at cur < off < cur + 8 adds rows cur … off − 1 into out and
    slides the window there, a step elsewhere adds the whole window and
    starts an empty one at off, and the run's end adds the rest.  Returns
    out and the rows added into it (the kernel's float4 REDs, 32 a row)."""
    off = dynslice_starts(offs, rows).tolist()
    out = torch.zeros(rows, LANES, dtype=v.dtype, device=v.device)
    steps = v.view(-1, 8, LANES)
    added = 0
    for t0 in range(0, len(off), chunk):
        cur, acc = None, None
        for t in range(t0, min(t0 + chunk, len(off))):
            o = off[t]
            if cur is not None and cur < o < cur + 8:
                out[cur:o] += acc[:o - cur]
                acc = torch.cat([acc[o - cur:],
                                 torch.zeros_like(acc[:o - cur])])
                added += o - cur
            elif o != cur:
                if cur is not None:
                    out[cur:cur + 8] += acc
                    added += 8
                acc = torch.zeros_like(steps[t])
            cur = o
            acc = acc + steps[t]
        if cur is not None:
            out[cur:cur + 8] += acc
            added += 8
    return out, added


def seg_scan_ref(heads, val, steps: int = 7):
    """Plain version of ``seg_scan`` and ``seg_scan_roll``: ``steps``
    segmented Hillis–Steele steps, shifts 1, 2, 4, …"""
    v, f = val, heads.to(torch.int32)
    d = 1
    for _ in range(steps):
        vz, fz = torch.zeros_like(v), torch.ones_like(f)
        if d < LANES:
            vz[:, d:], fz[:, d:] = v[:, :-d], f[:, :-d]
        v = torch.where(f > 0, v, v + vz)
        f = torch.maximum(f, fz)
        d *= 2
    return v


seg_scan_roll_ref = seg_scan_ref


def tile_transpose_ref(a, nu: int, s: int):
    """Plain version of ``tile_transpose``, as the kernel copies: run
    (cb, u) of S floats goes from a's flat offset (cb·NU + u)·S to out's
    (u·CB + cb)·S, so out[u, cb·S + s] = a[cb, u·S + s]."""
    cb, dev = a.shape[0], a.device
    runs = (torch.arange(cb, device=dev)[None, :] * nu
            + torch.arange(nu, device=dev)[:, None]) * s  # (NU, CB): out order
    src = runs[:, :, None] + torch.arange(s, device=dev)
    return a.reshape(-1)[src.reshape(-1)].view(nu, cb * s)


def slab_step_ref(uids, base, lane, sub, val, hm1, idx, x, nu: int, T: int,
                  stage: str = "all"):
    """Plain version of ``slab_step``."""
    h, dev = lane.shape[0], lane.device
    b = base.reshape(-1).long()[:, None]
    if stage in ("all", "select"):
        s = sub.long()
        hit = (s >= 0) & (s < 8)
        col = (b + s.clamp(0, 7)) * LANES + lane.long()
        g = torch.where(hit, x.reshape(-1)[col], 0.0)
    elif stage == "window":
        g = x[b[:, 0]]
    elif stage == "gather":
        g = x.reshape(-1)[b * LANES + lane.long()]
    v = val * g if stage in MULTIPLY_STAGES else val
    w = _totals(v, hm1) if stage in TOTALS_STAGES else v
    u = uids.long()[torch.arange(h, device=dev) // T]
    keep = ((u >= 0) & (u < nu))[:, None]
    u = u.clamp(0, max(nu - 1, 0))
    out = torch.zeros(nu * 8, LANES, dtype=val.dtype, device=dev)
    if not nu:
        return out
    if stage in ROUTE_STAGES:
        for s in range(idx.shape[0]):
            out.index_add_(0, u * 8 + s,
                           torch.where(keep, _picked(w, idx[s]), 0.0))
        return out
    sums = torch.zeros(nu, LANES, dtype=val.dtype, device=dev)
    sums.index_add_(0, u, torch.where(keep, w, 0.0))
    return sums.repeat_interleave(8, dim=0)


# --------------------------------------------------------------- wrappers ---

def unit_chunk_rows(h: int, T: int, sms: int,
                    per_sm: int = UNIT_BLOCKS_PER_SM) -> int:
    """R, the stream rows a block of the lane-owned unit kernels takes
    (``csrc/unit_acc.cuh``: ``slab_step`` and ``xch.xch_route``): the
    multiple of T nearest h / (per_sm · sms), at least T, so that the
    chunks fill the card's ``sms`` multiprocessors ``per_sm`` deep."""
    if T < 1 or h < 0 or sms < 1 or per_sm < 1:
        raise ValueError(f"no chunk for h={h}, T={T}, sms={sms}, "
                         f"per_sm={per_sm}")
    return T * max(1, round(h / (T * per_sm * sms)))


def unit_rows(h: int, T: int, dev) -> int:
    """R of a unit kernel's launch over h rows on ``dev``."""
    sms = _sms(dev.index if dev.index is not None
               else torch.cuda.current_device())
    return unit_chunk_rows(h, T, sms, UNIT_BLOCKS_PER_SM)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _gather(wrapper, col, val, x, kind, a=0, b=0, blk=None, sub=None,
            sel=None):
    """Launches the gather-multiply kernel for ``wrapper``; returns out."""
    dev = col.device
    entry = "probe_gather_bf16" if val.dtype == torch.bfloat16 \
        else "probe_gather_f32"
    out = torch.empty_like(val)
    if out.numel():
        rc = getattr(_build.load(), entry)(
            _ptr(col), _ptr(val), _ptr(x),
            *(_ptr(t) if t is not None else _null() for t in (blk, sub, sel)),
            _ptr(out), out.numel(), col.shape[1], kind, a, b, _stream(dev))
        _raise_on(rc, wrapper.__name__)
        wrapper.launches += 1
    return out


def lane_gather(col, val, x, table_rows: int = 1):
    """out (h, w) = val · x[row, col]: row 0 when ``table_rows`` is 1, else
    each element's lane-row p.  col (h, w) int32 with float32 values, int16
    with bfloat16 ones; x (≥ 8w/128, 128) of val's type."""
    dev = _device(val)
    if val.dtype not in (F32, torch.bfloat16):
        raise TypeError(f"lane_gather takes float32 or bfloat16, "
                        f"not {val.dtype}")
    shape = _tile_shape("val", val, dev, val.dtype)
    _check("col", col, torch.int32 if val.dtype == F32 else torch.int16,
           shape, dev)
    _table("x", x, dev, val.dtype)
    if table_rows != 1 and x.shape[0] < 8 * shape[1] // LANES:
        raise ValueError(f"x has {x.shape[0]} rows, a tile reads "
                         f"{8 * shape[1] // LANES}")
    if dev.type == "cpu":
        return lane_gather_ref(col, val, x, table_rows)
    return _gather(lane_gather, col, val, x, _LANE, int(table_rows == 1))


def gather1024(col, val, x, levels: int = 8):
    """out (h, w) = val · x[(col // 128) % 8, col % 128] where
    0 ≤ col // 128 < levels, else 0; col (h, w) int32, x (8, 128)."""
    dev = _device(val)
    shape = _tile_shape("val", val, dev, F32)
    _check("col", col, torch.int32, shape, dev)
    _check("x", x, F32, (8, LANES), dev)
    if dev.type == "cpu":
        return gather1024_ref(col, val, x, levels)
    return _gather(gather1024, col, val, x, _LEVELS, levels)


def palette_gather(blk, col, val, x, per: int = 1):
    """out (h, w) = val · x[blk[t·nb + p // per], col], nb = 8w/128/per;
    blk (h/8·nb,) int32, col (h, w) int32, x (CBX, 128)."""
    dev = _device(val)
    h, w = _tile_shape("val", val, dev, F32)
    if per < 1 or (8 * w // LANES) % per:
        raise ValueError(f"per={per} does not divide a tile's "
                         f"{8 * w // LANES} lane-rows")
    nb = 8 * w // LANES // per
    _check("col", col, torch.int32, (h, w), dev)
    _check("blk", blk, torch.int32, (h // 8 * nb,), dev)
    _table("x", x, dev, F32)
    if dev.type == "cpu":
        return palette_gather_ref(blk, col, val, x, per)
    return _gather(palette_gather, col, val, x, _PALETTE, nb, per, blk=blk)


def pal2step(blk, col, val, sub, sel, x):
    """out (h, w) = val · x[blk[t·g + p] + sub[k][R, c − c % 128 + col],
    col], k = sel where 1 ≤ sel < K, else 0; blk (h/8·g,) int32, col and
    sel (h, w) int32, sub (K, h, w) int32 in [0, 8), x (CBX, 128)."""
    dev = _device(val)
    h, w = _tile_shape("val", val, dev, F32)
    g = 8 * w // LANES
    for name, t in (("col", col), ("sel", sel)):
        _check(name, t, torch.int32, (h, w), dev)
    if sub.dim() != 3 or not sub.shape[0]:
        raise ValueError(f"sub has shape {tuple(sub.shape)}, expected "
                         "(K, h, w)")
    _check("sub", sub, torch.int32, (sub.shape[0], h, w), dev)
    _check("blk", blk, torch.int32, (h // 8 * g,), dev)
    _table("x", x, dev, F32)
    if dev.type == "cpu":
        return pal2step_ref(blk, col, val, sub, sel, x)
    return _gather(pal2step, col, val, x, _PAL2STEP, g, sub.shape[0],
                   blk=blk, sub=sub, sel=sel)


def sublane_gather(idx, val, x):
    """out (G, 128) = val · x[idx, lane]; idx (G, 128) int32 in [0, rows),
    x (rows, 128).  The kernel stages 32 lanes of every row of x in
    shared memory a block (up to 1,816 rows), else it gathers from device
    memory."""
    dev = _device(val)
    shape = _tile_shape("val", val, dev, F32)
    if shape[1] != LANES:
        raise ValueError(f"val has shape {shape}, expected (G, 128)")
    _check("idx", idx, torch.int32, shape, dev)
    _table("x", x, dev, F32)
    if dev.type == "cpu":
        return sublane_gather_ref(idx, val, x)
    return _gather(sublane_gather, idx, val, x, _SUBLANE, x.shape[0])


def onehot_bins(bins, val):
    """out (G, 128): every row of tile t holds the 128 sums of the tile's
    val by bin; bins (G, 128) int32 (outside [0, 128): no bin)."""
    dev = _device(val)
    shape = _tile_shape("val", val, dev, F32)
    if shape[1] != LANES:
        raise ValueError(f"val has shape {shape}, expected (G, 128)")
    _check("bins", bins, torch.int32, shape, dev)
    if dev.type == "cpu":
        return onehot_bins_ref(bins, val)
    out = torch.empty_like(val)         # all written
    if out.numel():
        rc = _build.load().probe_onehot_f32(_ptr(bins), _ptr(val), _ptr(out),
                                            shape[0], _stream(dev))
        _raise_on(rc, "onehot_bins")
        onehot_bins.launches += 1
    return out


def dynslice_accum(offs, v, rows: int = 1024):
    """out (rows, 128) = Σ_t v[8t : 8t+8] added at rows off_t … off_t + 7,
    off_t = ``dynslice_starts``: offs[t], plus rows where negative, clamped
    to [0, rows − 8]; offs (T,) int32, v (8T, 128)."""
    dev = _device(v)
    if offs.dim() != 1 or rows < 8:
        raise ValueError(f"dynslice_accum takes offs (T,) and rows ≥ 8, not "
                         f"{tuple(offs.shape)} and {rows}")
    n_t = offs.shape[0]
    _check("offs", offs, torch.int32, (n_t,), dev)
    _check("v", v, F32, (8 * n_t, LANES), dev)
    if dev.type == "cpu":
        return dynslice_accum_ref(offs, v, rows)
    out = torch.zeros(rows, LANES, dtype=F32, device=dev)
    if n_t:
        rc = _build.load().probe_dynslice_f32(_ptr(offs), _ptr(v), _ptr(out),
                                              n_t, rows, _stream(dev))
        _raise_on(rc, "dynslice_accum")
        dynslice_accum.launches += 1
    return out


def _scan(wrapper, heads, val, steps, heads_type):
    dev = _device(val)
    shape = _tile_shape("val", val, dev, F32)
    if shape[1] != LANES or steps < 0:
        raise ValueError(f"{wrapper.__name__} takes val (G, 128) and "
                         f"steps ≥ 0, not {shape} and {steps}")
    _check("heads", heads, heads_type, shape, dev)
    if dev.type == "cpu":
        return seg_scan_ref(heads, val, steps)
    out = torch.empty_like(val)         # all written
    if out.numel():
        rc = _build.load().probe_segscan_f32(
            _ptr(heads), _ptr(val), _ptr(out), shape[0], steps,
            int(heads_type == torch.int8), _stream(dev))
        _raise_on(rc, wrapper.__name__)
        wrapper.launches += 1
    return out


def seg_scan(heads, val, steps: int = 7):
    """The segmented inclusive lane scan of ``probe_seg_scan``: ``steps``
    Hillis–Steele steps (7 scan a 128-lane row); heads (G, 128) int32, a
    head where > 0."""
    return _scan(seg_scan, heads, val, steps, torch.int32)


def seg_scan_roll(heads, val, steps: int = 7):
    """``seg_scan`` with int8 heads, as ``probe_seg_scan_roll`` runs it (a
    windowed scan when steps < 7)."""
    return _scan(seg_scan_roll, heads, val, steps, torch.int8)


def tile_transpose(a, nu: int, s: int):
    """out (NU, CB·S) with out[nu, cb·S + s] = a[cb, nu·S + s]; a
    (CB, NU·S) float32, any CB, NU ≥ 1 and S ≥ 1 (the kernel copies float4s
    where S % 4 == 0 and a starts on 16 bytes, floats elsewhere)."""
    dev = _device(a)
    if a.dim() != 2 or nu < 1 or s < 1 or a.shape[1] != nu * s:
        raise ValueError(f"a has shape {tuple(a.shape)}, expected "
                         f"(CB, {nu}·{s})")
    _check("a", a, F32, a.shape, dev, aligned=False)
    if dev.type == "cpu":
        return tile_transpose_ref(a, nu, s)
    cb = a.shape[0]
    out = torch.empty(nu, cb * s, dtype=F32, device=dev)   # all written
    if out.numel():
        rc = _build.load().probe_transpose_f32(_ptr(a), _ptr(out), cb, nu, s,
                                               _stream(dev))
        _raise_on(rc, "tile_transpose")
        tile_transpose.launches += 1
    return out


def slab_step(uids, base, lane, sub, val, hm1, idx, x, nu: int, T: int,
              stage: str = "all"):
    """The staged slab probe's step over H stream rows: returns (nu·8, 128)
    float32, unit u in rows [8u, 8u + 8).

    uids: (H/T,) int32 — unit per step, non-decreasing.
    base: (H,) or (H, 1) int32 — x window base row per stream row.
    lane/sub/hm1: (H, 128) int8; val: (H, 128) float32.
    idx:  (S8, H, 128) int8 end lanes, −1 masked, S8 ≤ 8.
    x:    (CB, 128) float32.
    stage: one of ``STAGES`` (see csrc/probe_slab.cu).
    Units that no step visits stay 0."""
    if stage not in STAGES:
        raise ValueError(f"stage {stage!r} is not one of {STAGES}")
    dev = _device(val)
    h = lane.shape[0]
    if T < 1 or h % T or nu < 0:
        raise ValueError(f"stream rows {h} are not a multiple of T={T}")
    s8 = idx.shape[0] if idx.dim() == 3 else 0
    if not 1 <= s8 <= MAX_S8:
        raise ValueError(f"idx has shape {tuple(idx.shape)}, expected "
                         f"(S8, H, 128) with 1 ≤ S8 ≤ {MAX_S8}")
    for name, t in (("lane", lane), ("sub", sub), ("hm1", hm1)):
        _check(name, t, torch.int8, (h, LANES), dev)
    _check("val", val, F32, (h, LANES), dev)
    _check("idx", idx, torch.int8, (s8, h, LANES), dev)
    _check("uids", uids, torch.int32, (h // T,), dev)
    if base.numel() != h:
        raise ValueError(f"base has shape {tuple(base.shape)}, expected "
                         f"({h},) or ({h}, 1)")
    _check("base", base.reshape(h), torch.int32, (h,), dev)
    _table("x", x, dev, F32)
    if dev.type == "cpu":
        return slab_step_ref(uids, base, lane, sub, val, hm1, idx, x, nu, T,
                             stage)
    out = torch.zeros(nu * 8, LANES, dtype=F32, device=dev)
    if h and nu:
        rc = _build.load().probe_slab_f32(
            *map(_ptr, (uids, base, lane, sub, val, hm1, idx, x, out)),
            h, T, s8, nu, STAGES.index(stage), unit_rows(h, T, dev),
            _stream(dev))
        _raise_on(rc, "slab_step")
        slab_step.launches += 1
    return out


WRAPPERS = (lane_gather, gather1024, palette_gather, pal2step, onehot_bins,
            sublane_gather, dynslice_accum, seg_scan, seg_scan_roll,
            tile_transpose, slab_step)
# the gather-multiply kernel's wrappers: one product an element, so exact
GATHERS = (lane_gather, gather1024, palette_gather, pal2step, sublane_gather)
for _w in WRAPPERS:
    _w.launches = 0
