"""Bucket kernels of bkt, bkt_g and ellg: the wrappers of
``csrc/bucket.cu`` and their plain PyTorch versions.

The spmv path of bkt and bkt_g is ``bucket_fused_rows``: stage A's gather
and multiply (the function of the Pallas ``block_gather_mul``,
``singlespmv_tpu/ops/pallas/bucket.py:91``) made in registers and consumed
in the same launch by stage B, which adds each run total into the caller's
y at the row that a run-end destination stream names (the function of the
Pallas ``bucket_reduce`` or ``bucket_reduce_grouped`` followed by
``lane_unpermute``, :198, :264 and :313; ``formats/bkt.py:route_rows``
derives the stream from the reference's idx planes).  ellg's passes are
``ellg_rows``: every pass of a state in one launch, each product made in
registers at gran 128, each matrix row's ``t`` slots summed and added into
y (the Pallas ``block_gather_mul`` at gran 128 followed by the reference's
row sums and y-table adds).

``block_gather_mul`` (stage A, writing the product grid) and
``bucket_rows`` (stage B, reading it back), the first port of the pair,
run on no path since the fused kernel: they stay for
``harness/bucket_ab.py``, ``chip_smoke.py`` and the parity tests, as do
``bucket_reduce``, ``bucket_reduce_grouped`` and ``lane_unpermute``, the
first port of stage B.  The first two take the arguments of their Pallas
counterparts and return the same arrays, as do the last three.  On a CUDA
tensor a wrapper launches its kernel, or raises; on a CPU tensor it runs
the plain version (``*_ref``), which the tests hold against the Pallas
kernels and ``chip_smoke.py`` holds against the kernels on the card.

Values are float32, and on the spmv paths (``bucket_fused_rows``,
``ellg_rows`` and the pair) also bfloat16 (``STAGE_TYPES``): the
reference's bkt refuses float64 on its chip, and every wrapper raises
``TypeError`` on another value type.  At bfloat16 val and the x table are
2 bytes, each product is rounded once to bfloat16 (as the reference's are
``val.dtype``; ``block_gather_mul`` stores them so), and the sums are
float32 into a float32 y, which the caller rounds once.  Each wrapper
counts the launches of its float32 kernel in ``<wrapper>.launches`` and of
its bfloat16 kernel in ``<wrapper>.launches_bf16``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from ..core.dtypes import acc
from . import _build
from .slab import (LANES, _check, _count, _entry, _picked, _ptr, _raise_on,
                   _totals, value_type)
from .xch import _device, _stream

SIGMAS = 8          # 128-row blocks of a 1024-row unit
STAGE_TYPES = (torch.float32, torch.bfloat16)   # the spmv path's values
ROW_GROUPS = {128: torch.int8, 1024: torch.int16}   # rg → dest type


# ----------------------------------------------------- plain PyTorch versions

def block_gather_mul_ref(members, lane, src, val, x_table, m: int = 1,
                         gran: int | None = None):
    """Plain version of ``block_gather_mul``."""
    h, w = lane.shape
    gran = w if gran is None else gran
    s = torch.arange(h * w, device=lane.device)
    j = src.reshape(-1).long() if m > 1 else torch.zeros_like(s)
    member = members.long()[(s // gran) * m + j.clamp(0, m - 1)]
    g = x_table.reshape(-1)[member * LANES + lane.reshape(-1).long()]
    g = torch.where((j >= 0) & (j < m), acc(g), 0.0)
    return (acc(val) * g.view(h, w)).to(val.dtype)


def bucket_reduce_ref(products, hm1, idx, rb_pad: int):
    """Plain version of ``bucket_reduce``."""
    rows = products.shape[0]
    g = rows // rb_pad
    k = idx.shape[0] // rows
    w = _totals(products, hm1).view(rb_pad // 8, 8 * g, LANES)
    e = idx.view(rb_pad // 8, k, 8 * g, LANES)
    acc = sum(_picked(w.reshape(-1, LANES), e[:, kk].reshape(-1, LANES))
              for kk in range(k))
    # row r of a block adds into output row r mod 8 of its block
    return acc.view(rb_pad // 8, g, 8, LANES).sum(1).reshape(rb_pad, LANES)


def bucket_reduce_grouped_ref(prod_grid, hm1, idx, nu_pad: int,
                              n_chunks: int = 1):
    """Plain version of ``bucket_reduce_grouped``; ``n_chunks`` (a VMEM cut
    of the TPU) changes nothing."""
    cb = prod_grid.shape[0]
    k = idx.shape[1]
    v = prod_grid.permute(1, 0, 2).reshape(-1, LANES)
    w = _totals(v, hm1.reshape(-1, LANES)).view(nu_pad, cb, LANES)
    out = torch.zeros(nu_pad, SIGMAS, LANES, dtype=prod_grid.dtype,
                      device=prod_grid.device)
    for kk in range(k):
        e = idx[:, kk].long()                             # (NU, CB, 128)
        ok = (e >= 0) & (e < SIGMAS * LANES)
        picked = torch.gather(w, 2, torch.where(ok, e & (LANES - 1), 0))
        out.scatter_add_(1, torch.where(ok, e >> 7, 0),
                         torch.where(ok, picked, 0.0))
    return out.view(nu_pad * SIGMAS, LANES)


def bucket_rows_ref(prod, hm1r, dest, yrow, y, sh: int, nu_pad: int,
                    parts: int = 0):
    """Plain version of ``bucket_rows``: ``index_add_`` of the run totals
    at their y rows (``parts`` picks a kernel, not a function); bfloat16
    products are widened and summed in float32."""
    h = prod.shape[0]
    rg = yrow.numel() // nu_pad
    w = _totals(acc(prod), hm1r)
    unit = (torch.arange(h, device=prod.device) // sh) % nu_pad
    d = dest.long()
    inside = (d >= 0) & (d < rg)
    pos = yrow.long()[unit[:, None] * rg + torch.where(inside, d, 0)]
    keep = inside & (pos >= 0) & (pos < y.numel())
    return y.index_add_(0, pos[keep], w[keep])


def bucket_fused_rows_ref(members, lane, src, val, x_table, m: int, hm1r,
                          dest, yrow, y, sh: int, nu_pad: int, parts: int = 0,
                          gran: int | None = None):
    """Plain version of ``bucket_fused_rows``: stage A's plain version, then
    stage B's on its products."""
    prod = block_gather_mul_ref(members, lane, src, val, x_table, m, gran)
    return bucket_rows_ref(prod.view(-1, LANES), hm1r, dest, yrow, y, sh,
                           nu_pad, parts)


class RowPass(NamedTuple):
    """One ellg pass as ``ellg_rows`` takes it: a stream of
    n_blocks · t rows of 128 slots (``lane``/``val``/``src`` of
    n_blocks · t · 128 slots, t slots a matrix row), m ids of ``members`` a
    stream row, ids local to its x panel, the col-blocks panel_base …
    panel_base + panel_cb − 1 of x; block b of the pass is y's block
    ``blocks[b]``, or b where ``blocks`` is None."""
    t: int
    m: int
    panel_base: int
    panel_cb: int
    members: torch.Tensor              # (n_blocks·t·m,) int32
    lane: torch.Tensor                 # (H, W) int8
    src: Optional[torch.Tensor]        # (H, W) int8; None if m == 1
    val: torch.Tensor                  # (H, W) float32 or bfloat16
    blocks: Optional[torch.Tensor]     # (n_blocks,) int32, or None


def _n_blocks(p: RowPass) -> int:
    return p.lane.numel() // (LANES * p.t)


def ellg_rows_ref(passes, xp, y, stage_a=block_gather_mul_ref):
    """Plain version of ``ellg_rows``: per pass, stage A at gran 128 on its
    x panel, the (−1, t) row sums, added into a (RB, 128) y table (its
    first n_blocks rows where ``blocks`` is None, ``index_add_`` at its
    ``blocks`` where not); then the table, cut to y's rows, into y.  With
    ``stage_a=block_gather_mul`` (the kernel on a card) this is the first
    port of the passes."""
    rb = -(-y.numel() // LANES)
    y2 = torch.zeros(rb, LANES, dtype=torch.float32, device=y.device)
    for p in passes:
        nb = _n_blocks(p)
        lo = p.panel_base * LANES
        xpan = xp[lo: lo + p.panel_cb * LANES].view(p.panel_cb, LANES)
        prod = stage_a(p.members, p.lane, p.src, p.val, xpan, p.m,
                       gran=LANES)
        part = acc(prod).view(-1, p.t).sum(dim=1).view(nb, LANES)
        if p.blocks is None:
            k = min(nb, rb)
            y2[:k] += part[:k]
        else:
            y2.index_add_(0, p.blocks, part)
    return y.add_(y2.view(-1)[: y.numel()])


def lane_unpermute_ref(y_t, src_lane, src_chunk):
    """Plain version of ``lane_unpermute``."""
    rows, cols = y_t.shape
    lane, chunk = src_lane.long(), src_chunk.long()
    col = chunk * LANES + lane
    ok = (lane >= 0) & (lane < LANES) & (chunk >= 0) & (col < cols)
    r = torch.arange(rows, device=y_t.device)[:, None]
    flat = torch.where(ok, r * cols + col, 0)
    return torch.where(ok, y_t.reshape(-1)[flat], 0.0)


# --------------------------------------------------------------- wrappers ---

def _check_stage_a(members, lane, src, val, x_table, m, gran):
    """Checks of stage A's arguments.  Returns (device, gran, value
    type)."""
    dev = _device(x_table)
    if lane.dim() != 2:
        raise ValueError(f"lane has shape {tuple(lane.shape)}, expected "
                         "(H, W)")
    h, w = lane.shape
    gran = w if gran is None else gran
    if m < 1 or gran < LANES or gran % LANES or (h * w) % gran:
        raise ValueError(f"stage A takes m ≥ 1 and a gran of whole 128-slot "
                         f"rows dividing the stream; not m={m}, gran={gran}")
    _check("lane", lane, torch.int8, (h, w), dev)
    if src is None and m > 1:
        raise ValueError(f"stage A with m={m} needs src")
    if src is not None:
        _check("src", src, torch.int8, (h, w), dev)
    vt = value_type(val, STAGE_TYPES)
    _check("val", val, vt, (h, w), dev)
    _check("members", members, torch.int32, (h * w // gran * m,), dev)
    if x_table.dim() != 2 or x_table.shape[1] != LANES:
        raise ValueError(f"x_table has shape {tuple(x_table.shape)}, "
                         f"expected (CB, {LANES})")
    _check("x_table", x_table, vt, x_table.shape, dev)
    return dev, gran, vt


def _check_stage_b(h, hm1r, dest, yrow, y, sh, nu_pad, parts, dev):
    """Checks of stage B's arguments for ``h`` stream rows.  Returns the
    row group rg."""
    if sh < 1 or nu_pad < 1 or h < 0 or h % (sh * nu_pad):
        raise ValueError(f"the stream's {h} rows of {LANES} are not whole "
                         f"units of nu_pad·sh = {nu_pad}·{sh} rows")
    rg = yrow.numel() // nu_pad if yrow.dim() == 1 else 0
    if rg not in ROW_GROUPS:
        raise ValueError(f"yrow has shape {tuple(yrow.shape)}, expected "
                         f"(nu_pad·rg,) with rg in {tuple(ROW_GROUPS)}")
    if parts < 0:
        raise ValueError(f"{parts} parts a unit")
    _check("hm1r", hm1r, torch.int8, (h, LANES), dev)
    _check("dest", dest, ROW_GROUPS[rg], (h, LANES), dev)
    _check("yrow", yrow, torch.int32, (nu_pad * rg,), dev)
    _check_y(y, dev)
    return rg


def _check_y(y, dev):
    if y.dim() != 1 or y.numel() >= 2 ** 31:
        raise ValueError(f"y has shape {tuple(y.shape)}, expected (n,) with "
                         "n < 2**31")
    _check("y", y, torch.float32, y.shape, dev)


def block_gather_mul(members, lane, src, val, x_table, m: int = 1,
                     gran: int | None = None):
    """Stage A: products[s] = val[s] · x_table[members[unit(s)·m + src[s]],
    lane[s]] over the (H, W) stream, unit(s) = s // gran (gran defaults to
    W: one unit per stream row, the bkt layout).

    members: (H·W/gran·m,) int32; lane, src: (H, W) int8 (src unread if
    m == 1, and then it may be None: the kernel gets a null pointer, as
    ellg's passes of one member carry none); val: (H, W) float32 or
    bfloat16; x_table: (CB, 128) of val's type.  Returns (H, W) of val's
    type."""
    dev, gran, vt = _check_stage_a(members, lane, src, val, x_table, m, gran)
    if dev.type == "cpu":
        return block_gather_mul_ref(members, lane, src, val, x_table, m, gran)
    h, w = lane.shape
    out = torch.empty(h, w, dtype=vt, device=dev)  # all written
    if h:
        src_p = ctypes.c_void_p(None) if src is None else _ptr(src)
        rc = _entry("block_gather_mul", vt)(
            _ptr(members), _ptr(lane), src_p, _ptr(val), _ptr(x_table),
            _ptr(out), h, w, gran, m, _stream(dev))
        _raise_on(rc, "block_gather_mul")
        _count(block_gather_mul, vt)
    return out


def bucket_reduce(products, hm1, idx, rb_pad: int):
    """Stage B of 128-row buckets over the rb-major, j-interleaved product
    stream.

    products/hm1: (RB_pad·G, 128) float32 / int8; block i holds rows
                  [i·8G, (i+1)·8G).
    idx:          (K·RB_pad·G, 128) int8 — per block, K planes stacked
                  (block-major, K-minor); < 0 masked.
    Returns (RB_pad, 128) float32 row sums."""
    dev = _device(products)
    rows = products.shape[0]
    if rb_pad < 8 or rb_pad % 8 or rows % rb_pad or rows == 0:
        raise ValueError(f"stage B takes RB_pad a multiple of 8 dividing "
                         f"the {rows} stream rows, not {rb_pad}")
    g = rows // rb_pad
    if idx.dim() != 2 or idx.shape[0] % rows or idx.shape[0] == 0:
        raise ValueError(f"idx has shape {tuple(idx.shape)}, expected "
                         f"(K·{rows}, {LANES})")
    k = idx.shape[0] // rows
    _check("products", products, torch.float32, (rows, LANES), dev)
    _check("hm1", hm1, torch.int8, (rows, LANES), dev)
    _check("idx", idx, torch.int8, (k * rows, LANES), dev)
    if dev.type == "cpu":
        return bucket_reduce_ref(products, hm1, idx, rb_pad)
    out = torch.empty(rb_pad, LANES, dtype=torch.float32, device=dev)
    rc = _build.load().bucket_reduce_f32(
        *map(_ptr, (products, hm1, idx, out)), rb_pad, g, k, _stream(dev))
    _raise_on(rc, "bucket_reduce")
    bucket_reduce.launches += 1
    return out


def bucket_reduce_grouped(prod_grid, hm1, idx, nu_pad: int,
                          n_chunks: int = 1):
    """Stage B of 1024-row buckets over the cb-major product grid.

    prod_grid: (CB, NU_pad, 128) float32 — stage A's output viewed 3-D.
    hm1:       (NU_pad, CB, 128) int8.
    idx:       (NU_pad, K, CB, 128) int16 — entry σ·128 + end lane, < 0
               masked.
    n_chunks:  the TPU's col-block chunking; the kernel takes every
               col-block of a unit in one block, so only CB % n_chunks == 0
               is checked.
    Returns (NU_pad·8, 128) float32: row u·8 + σ holds unit u's rows
    σ·128 … σ·128 + 127."""
    dev = _device(prod_grid)
    if prod_grid.dim() != 3 or prod_grid.shape[1] != nu_pad \
            or prod_grid.shape[2] != LANES or prod_grid.shape[0] < 1:
        raise ValueError(f"prod_grid has shape {tuple(prod_grid.shape)}, "
                         f"expected (CB, {nu_pad}, {LANES})")
    cb = prod_grid.shape[0]
    if n_chunks < 1 or cb % n_chunks or nu_pad % 8:
        raise ValueError(f"CB={cb} in {n_chunks} chunks, NU_pad={nu_pad}: "
                         "chunks must divide CB and NU_pad be a multiple of 8")
    if idx.dim() != 4 or idx.shape[1] < 1:
        raise ValueError(f"idx has shape {tuple(idx.shape)}, expected "
                         f"({nu_pad}, K, {cb}, {LANES})")
    k = idx.shape[1]
    _check("prod_grid", prod_grid, torch.float32, prod_grid.shape, dev)
    _check("hm1", hm1, torch.int8, (nu_pad, cb, LANES), dev)
    _check("idx", idx, torch.int16, (nu_pad, k, cb, LANES), dev)
    if dev.type == "cpu":
        return bucket_reduce_grouped_ref(prod_grid, hm1, idx, nu_pad,
                                         n_chunks)
    out = torch.empty(nu_pad * SIGMAS, LANES, dtype=torch.float32,
                      device=dev)
    if nu_pad:
        rc = _build.load().bucket_reduce_grouped_f32(
            *map(_ptr, (prod_grid, hm1, idx, out)), cb, nu_pad, k,
            _stream(dev))
        _raise_on(rc, "bucket_reduce_grouped")
        bucket_reduce_grouped.launches += 1
    return out


def bucket_rows(prod, hm1r, dest, yrow, y, sh: int, nu_pad: int,
                parts: int = 0):
    """Stage B on the run-end stream: adds each run total of the product
    stream into ``y`` at its row; returns ``y``.

    prod:  (H, 128) float32 or bfloat16 — stage A's products in their own
           order, stream
           row r = (c·nu_pad + n)·sh + j of unit n (H a multiple of
           nu_pad·sh).
    hm1r:  (H, 128) int8 — lane of the run head − 1, in the same order.
    dest:  (H, 128) int8 (rg = 128) or int16 (rg = 1024) — at a run's end
           slot, its row in unit n's rg rows; −1 on every other slot.
    yrow:  (nu_pad·rg,) int32 — y row of unit row n·rg + d; −1 dropped.
    y:     (n,) float32 (for either product type), zeroed by the caller;
           rows at or past n are dropped.
    parts: 0, a warp a stream row with a reduction a run end; else the
           merge kernel, ``parts`` blocks a unit summing their warps' rows
           in shared memory before a reduction a y row
           (``formats/bkt.py:route_rows`` picks it where rows end many
           runs; a row's dests must then be distinct).  The function is
           the same.
    The sums of a y row add in run-dependent order on the card."""
    dev = _device(prod)
    h = prod.shape[0] if prod.dim() == 2 else -1
    if sh < 1 or nu_pad < 1 or h < 0 or h % (sh * nu_pad):
        raise ValueError(f"prod has shape {tuple(prod.shape)}, expected "
                         f"(H, {LANES}) with H a multiple of nu_pad·sh = "
                         f"{nu_pad}·{sh}")
    vt = value_type(prod, STAGE_TYPES)
    _check("prod", prod, vt, (h, LANES), dev)
    rg = _check_stage_b(h, hm1r, dest, yrow, y, sh, nu_pad, parts, dev)
    if dev.type == "cpu":
        return bucket_rows_ref(prod, hm1r, dest, yrow, y, sh, nu_pad, parts)
    if h:
        rc = _entry("bucket_rows", vt)(
            *map(_ptr, (prod, hm1r, dest, yrow, y)), h, sh, nu_pad, rg,
            y.numel(), parts, _stream(dev))
        _raise_on(rc, "bucket_rows")
        _count(bucket_rows, vt)
    return y


def bucket_fused_rows(members, lane, src, val, x_table, m: int, hm1r, dest,
                      yrow, y, sh: int, nu_pad: int, parts: int = 0,
                      gran: int | None = None):
    """Stage A and stage B in one launch: the products of
    ``block_gather_mul`` (same arguments; ``gran`` defaults to W) made in
    registers and added as ``bucket_rows`` adds its ``prod`` (same
    arguments; stream row r of ``prod`` is slots r·128 … r·128 + 127 of
    the (H, W) stream), with no product grid in device memory.  Adds into
    ``y`` (float32, zeroed by the caller) and returns it.  At bfloat16 each
    product is rounded once to bfloat16 before the sums, as stage A stores
    it.  The sums of a y row add in run-dependent order on the card."""
    dev, gran, vt = _check_stage_a(members, lane, src, val, x_table, m, gran)
    h = lane.numel() // LANES
    rg = _check_stage_b(h, hm1r, dest, yrow, y, sh, nu_pad, parts, dev)
    if dev.type == "cpu":
        return bucket_fused_rows_ref(members, lane, src, val, x_table, m,
                                     hm1r, dest, yrow, y, sh, nu_pad, parts,
                                     gran)
    if h:
        src_p = ctypes.c_void_p(None) if src is None else _ptr(src)
        rc = _entry("bucket_fused_rows", vt)(
            _ptr(members), _ptr(lane), src_p, _ptr(val), _ptr(x_table),
            *map(_ptr, (hm1r, dest, yrow, y)), h, gran, m, sh, nu_pad, rg,
            y.numel(), parts, _stream(dev))
        _raise_on(rc, "bucket_fused_rows")
        _count(bucket_fused_rows, vt)
    return y


ELLG_MAX_PASSES = 32    # passes a launch of ellg_rows (csrc: kMaxPasses)


def _check_pass(i, p, xp, vt, dev):
    """Checks of ellg pass ``i`` (a ``RowPass``) against the flat x."""
    t, m = p.t, p.m
    if t < 1 or t > LANES or t & (t - 1) or m < 1:
        raise ValueError(f"pass {i}: t={t} (a power of two ≤ {LANES}) and "
                         f"m={m} are not a pass's")
    if p.panel_base < 0 or p.panel_cb < 1 \
            or (p.panel_base + p.panel_cb) * LANES > xp.numel():
        raise ValueError(f"pass {i}: its panel [{p.panel_base}, "
                         f"{p.panel_base + p.panel_cb}) lies outside x's "
                         f"{xp.numel() // LANES} col-blocks")
    if p.lane.dim() != 2 or p.lane.numel() % (t * LANES):
        raise ValueError(f"pass {i}: lane has shape {tuple(p.lane.shape)}, "
                         f"expected whole blocks of {t * LANES} slots")
    nb = _n_blocks(p)
    shape = tuple(p.lane.shape)
    _check("lane", p.lane, torch.int8, shape, dev)
    _check("val", p.val, vt, shape, dev)
    if p.src is None and m > 1:
        raise ValueError(f"pass {i} with m={m} needs src")
    if p.src is not None:
        _check("src", p.src, torch.int8, shape, dev)
    _check("members", p.members, torch.int32, (nb * t * m,), dev)
    if p.blocks is not None:
        _check("blocks", p.blocks, torch.int32, (nb,), dev)


def ellg_rows(passes, xp, y):
    """ellg's passes in one launch (one a ``ELLG_MAX_PASSES`` passes): per
    pass, the products val · x_panel[members[r·m + src], lane] of its
    stream row r (gran 128) made in registers, the sum of each matrix
    row's ``t`` consecutive slots, added into ``y`` at the row's y row
    (block b of the pass is y's block ``blocks[b]``, or b where ``blocks``
    is None; blocks at or past ⌈n/128⌉ and rows at or past n dropped).
    Returns ``y``.

    passes: ``RowPass`` tuples; xp: (CB·128,) the zero-padded x, of the
            passes' value type; y: (n,) float32, zeroed by the caller.  At
            bfloat16 each product is rounded once to bfloat16 before the
            sums.  The sums of a y row add in run-dependent order on the
            card."""
    dev = _device(xp)
    if xp.dim() != 1 or xp.numel() % LANES:
        raise ValueError(f"xp has shape {tuple(xp.shape)}, expected "
                         f"(CB·{LANES},)")
    vt = value_type(xp, STAGE_TYPES)
    _check("xp", xp, vt, xp.shape, dev)
    _check_y(y, dev)
    for i, p in enumerate(passes):
        _check_pass(i, p, xp, vt, dev)
    if dev.type == "cpu":
        return ellg_rows_ref(passes, xp, y)
    live = [p for p in passes if p.lane.numel()]
    if live:
        ptrs = (ctypes.c_void_p * (6 * len(live)))()
        ints = (ctypes.c_int * (3 * len(live)))()
        for i, p in enumerate(live):
            ptrs[6 * i: 6 * i + 6] = [
                p.members.data_ptr(), p.lane.data_ptr(),
                None if p.src is None else p.src.data_ptr(),
                p.val.data_ptr(),
                None if p.blocks is None else p.blocks.data_ptr(),
                xp.data_ptr() + p.panel_base * LANES * xp.element_size()]
            ints[3 * i: 3 * i + 3] = [p.t, p.m, _n_blocks(p)]
        rc = _entry("ellg_rows", vt)(
            ptrs, ints, len(live), _ptr(y), -(-y.numel() // LANES),
            y.numel(), _stream(dev))
        _raise_on(rc, "ellg_rows")
        for _ in range(-(-len(live) // ELLG_MAX_PASSES)):
            _count(ellg_rows, vt)
    return y


def lane_unpermute(y_t, src_lane, src_chunk):
    """out[r, j] = y_t[r, src_chunk[r, j]·128 + src_lane[r, j]] (0 where
    that lies outside the row): the static inverse of the balance
    permutation.  y_t: (rows, cols) float32; src_lane, src_chunk: (rows,
    cols) int32.  Returns (rows, cols) float32."""
    dev = _device(y_t)
    if y_t.dim() != 2 or y_t.shape[1] < 1:
        raise ValueError(f"y_t has shape {tuple(y_t.shape)}, expected "
                         "(rows, cols)")
    _check("y_t", y_t, torch.float32, y_t.shape, dev)
    for name, t in (("src_lane", src_lane), ("src_chunk", src_chunk)):
        _check(name, t, torch.int32, y_t.shape, dev)
    if dev.type == "cpu":
        return lane_unpermute_ref(y_t, src_lane, src_chunk)
    rows, cols = y_t.shape
    out = torch.empty(rows, cols, dtype=torch.float32, device=dev)
    if rows:
        rc = _build.load().lane_unpermute_f32(
            *map(_ptr, (y_t, src_lane, src_chunk, out)), rows, cols,
            _stream(dev))
        _raise_on(rc, "lane_unpermute")
        lane_unpermute.launches += 1
    return out


block_gather_mul.launches = block_gather_mul.launches_bf16 = 0
bucket_reduce.launches = 0
bucket_reduce_grouped.launches = 0
bucket_rows.launches = bucket_rows.launches_bf16 = 0
bucket_fused_rows.launches = bucket_fused_rows.launches_bf16 = 0
ellg_rows.launches = ellg_rows.launches_bf16 = 0
lane_unpermute.launches = 0
