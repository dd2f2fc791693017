"""Block-gathered scan kernel of css: the wrapper of ``csrc/blockgather.cu``
and its plain PyTorch version.

``block_gather_scan`` takes the arguments of its Pallas counterpart in
``singlespmv_tpu/ops/pallas/blockgather.py`` (:111) and returns the same
array: per (8, W) tile, x gathered from the tile's one 128-column block,
times val, scanned along each row with head flags.  On a CUDA tensor it
launches its kernel, or raises; on a CPU tensor it runs the plain version
(``block_gather_scan_ref``: the gather, the multiply and the Hillis–Steele
loop of ``ops/segsum.py``), which the tests hold against the Pallas kernels
and ``chip_smoke.py`` holds against the kernel on the card.

Values are float32 or float64, the same for val, the x table and the
output.  At float64 the native-fp64 build of the kernel runs, which stands
for the df64 kernel ``block_gather_scan_df`` (:144) of the reference, so
one call takes one value array where the reference takes (hi, lo) planes.
At bfloat16 val and the x table are read as 2 bytes and the products, the
scan and the output are float32 (``acc_dtype``).
The heads are bool or uint8, W a multiple of 4.  An empty stream launches
nothing.  The wrapper counts the launches of its float32 kernel in
``block_gather_scan.launches``, of its float64 kernel in
``block_gather_scan.launches_f64`` and of its bfloat16 kernel in
``block_gather_scan.launches_bf16``.
"""
from __future__ import annotations

import torch

from .segscan import check_heads, check_width
from .segsum import segmented_scan_inclusive
from ..core.dtypes import acc, acc_dtype
from .slab import (LANES, SPMV_TYPES, _check, _count, _entry, _ptr,
                   _raise_on, value_type)
from .xch import _device, _stream

TILE_ROWS = 8       # stream rows of a tile; a tile reads one x block


def _tile_ids(h: int) -> int:
    return -(-h // TILE_ROWS)


def block_gather_scan_ref(tile_block_ids, col, val, heads, x_table):
    """Plain version of ``block_gather_scan``."""
    h = col.shape[0]
    bid = tile_block_ids.long().repeat_interleave(TILE_ROWS)[:h, None]
    lane = col.long() - bid * LANES
    g = x_table.reshape(-1)[bid * LANES + lane]
    return segmented_scan_inclusive(acc(val) * acc(g), heads)


def block_gather_scan(tile_block_ids, col, val, heads, x_table):
    """Scanned products of a block-ordered stream.

    tile_block_ids: (ceil(H/8),) int32 — the x block of each (8, W) tile.
    col:            (H, W) int32 global columns, inside the tile's block.
    val:            (H, W) float32, float64 or bfloat16.
    heads:          (H, W) bool or uint8, nonzero at each run's start.
    x_table:        (B, 128) of val's type — x padded to 128-lane rows.
    Returns (H, W) of ``acc_dtype`` of val's type (float32 for bfloat16)."""
    dev = _device(x_table)
    if col.dim() != 2:
        raise ValueError(f"col has shape {tuple(col.shape)}, expected (H, W)")
    h, w = col.shape
    check_width(w)
    vt = value_type(val, SPMV_TYPES)
    _check("col", col, torch.int32, (h, w), dev)
    _check("val", val, vt, (h, w), dev)
    check_heads(heads, (h, w), dev)
    _check("tile_block_ids", tile_block_ids, torch.int32, (_tile_ids(h),),
           dev)
    if x_table.dim() != 2 or x_table.shape[1] != LANES:
        raise ValueError(f"x_table has shape {tuple(x_table.shape)}, "
                         f"expected (B, {LANES})")
    _check("x_table", x_table, vt, x_table.shape, dev)
    if dev.type == "cpu":
        return block_gather_scan_ref(tile_block_ids, col, val, heads,
                                     x_table)
    out = torch.empty(h, w, dtype=acc_dtype(vt), device=dev)  # all written
    if h:
        rc = _entry("block_gather_scan", vt)(
            *map(_ptr, (tile_block_ids, col, val, heads, x_table, out)), h,
            w, x_table.shape[0], _stream(dev))
        _raise_on(rc, "block_gather_scan")
        _count(block_gather_scan, vt)
    return out


block_gather_scan.launches = block_gather_scan.launches_f64 = 0
block_gather_scan.launches_bf16 = 0
