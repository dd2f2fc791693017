"""Segmented scan kernel of ss and csr5: the wrapper of ``csrc/segscan.cu``
and its plain PyTorch version.

``segmented_scan_tiles`` takes the arguments of its Pallas counterpart in
``singlespmv_tpu/ops/pallas/segscan.py`` (:51) and returns the same array:
the segmented inclusive sum-scan of each W-wide row of an (H, W) stream.  On
a CUDA tensor it launches its kernel, or raises; on a CPU tensor it runs the
plain version (``segmented_scan_tiles_ref``, the Hillis–Steele loop of
``ops/segsum.py``), which the tests hold against the Pallas kernel and
``chip_smoke.py`` holds against the kernel on the card.

Values are float32, float64 or bfloat16; at float64 the native-fp64 build
of the same kernel runs, at bfloat16 a build that reads the products as 2
bytes and scans and writes float32 (``acc_dtype``).  The heads are bool or uint8 (the formats store uint8 once, at
convert), read as stored.  W must be a multiple of 4.  An empty stream
(H = 0) launches nothing.  The wrapper counts the launches of its float32
kernel in ``segmented_scan_tiles.launches``, of its float64 kernel in
``segmented_scan_tiles.launches_f64`` and of its bfloat16 kernel in
``segmented_scan_tiles.launches_bf16``.
"""
from __future__ import annotations

import torch

from ..core.dtypes import acc, acc_dtype
from .segsum import segmented_scan_inclusive
from .slab import (SPMV_TYPES, _check, _count, _entry, _ptr, _raise_on,
                   value_type)
from .xch import _device, _stream

HEAD_TYPES = (torch.uint8, torch.bool)


def check_heads(heads, shape, dev):
    """Heads are 1-byte flags (bool or uint8) of the stream's shape."""
    if heads.dtype not in HEAD_TYPES:
        raise TypeError(f"heads are {heads.dtype}, expected one of "
                        f"{HEAD_TYPES}")
    _check("heads", heads, heads.dtype, shape, dev)


def check_width(w: int):
    if w < 4 or w % 4:
        raise ValueError(f"the scan kernels take rows of a multiple of 4 "
                         f"elements, not {w}")


def segmented_scan_tiles_ref(products, heads):
    """Plain version of ``segmented_scan_tiles`` (bfloat16 widened to
    float32)."""
    return segmented_scan_inclusive(acc(products), heads)


def segmented_scan_tiles(products, heads):
    """Segmented inclusive sum-scan along each row of an (H, W) stream.

    products: (H, W) float32, float64 or bfloat16.
    heads:    (H, W) bool or uint8, nonzero at the first element of each
              run; every row also starts a run.
    Returns (H, W) of ``acc_dtype`` of the products' type (float32 for
    bfloat16)."""
    dev = _device(products)
    if products.dim() != 2:
        raise ValueError(f"products have shape {tuple(products.shape)}, "
                         "expected (H, W)")
    h, w = products.shape
    check_width(w)
    vt = value_type(products, SPMV_TYPES)
    _check("products", products, vt, (h, w), dev)
    check_heads(heads, (h, w), dev)
    if dev.type == "cpu":
        return segmented_scan_tiles_ref(products, heads)
    out = torch.empty(h, w, dtype=acc_dtype(vt), device=dev)  # all written
    if h:
        rc = _entry("segmented_scan_tiles", vt)(
            *map(_ptr, (products, heads, out)), h, w, _stream(dev))
        _raise_on(rc, "segmented_scan_tiles")
        _count(segmented_scan_tiles, vt)
    return out


segmented_scan_tiles.launches = segmented_scan_tiles.launches_f64 = 0
segmented_scan_tiles.launches_bf16 = 0
