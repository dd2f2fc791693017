"""Format registry of the port: ``dia``, ``hyb``, ``slab`` and ``xch`` so
far."""
from __future__ import annotations

from .base import (available_formats, convert, get_format, report_fields,
                   spmv_fn, to_coo, traffic_bytes)

_LOADED = False


def _ensure_loaded():
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    from . import dia, hyb, slab, xch
    from .base import register_format

    register_format("dia", dia)
    register_format("hyb", hyb)
    register_format("slab", slab)
    register_format("xch", xch)


__all__ = [
    "available_formats", "convert", "get_format", "report_fields",
    "spmv_fn", "to_coo", "traffic_bytes",
]
