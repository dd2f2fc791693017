"""Format registry of the port: ``auto``, ``bkt``, ``bsr``, ``csr``,
``csr5``, ``css``, ``dense``, ``dia``, ``hyb``, ``slab``, ``ss`` and ``xch``
so far (``bkt_g``, bkt at 1024-row buckets, is ``auto``'s internal name, as
in the reference)."""
from __future__ import annotations

from .base import (available_formats, convert, get_format, report_fields,
                   spmm_fn, spmv_fn, to_coo, traffic_bytes)

_LOADED = False


def _ensure_loaded():
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    from . import (auto, bkt, bsr, csr, csr5, css, dense, dia, hyb, slab, ss,
                   xch)
    from .base import register_format

    for name, mod in (("auto", auto), ("bkt", bkt), ("bsr", bsr),
                      ("csr", csr), ("csr5", csr5), ("css", css),
                      ("dense", dense), ("dia", dia), ("hyb", hyb),
                      ("slab", slab), ("ss", ss), ("xch", xch)):
        register_format(name, mod)


__all__ = [
    "available_formats", "convert", "get_format", "report_fields",
    "spmm_fn", "spmv_fn", "to_coo", "traffic_bytes",
]
