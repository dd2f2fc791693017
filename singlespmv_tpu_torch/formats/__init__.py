"""Format registry of the port: every format of the reference's registry
(``singlespmv_tpu/formats/__init__.py``), with its aliases ``crs`` (csr,
the reference's spelling) and ``mkl`` (hostlib, the reference's slot
name).  ``bkt_g``, bkt at 1024-row buckets, is ``auto``'s internal name, as
in the reference."""
from __future__ import annotations

from .base import (adds_per_row, available_formats, convert, get_format,
                   report_fields, spmm_fn, spmv_fn, to_coo, traffic_bytes)

_LOADED = False


def _ensure_loaded():
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    from . import (auto, bcoo, bkt, bsr, coo, csr, csr5, css, dense, dia, ell,
                   ellg, hostlib, hyb, jds, slab, ss, xch)
    from .base import register_format

    for name, mod in (("auto", auto), ("slab", slab), ("xch", xch),
                      ("hyb", hyb), ("ellg", ellg), ("bkt", bkt),
                      ("bsr", bsr), ("coo", coo), ("csr", csr),
                      ("crs", csr), ("ell", ell), ("jds", jds), ("dia", dia),
                      ("ss", ss), ("css", css), ("csr5", csr5),
                      ("dense", dense), ("bcoo", bcoo), ("hostlib", hostlib),
                      ("mkl", hostlib)):
        register_format(name, mod)


__all__ = [
    "adds_per_row", "available_formats", "convert", "get_format",
    "report_fields", "spmm_fn", "spmv_fn", "to_coo", "traffic_bytes",
]
