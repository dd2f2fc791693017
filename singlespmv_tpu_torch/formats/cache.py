"""Converted-state cache: ``singlespmv_tpu/formats/cache.py`` for the port.

Conversion (host sorts, planning, the route streams that ``route_rows``
derives) can take seconds to minutes on a large matrix while a spmv takes
microseconds, so the driver can keep a converted state on disk
(``run_benchmark(cache_dir=...)``).  ``save_state`` writes a state as an
``.npz`` of its tensors and a JSON tree beside it that walks the port's
``TensorState`` dataclasses: nested states (hyb's dia and residual, xch's
``long``, auto's ``inner``, ellg's rest), tuples of tensors (the per-call
streams) and of states (ellg's passes), tuples of scalars (auto's
``costs``, ``trials`` and ``failed``), and sparse tensors (bcoo's, as its
coalesced indices and values).  Every field is stored, the derived route
streams among them (slab's ``ybase``/``dest``, xch's ``base2``/``dest2``,
bkt's ``hm1r``/``dest``/``yrow``), so a load derives nothing.
``load_state`` puts the state on the caller's device.  A bfloat16 tensor,
which numpy cannot hold, is saved as its uint16 bits under a type tag and
loads back bit for bit.

A saved state carries a fingerprint: the matrix's shape, a digest of its
triplets, the Config fields that convert reads, and the layout revision
``STATE_REV`` of the format's module (for auto, of auto and of every engine
it may choose; for hyb and ellg, of every engine their rest may ride).  A
load whose fingerprint differs returns None, so a stale state is never
reused; Config fields that convert does not read (timing, verify,
profiling) do not invalidate.  The revisions are the port's own, since
its layouts are not the reference's.
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib
import json
import os
from typing import Any, Dict

import numpy as np
import torch

from ..config import Config

_SENTINEL = "__state__"
_PACKAGE = __name__.rsplit(".", 1)[0]          # the port's formats package

# the Config fields that convert reads (the reference's list)
CONVERT_FIELDS = (
    "format", "variant", "segment_width", "n_block", "padding",
    "index_bits", "omega", "sigma", "row_block", "lane_width",
    "bkt_cap_pct", "bkt_group_cols", "bkt_balance", "bkt_row_group",
    "auto_exclude", "spmm_b", "dtype")


def _encode(obj, arrays: Dict[str, np.ndarray], prefix: str):
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = type(obj)
        return {_SENTINEL: f"{cls.__module__}:{cls.__qualname__}",
                "fields": {f.name: _encode(getattr(obj, f.name), arrays,
                                           f"{prefix}.{f.name}")
                           for f in dataclasses.fields(obj)}}
    if isinstance(obj, torch.Tensor) and obj.is_sparse:
        # bcoo's matrix: its coalesced indices and values
        return {"__sparse_coo__": list(obj.shape),
                "indices": _encode(obj.indices(), arrays, f"{prefix}.indices"),
                "values": _encode(obj.values(), arrays, f"{prefix}.values")}
    if isinstance(obj, torch.Tensor):
        key = prefix.lstrip(".")
        t = obj.detach().cpu()
        if t.dtype == torch.bfloat16:
            arrays[key] = t.view(torch.uint16).numpy()
            return {"__array__": key, "dtype": "bfloat16"}
        arrays[key] = t.numpy()
        return {"__array__": key}
    if isinstance(obj, tuple):
        return {"__tuple__": [_encode(v, arrays, f"{prefix}.{i}")
                              for i, v in enumerate(obj)]}
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    raise TypeError(f"cannot serialize {type(obj)!r} at {prefix}")


def _state_class(path: str):
    """The state class ``module:qualname``, from the port's formats only."""
    mod_name, qual = path.split(":")
    if not mod_name.startswith(_PACKAGE + "."):
        raise ValueError(f"cached state class {path} is not the port's")
    return getattr(importlib.import_module(mod_name), qual)


def _decode(node, arrays, device):
    if isinstance(node, dict):
        if "__array__" in node:
            t = torch.from_numpy(arrays[node["__array__"]])
            if node.get("dtype") == "bfloat16":
                t = t.view(torch.bfloat16)
            return t.to(device)
        if "__sparse_coo__" in node:
            from .bcoo import sparse_coo

            return sparse_coo(_decode(node["indices"], arrays, device),
                              _decode(node["values"], arrays, device),
                              node["__sparse_coo__"])
        if "__tuple__" in node:
            return tuple(_decode(v, arrays, device) for v in node["__tuple__"])
        if _SENTINEL in node:
            cls = _state_class(node[_SENTINEL])
            return cls(**{k: _decode(v, arrays, device)
                          for k, v in node["fields"].items()})
    return node


def _rev(fmt: str):
    """The layout revision of format ``fmt`` (an alias: of its module):
    its module's ``STATE_REV`` (0 without one); for auto, auto's and every
    engine's, and for a format with nested rest states (hyb, ellg), its
    own and every rest engine's."""
    from .base import get_format

    try:
        mod = get_format(fmt)
    except KeyError:
        return 0
    rev = getattr(mod, "STATE_REV", 0)
    engines = mod._MODULES if fmt == "auto" else getattr(
        mod, "REST_MODULES", None)
    if engines:
        rev = {fmt: rev}
        for name, m in sorted(engines.items()):
            rev[name] = getattr(m, "STATE_REV", 0)
    return rev


def fingerprint(coo, cfg: Config) -> dict:
    """What a cached state must match: the matrix (shape and a digest of
    its triplets), the Config fields convert reads, and the revisions."""
    h = hashlib.blake2b(digest_size=16)
    for a in (coo.row, coo.col, coo.val):
        h.update(np.ascontiguousarray(a).tobytes())
    # through JSON, so that tuples compare equal to the lists a file holds
    cfg_d = json.loads(json.dumps(
        {k: v for k, v in dataclasses.asdict(cfg).items()
         if k in CONVERT_FIELDS}))
    return {"n_row": coo.n_row, "n_col": coo.n_col, "nnz": coo.nnz,
            "digest": h.hexdigest(), "config": cfg_d,
            "rev": _rev(cfg.format)}


def _paths(path: str):
    base = path[:-4] if path.endswith(".npz") else path
    return base + ".npz", base + ".json"


def save_state(path: str, state: Any, coo=None, cfg: Config = None) -> None:
    """Writes ``state`` as ``<path>.npz`` and ``<path>.json`` (with the
    fingerprint of ``coo`` and ``cfg`` where both are given)."""
    arrays: Dict[str, np.ndarray] = {}
    meta = {"tree": _encode(state, arrays, "")}
    if coo is not None and cfg is not None:
        meta["fingerprint"] = fingerprint(coo, cfg)
    npz, js = _paths(path)
    # uncompressed: value planes do not compress, and states run to GBs
    np.savez(npz, **arrays)
    with open(js, "w") as f:
        json.dump(meta, f)


def load_state(path: str, coo=None, cfg: Config = None, device="cpu"):
    """The state saved at ``path``, on ``device``; None where no state is
    saved there or, given ``coo`` and ``cfg``, its fingerprint differs."""
    npz, js = _paths(path)
    if not (os.path.exists(npz) and os.path.exists(js)):
        return None
    with open(js) as f:
        meta = json.load(f)
    if coo is not None and cfg is not None \
            and meta.get("fingerprint") != fingerprint(coo, cfg):
        return None
    with np.load(npz) as z:
        arrays = {k: z[k] for k in z.files}
    return _decode(meta["tree"], arrays, torch.device(device))


def convert_cached(coo, cfg: Config, cache_dir: str, name: str,
                   device="cpu", log=None):
    """``convert`` with a disk cache keyed by ``name`` and the fingerprint;
    the state comes back on ``device``.  Under format=auto a miss converts
    with auto's trials on ``device``."""
    from . import convert as _convert, get_format

    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, f"{name}-{cfg.format}")
    state = load_state(path, coo, cfg, device)
    if state is not None:
        return state
    if cfg.format == "auto":
        state = get_format("auto").convert(coo, cfg, device=device, log=log)
    else:
        state = _convert(coo, cfg)
    save_state(path, state, coo, cfg)
    return state.to(device)
