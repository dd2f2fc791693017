"""Planner cost-model constants, copied from
``singlespmv_tpu/core/chipconst.py``.

Every cost model of the port pulls its constants from here.  ``DEFAULTS``
are the reference's hand-measured TPU v5e literals, kept as they are: the
port's planners price plans with them until the planner is refit for the
H100 (ROADMAP A.7b).  A calibration file of the port's own,
``singlespmv_tpu_torch/chip_constants.json`` (git-ignored; written by
``python -m singlespmv_tpu_torch.harness.calibrate`` on a card), overrides
them where it exists, key by key where the value is > 0; the reference's
``results/chip_constants.json`` is never read.

Override the file location with SPMV_TORCH_CHIP_CONSTANTS=<path> (an empty
string disables loading).
"""
from __future__ import annotations

import json
import os
from typing import Dict

# hand-measured TPU v5e literals (scripts/bench_slab.py, r2-r3) — the
# fallback when no calibration has run
DEFAULTS: Dict[str, float] = {
    "hbm_bps": 700e9,          # streamed bytes/s achieved
    "step_fixed_s": 0.35e-6,   # per-grid-step fixed cost (slab kernel family)
    "base_slot_s": 0.015e-9,   # per-slot floor (gather+mul, m=1)
    "sel_slot_s": 0.002e-9,    # per window member per slot (one-hot select)
    "route_slot_s": 0.004e-9,  # per sigma-plane per slot (r4 refit v3)
    "sel_entry_s": 0.0157e-9,  # one-hot select entry cost, any m > 1 (r4:
    #   raefsky3 blk-k1 m=1 ran 0.044 ns/slot vs m=8 0.076 — the select
    #   machinery costs ~0.016 to enter plus ~0.002/member)
    "blk_route_s": 0.003e-9,   # blk mode, per kblk plane (r4 refit v3)
    "blk_fixed_s": 0.006e-9,   # blk mode, per-slot fixed route overhead
    #   (r4 v3 fit, STEP-FIXED-FREE rates — v2 double-counted the per-step
    #    fixed cost inside the per-slot rates.  With sel = entry(m>1) +
    #    m*member: route_blk = 0.006 + kblk*(0.003 + planes*0.0003),
    #    route_unit = planes*0.004.  Reproduces the driver-grade kblk/T
    #    grid on twotone/xenon2/lhr34/laminar/torso1 within ~2%)
    "scatter_rate": 0.14e9,    # XLA gather/scatter elements/s
    "lane_gather_rate": 5e9,   # fused CSS kernel stream elements/s
    "mxu_flops": 40e12,        # effective f32 batched-matmul flops/s
}

_cache: Dict[str, float] | None = None


def _path() -> str:
    env = os.environ.get("SPMV_TORCH_CHIP_CONSTANTS")
    if env is not None:
        return env
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(pkg, "chip_constants.json")


def load() -> Dict[str, float]:
    global _cache
    if _cache is None:
        vals = dict(DEFAULTS)
        p = _path()
        if p and os.path.exists(p):
            try:
                with open(p) as f:
                    data = json.load(f)
                for k, v in data.items():
                    if k in vals and isinstance(v, (int, float)) and v > 0:
                        vals[k] = float(v)
            except (OSError, ValueError):
                pass
        _cache = vals
    return _cache


def get(name: str) -> float:
    return load()[name]


def save(values: Dict[str, float], path: str = None) -> str:
    global _cache
    p = path or _path()
    os.makedirs(os.path.dirname(p), exist_ok=True)
    known = {k: float(v) for k, v in values.items() if k in DEFAULTS}
    with open(p, "w") as f:
        json.dump(known, f, indent=1, sort_keys=True)
    _cache = None
    return p
