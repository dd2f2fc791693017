"""Calibration of the planner's cost-model constants on the card:
``singlespmv_tpu/harness/calibrate.py`` for PyTorch on one GPU.

Measures the six keys that the reference fits, with its formulas and at its
sizes, through the port's kernels:

  t(T, m) = (H/T)·step_fixed + H·128·(base + m·sel [+ planes·route])
  - ``step_fixed_s`` from the T=32 vs T=128 delta of ``xch_mul`` at m=1;
  - ``sel_slot_s`` from its m=8 vs m=1 delta at T=128;
  - ``base_slot_s`` from t(128, 1) less the steps' fixed cost;
  - ``route_slot_s`` from the planes=16 vs planes=8 delta of the v3
    ``xch_route``;
  - ``hbm_bps`` from ``torch.sum`` over a 64 Mi-element float32 array;
  - ``scatter_rate`` from ``index_add_``, the counterpart of XLA's
    ``segment_sum``.

The fit presumes the TPU's sequential grid, whose steps cost a fixed time
each.  The port's ``xch_mul`` runs a warp a row with no grid step, so on the
card the T delta is noise and the clamp can make ``step_fixed_s`` 0, which
``core/chipconst.load`` ignores (it takes only keys > 0).  The fit is kept as
the reference's; ROADMAP A.7b is the refit for the card.

    python -m singlespmv_tpu_torch.harness.calibrate [--out PATH]

measures on the card and writes the port's
``singlespmv_tpu_torch/chip_constants.json`` (or PATH) through
``core/chipconst.save``, leaving out a key that ``screen`` finds no
measurement of the card: a rate at ``_bench``'s clamp or a bandwidth above
the card's peak.  ``measure`` needs a GPU and raises without one, unless
``device="cpu"`` asks for the kernels' plain versions (tests).
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core import chipconst
from ..ops.xch import xch_mul, xch_route
from .driver import device_of, device_seconds
from .roofline import detect_chip

CLAMP_S = 1e-9          # _bench's floor on a call's seconds
N_BIG = 64 << 20        # elements of the streamed sum
N_SCATTER = 2 << 20     # elements of the scatter


def _bench(fn, args, loop=16):
    """Dispatch-corrected seconds per call: time(loop) − time(loop/2)."""
    fn(*args)

    def calls(n):
        return device_seconds(lambda: [fn(*args) for _ in range(n)],
                              args[0].device)

    t_half = calls(loop // 2)
    t_full = calls(loop)
    d = t_full - t_half
    return max(d / (loop - loop // 2), CLAMP_S)


def _mul_args(rng, H, CB, m, device="cpu"):
    win = rng.integers(0, CB - m, H).astype(np.int32)
    lane = rng.integers(0, 128, (H, 128)).astype(np.int8)
    sub = rng.integers(0, m, (H, 128)).astype(np.int8)
    val = rng.uniform(-1, 1, (H, 128)).astype(np.float32)
    xt = rng.uniform(-1, 1, (CB, 128)).astype(np.float32)
    return [torch.from_numpy(a).to(device)
            for a in (win, lane, sub, val, xt)]


def _route_args(rng, H, planes, m, T, NC=4, P1=2048, device="cpu"):
    """The v3 route's inputs of the reference: 8 steps a bucket, one source
    chunk a bucket, every lane its own run's end on plane (lane + row) %
    planes, all planes active.  Returns (args, ngb)."""
    n_steps = H // T
    nb = max(n_steps // 8, 1)
    uids = np.sort(np.repeat(np.arange(nb), 8)[:n_steps]).astype(np.int32)
    cs = rng.integers(0, NC, nb)[uids].astype(np.int32)
    win = rng.integers(0, P1 - m, H).astype(np.int32)
    lane = rng.integers(0, 128, (H, 128)).astype(np.int8)
    sub = rng.integers(0, m, (H, 128)).astype(np.int8)
    hm1 = np.broadcast_to(np.arange(-1, 127, dtype=np.int8), (H, 128)).copy()
    sig = (np.arange(128)[None, :] + np.arange(H)[:, None]) % planes
    idx = np.full((planes, H, 128), -1, np.int8)
    hh = np.repeat(np.arange(H), 128)
    ll = np.tile(np.arange(128), H)
    idx[sig.reshape(-1), hh, ll] = ll.astype(np.int8)
    prod = rng.uniform(-1, 1, (NC, P1, 128)).astype(np.float32)
    gids = (uids // 16).astype(np.int32)
    sg0 = np.zeros(n_steps, np.int32)
    sg1 = np.full(n_steps, planes - 1, np.int32)   # all planes active
    args = [torch.from_numpy(a).to(device)
            for a in (uids, gids, cs, sg0, sg1, win, lane, sub, hm1, idx,
                      prod)]
    return args, int(gids[-1]) + 1


def measure(device="cuda", log=lambda m: print(m, file=sys.stderr), *,
            n_big=N_BIG, H=16 * 1024, CB=4096, route_T=64,
            n_scatter=N_SCATTER) -> Dict[str, float]:
    """The six fitted keys, measured on ``device``.  The sizes default to
    the reference's; a test may shrink them."""
    dev = device_of(device)
    rng = np.random.default_rng(0)
    out: Dict[str, float] = {}

    # --- streamed bandwidth ---
    big = torch.from_numpy(
        rng.uniform(-1, 1, (n_big,)).astype(np.float32)).to(dev)
    sec = _bench(lambda a: torch.sum(a), [big], loop=8)
    out["hbm_bps"] = float(big.numel() * big.element_size() / sec)
    log(f"hbm_bps            = {out['hbm_bps'] / 1e9:.0f} GB/s")
    del big

    # --- slab-family kernel constants ---
    t_32_1 = _bench(lambda *a: xch_mul(*a, 1, 32),
                    _mul_args(rng, H, CB, 1, dev))
    t_128_1 = _bench(lambda *a: xch_mul(*a, 1, 128),
                     _mul_args(rng, H, CB, 1, dev))
    t_128_8 = _bench(lambda *a: xch_mul(*a, 8, 128),
                     _mul_args(rng, H, CB, 8, dev))
    fixed = max(t_32_1 - t_128_1, 0.0) / (H / 32 - H / 128)
    sel = max(t_128_8 - t_128_1, 0.0) / (H * 128 * 7)
    base = max(t_128_1 - (H / 128) * fixed, 0.0) / (H * 128)
    out["step_fixed_s"] = float(fixed)
    out["sel_slot_s"] = float(sel)
    out["base_slot_s"] = float(base)
    log(f"step_fixed_s       = {fixed * 1e6:.3f} us")
    log(f"base_slot_s        = {base * 1e9:.4f} ns")
    log(f"sel_slot_s         = {sel * 1e9:.4f} ns/member")

    a8, nb8 = _route_args(rng, H, 8, 1, route_T, device=dev)
    a16, nb16 = _route_args(rng, H, 16, 1, route_T, device=dev)
    t_r8 = _bench(lambda *a: xch_route(*a, nb8, 1, 8, route_T), a8)
    t_r16 = _bench(lambda *a: xch_route(*a, nb16, 1, 16, route_T), a16)
    route = max(t_r16 - t_r8, 0.0) / (H * 128 * 8)
    out["route_slot_s"] = float(route)
    log(f"route_slot_s       = {route * 1e9:.4f} ns/plane")

    # --- scatter (index_add_, XLA's segment_sum) rate ---
    n = n_scatter
    vals = torch.from_numpy(rng.uniform(-1, 1, n).astype(np.float32)).to(dev)
    segs = torch.from_numpy(
        rng.integers(0, n // 4, n).astype(np.int32)).to(dev)
    sec = _bench(lambda v, s: torch.zeros(n // 4, dtype=v.dtype,
                                          device=v.device).index_add_(0, s, v),
                 [vals, segs], loop=8)
    out["scatter_rate"] = float(n / sec)
    log(f"scatter_rate       = {out['scatter_rate'] / 1e9:.3f} G elem/s")

    return out


def screen(vals: Dict[str, float], peak_gbps: Optional[float], *,
           n_big=N_BIG, n_scatter=N_SCATTER
           ) -> Tuple[Dict[str, float], Dict[str, str]]:
    """Splits ``measure``'s keys (at sizes ``n_big``, ``n_scatter``) into
    those fit for the planner and, for each other, why it was left out: a
    rate that ``_bench``'s clamp made, or a bandwidth above the card's
    peak (``peak_gbps``; None for a card outside ``roofline.CHIPS``).  The
    fit itself stays the reference's."""
    why = {}
    if vals["hbm_bps"] == n_big * 4 / CLAMP_S:
        why["hbm_bps"] = "the sum timed at _bench's clamp"
    elif peak_gbps and vals["hbm_bps"] > peak_gbps * 1e9:
        why["hbm_bps"] = f"above the card's peak of {peak_gbps:g} GB/s"
    if vals["scatter_rate"] == n_scatter / CLAMP_S:
        why["scatter_rate"] = "the scatter timed at _bench's clamp"
    return {k: v for k, v in vals.items() if k not in why}, why


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="where to write the constants (default: the "
                         "port's chip_constants.json)")
    a = ap.parse_args(argv)
    dev = device_of("cuda")
    vals = measure(dev)
    keep, why = screen(vals, detect_chip(dev).hbm_gbps)
    for k, reason in why.items():
        print(f"left out {k} = {vals[k]!r}: {reason}")
    p = chipconst.save(keep, a.out)
    print(f"wrote {p}")
    print(keep)
    return keep


if __name__ == "__main__":
    main()
