"""The staged slab-step probe on the card: ``scripts/probe_slab.py`` for
PyTorch on one GPU.

A fused slab step on synthetic tiles — 8-row window gather, 8-way select,
run totals and S8 σ-plane routes into an (NU·8, 128) out — timed in the
microbenchmarks' chained loop (``microbench.chained``: replayed CUDA graphs
on the card), whole (stage "all") or cut at a stage
(``ops.probes.STAGES``: window, gather, select, prefix, route, routeonly).
``main`` runs the reference's nine (T, S8, stage) rows at CB 1,700 and
NU 208 and prints G slot/s per row:

    python -m singlespmv_tpu_torch.harness.probe_slab [--target-s S]

It needs a GPU and raises without one, unless ``device="cpu"`` asks for the
kernel's plain version.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops import probes
from .driver import best_marginal_seconds, device_of
from .microbench import TARGET_S, chained

LANES = 128
CB, NU = 1700, 208
# (T, S8, stage): the reference's rows
ROWS = ((16, 8, "all"), (32, 8, "all"), (64, 8, "all"), (32, 8, "window"),
        (32, 8, "gather"), (32, 8, "select"), (32, 8, "prefix"),
        (32, 8, "routeonly"), (32, 2, "all"))


def make_call(n_steps, T, S8, CB, NU, dtype=torch.float32, stage="all"):
    """(call, H): call(uids, base, lane, sub, val, hm1, idx, x) runs the
    probe's step over H = n_steps·T stream rows, as the reference's
    ``make_call`` returns its Pallas call."""
    if dtype != torch.float32:
        raise TypeError(f"the slab probe runs float32, not {dtype}")

    def call(uids, base, lane, sub, val, hm1, idx, x):
        return probes.slab_step(uids, base, lane, sub, val, hm1, idx, x, NU,
                                T, stage)

    return call, n_steps * T


def make_inputs(rng, n_steps, T, S8, CB, NU):
    """The reference's synthetic tiles, from ``rng`` in its order: uids,
    base, lane, sub, val, hm1 (random run heads), idx (~0.3 ends a row
    spread over S8 planes), x."""
    H = n_steps * T
    steps_per_unit = n_steps // NU
    uids = np.repeat(np.arange(NU, dtype=np.int32), steps_per_unit)
    uids = np.concatenate([uids, np.full(n_steps - len(uids), NU - 1,
                                         np.int32)])
    base = rng.integers(0, CB - 8, (H, 1)).astype(np.int32)
    lane = rng.integers(0, LANES, (H, LANES)).astype(np.int8)
    sub = rng.integers(0, 8, (H, LANES)).astype(np.int8)
    val = rng.standard_normal((H, LANES)).astype(np.float32)
    heads = rng.random((H, LANES)) < 0.5
    heads[:, 0] = True
    lane_i = np.broadcast_to(np.arange(LANES), (H, LANES))
    hm1 = (np.maximum.accumulate(np.where(heads, lane_i, -1), axis=1)
           - 1).astype(np.int8)
    idx = np.full((S8, H, LANES), -1, np.int8)
    for s in range(S8):
        mask = rng.random((H, LANES)) < (0.3 / S8)
        ends = rng.integers(0, LANES, (H, LANES))
        idx[s] = np.where(mask, ends, -1).astype(np.int8)
    x = rng.standard_normal((CB, LANES)).astype(np.float32)
    return uids, base, lane, sub, val, hm1, idx, x


def main(device="cuda", target_s=TARGET_S, rows=ROWS, log=print):
    """Times each (T, S8, stage) of ``rows``; returns
    [(T, S8, stage, seconds, G slot/s)]."""
    dev = device_of(device)
    rng = np.random.default_rng(7)
    out = []
    for T, S8, stage in rows:
        n_steps = 3200 // (T // 8)
        call, H = make_call(n_steps, T, S8, CB, NU, stage=stage)
        uids, base, lane, sub, val, hm1, idx, x = [
            torch.from_numpy(a).to(dev)
            for a in make_inputs(rng, n_steps, T, S8, CB, NU)]

        def body(c, tiny, base, lane, sub, hm1, idx, x, call=call,
                 uids=uids):
            y = call(uids, base, lane, sub, c, hm1, idx, x)
            return c * (1.0 + y[0, 0] * tiny)

        sec = best_marginal_seconds(chained(body), val,
                                    (base, lane, sub, hm1, idx, x),
                                    target_s=target_s)
        slots = H * LANES
        log(f"T={T:3d} S8={S8} {stage:9s}: {sec * 1e6:9.1f} us  "
            f"{slots / sec / 1e9:7.2f} G slot/s")
        out.append((T, S8, stage, sec, slots / sec / 1e9))
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--target-s", type=float, default=TARGET_S)
    main(target_s=ap.parse_args().target_s)
