"""Smoke run of the PyTorch/CUDA port (singlespmv_tpu_torch) on one GPU.

    python3 chip_smoke.py          # from the root of the repository

1. prints the card's name and power limit, builds the CUDA kernels of
   ``singlespmv_tpu_torch/csrc`` with nvcc for sm_90a (one nvcc per source,
   in parallel);
2. holds each kernel against its plain PyTorch version on the card, at the
   stream shapes of the states below (every call of a state, and of its
   nested long-row state), and times kernel, plain version and the whole
   spmv call;
3. drives the slab main path: ``run_benchmark`` with format="slab" in float32
   on the full-size raefsky3 and torso1 stand-ins (both plan blk mode), and
   the full-size g7jac200sc stand-in's spmv with the planner's unit-only plan
   against the float64 COO oracle;
4. drives the xch main path: ``run_benchmark`` with format="xch" in float32
   on the full-size webbase-1M and ASIC_680ks stand-ins, and the spmv of the
   full-size circuit5M stand-in (several kernel calls per pass, a nested
   long-row state) against the float64 COO oracle;
5. checks that each path launched each of its kernels: the launch counts are
   set to 0 just before a path and read just after it.

Prints a JSON line of per-kernel results, and as its last line
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result, when
no CUDA device is present or any phase fails.
"""
import json
import subprocess
import sys
import time

import numpy as np
import torch

CFG_KW = dict(format="slab", dtype="float32")
TOL = 1e-5          # kernel vs plain version, relative to max|out|: the
#                     prefix and the atomics sum in other orders
REPS = 20
SLAB_MATS = ("raefsky3", "torso1", "g7jac200sc")
XCH_MATS = ("webbase-1M", "ASIC_680ks", "circuit5M")


def _cuda_ms(fn, reps=REPS):
    """Milliseconds per call on the device's clock (CUDA events around
    ``reps`` back-to-back calls, after one warm-up): host gaps included."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _busy_ms(fn, match="", reps=REPS):
    """Milliseconds per call that the device spends in kernels, memsets and
    copies whose name contains ``match`` (torch.profiler, CUDA activity)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if match in e.key)
    if us <= 0:
        raise SystemExit(f"torch.profiler saw no device time for {match!r}")
    return us / reps / 1e3


def _chunk_calls(state, x_table, ops, plain):
    """One function per chunk that runs the state's kernel (or its plain
    version) over the chunk, as formats/slab.spmv calls it."""
    if state.mode == "blk":
        fn = ops.slab_spmv_blk_ref if plain else ops.slab_spmv_blk
        return [lambda a=a, nu=nu: fn(*a, x_table, nu, state.m,
                                      state.planes, state.t_step)
                for *a, nu in zip(state.uids, state.win, state.lane,
                                  state.sub, state.val, state.hm1, state.idx,
                                  state.sig, state.chunk_nu)]
    fn = ops.slab_spmv_ref if plain else ops.slab_spmv
    return [lambda a=a, nu=nu: fn(*a, x_table, nu, state.m, state.t_step)
            for *a, nu in zip(state.uids, state.sg0, state.sg1, state.win,
                              state.lane, state.sub, state.val, state.hm1,
                              state.idx, state.chunk_nu)]


def compare_kernel(label, state, slab, ops, x):
    """Phase 2 for one state: kernel vs plain version on every chunk."""
    xt = slab.x_table(state, x)
    kern = _chunk_calls(state, xt, ops, plain=False)
    ref = _chunk_calls(state, xt, ops, plain=True)
    err = scale = 0.0
    for k, r in zip(kern, ref):
        got, want = k(), r()
        torch.cuda.synchronize()
        err = max(err, float((got - want).abs().max()))
        scale = max(scale, float(want.abs().max()))
    rel = err / max(scale, 1e-30)
    kernel_name = "slab_blk_kernel" if state.mode == "blk" \
        else "slab_unit_kernel"
    res = {
        "label": label, "mode": state.mode, "planes": state.planes,
        "kblk": state.idx[0].shape[0] if state.mode == "blk" else None,
        "m": state.m, "T": state.t_step, "stream_rows": state.n_slots // 128,
        "max_abs_err": err, "rel_err": rel,
        # device busy time: the kernel alone, the plain version's kernels
        "ms": _busy_ms(lambda: [f() for f in kern], kernel_name),
        "plain_ms": _busy_ms(lambda: [f() for f in ref]),
        # per call on the device's clock, host gaps included
        "call_ms": _cuda_ms(lambda: [f() for f in kern]),
        "plain_call_ms": _cuda_ms(lambda: [f() for f in ref]),
        "spmv_ms": _cuda_ms(lambda: slab.spmv(state, x)),
        "spmv_busy_ms": _busy_ms(lambda: slab.spmv(state, x)),
    }
    print(f"kernel {label}: {res}")
    if not rel <= TOL:
        raise SystemExit(f"{label}: kernel disagrees with its plain version "
                         f"(max |diff| / max |out| = {rel:.3g} > {TOL})")
    return res


def _states(state):
    """The state and its nested long-row states, outermost first."""
    while state is not None:
        yield state
        state = state.long


def _xch_calls(state, xch, ops, x):
    """{kernel: (kernel calls, plain-version calls)} over every call of the
    state and its nested states, as formats/xch.spmv makes them, on the
    same inputs; each call is a function of no argument."""
    calls = {"xch_mul": ([], []), "xch_route4": ([], [])}
    for st in _states(state):
        xt = xch.x_table(st, x)
        prod3 = xch.products(st, xt)
        for i, mul in enumerate((ops.xch_mul, ops.xch_mul_ref)):
            calls["xch_mul"][i].extend(
                lambda a=a, st=st, xt=xt, f=mul: f(*a, xt, st.m1, st.t1)
                for a in zip(st.win1, st.lane1, st.sub1, st.val1))
        for i, route in enumerate((ops.xch_route4, ops.xch_route4_ref)):
            calls["xch_route4"][i].extend(
                lambda a=a, st=st, p=prod3, ng=ng, f=route: f(
                    *a, p, ng, st.gb, st.m2, st.t2, st.p_oh)
                for *a, ng in zip(st.gids2, st.off2, st.cs2, st.win2,
                                  st.lane2, st.sub2, st.hm2, st.sig2,
                                  st.idx2, st.chunk_ngrp))
    return calls


def compare_xch(label, state, xch, ops, x):
    """Phase 2 for one xch state: each kernel vs its plain version on every
    call of the state and of its nested state."""
    calls = _xch_calls(state, xch, ops, x)
    res = {"label": label,
           "plans": [{k: getattr(st, k) for k in (
               "m1", "m2", "t1", "t2", "kblk", "p_oh", "gb", "n_chunks",
               "p1", "n_slots1", "n_slots2")} | {
               "calls": (len(st.win1), len(st.gids2)),
               "peel_offs": len(st.dia_offs)} for st in _states(state)]}
    for name, (ks, rs) in calls.items():
        err = rel = 0.0
        for k, r in zip(ks, rs):
            got, want = k(), r()
            torch.cuda.synchronize()
            e = float((got - want).abs().max())
            err = max(err, e)
            rel = max(rel, e / max(float(want.abs().max()), 1e-30))
            del got, want
        res[name] = {
            "max_abs_err": err, "rel_err": rel,
            # device busy time over all the calls: kernel, plain version
            "ms": _busy_ms(lambda ks=ks: [f() for f in ks],
                           f"{name}_kernel"),
            "plain_ms": _busy_ms(lambda rs=rs: [f() for f in rs]),
            # the calls on the device's clock, host gaps included
            "call_ms": _cuda_ms(lambda ks=ks: [f() for f in ks]),
        }
        if not rel <= TOL:
            raise SystemExit(f"{label} {name}: kernel disagrees with its "
                             f"plain version (max |diff| / max |out| = "
                             f"{rel:.3g} > {TOL})")
    res["spmv_ms"] = _cuda_ms(lambda: xch.spmv(state, x))
    res["spmv_busy_ms"] = _busy_ms(lambda: xch.spmv(state, x))
    print(f"kernel {label}: {json.dumps(res)}")
    return res


def run_path(mats, cfg, run_benchmark, keys, dev):
    """run_benchmark on each stand-in; fails unless Verify passes."""
    for name in mats:
        r = run_benchmark(mats[name], cfg, name=name, device=dev,
                          log=lambda m: None)
        rep = r.report
        extra = " ".join(f"{k}: {rep.get(k)}" for k in keys)
        print(f"run_benchmark {name}: Verify: {rep['Verify']} "
              f"GFLOPS: {r.gflops} Time(s): {r.seconds} {extra} "
              f"Chip: {rep['Chip']} MaxAbsErr: {rep.get('MaxAbsErr')} "
              f"OptimizeTime(s): {rep['OptimizeTime(s)']}")
        if not (r.verify_ok and r.y.shape == (mats[name].n_row,)
                and np.isfinite(r.y).all()):
            raise SystemExit(f"{name}: run_benchmark output is wrong")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from singlespmv_tpu_torch import Config
    from singlespmv_tpu_torch.core import create_random_vector, verify_result
    from singlespmv_tpu_torch.data import synthesize_structured
    from singlespmv_tpu_torch.formats import slab, xch
    from singlespmv_tpu_torch.harness import run_benchmark
    from singlespmv_tpu_torch.ops import _build
    from singlespmv_tpu_torch.ops import slab as ops
    from singlespmv_tpu_torch.ops import xch as xops

    dev = torch.device("cuda")
    cfg = Config(**CFG_KW)
    xcfg = cfg.replace(format="xch")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card.splitlines()[0]}")

    # --- 1. build ---
    b = _build.build()
    for cmd in b.commands:
        print(f"build: {' '.join(cmd)}")
    print(f"build: {b.seconds:.1f} s")
    for line in b.log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"  {line.strip()}")
    _build.load()

    def x_of(coo):
        return torch.from_numpy(create_random_vector(
            coo.n_col, dtype=np.float32)).to(dev)

    # --- 2. kernels vs plain versions at the main paths' shapes ---
    t0 = time.perf_counter()
    mats = {n: synthesize_structured(n) for n in SLAB_MATS + XCH_MATS}
    print(f"synthesized the stand-ins in {time.perf_counter() - t0:.1f} s")
    g7 = mats["g7jac200sc"]
    unit_plan = slab._estimate_cols(
        g7.row.astype(np.int64), g7.col.astype(np.int64), g7.nnz,
        unit_only=True)
    unit_plan.update(hub_cols=None, cols_eff=None, hub_off=0)
    plans = {"raefsky3": None, "torso1": None, "g7jac200sc": unit_plan}
    results = {}
    for name in SLAB_MATS:
        st = slab.convert(mats[name], cfg, plan=plans[name]).to(dev)
        results[name] = compare_kernel(name, st, slab, ops, x_of(mats[name]))
        del st
    xstates = {}
    for name in XCH_MATS:
        t0 = time.perf_counter()
        xstates[name] = xch.convert(mats[name], xcfg).to(dev)
        torch.cuda.synchronize()
        print(f"xch convert {name}: {time.perf_counter() - t0:.1f} s")
        results[name] = compare_xch(name, xstates[name], xch, xops,
                                    x_of(mats[name]))
        if name != "circuit5M":
            del xstates[name]

    # --- 3. the slab main path; count the launches it makes ---
    ops.slab_spmv.launches = 0
    ops.slab_spmv_blk.launches = 0
    run_cfg = Config(**CFG_KW, calibrate_seconds=0.2, n_trials=3)
    run_path({n: mats[n] for n in ("raefsky3", "torso1")}, run_cfg,
             run_benchmark, ("PadFactor", "RoutePlanes"), dev)
    state = slab.convert(g7, cfg, plan=unit_plan).to(dev)
    x_host = create_random_vector(g7.n_col, dtype=np.float32)
    y = slab.spmv(state, torch.from_numpy(x_host).to(dev)).cpu().numpy()
    ok, det = verify_result(g7, x_host, y, dtype=np.float32)
    print(f"unit-mode g7jac200sc: Verify: {'PASS' if ok else 'FAIL'} "
          f"planes {state.planes} m {state.m} T {state.t_step} "
          f"PadFactor {state.n_slots / g7.nnz:.3f} "
          f"max_abs_err {det['max_abs_err']}")
    if not (ok and state.mode == "unit" and np.isfinite(y).all()):
        raise SystemExit("g7jac200sc unit mode: spmv output is wrong")
    launches = {"slab_spmv": ops.slab_spmv.launches,
                "slab_spmv_blk": ops.slab_spmv_blk.launches}
    del state

    # --- 4. the xch main path; count the launches it makes ---
    xops.xch_mul.launches = 0
    xops.xch_route4.launches = 0
    run_path({n: mats[n] for n in ("webbase-1M", "ASIC_680ks")},
             run_cfg.replace(format="xch"), run_benchmark,
             ("PadFactor", "KBlk", "POh", "PeelOffs", "LongRows"), dev)
    big, state = mats["circuit5M"], xstates.pop("circuit5M")
    if not (len(state.win1) > 1 and len(state.gids2) > 1
            and state.long is not None):
        raise SystemExit("circuit5M: expected several kernel calls per pass "
                         "and a nested long-row state")
    x_host = create_random_vector(big.n_col, dtype=np.float32)
    y = xch.spmv(state, torch.from_numpy(x_host).to(dev)).cpu().numpy()
    ok, det = verify_result(big, x_host, y, dtype=np.float32)
    print(f"xch circuit5M: Verify: {'PASS' if ok else 'FAIL'} "
          f"{json.dumps(xch.report_fields(state, xcfg))} "
          f"calls {len(state.win1)} / {len(state.gids2)} "
          f"max_abs_err {det['max_abs_err']}")
    if not (ok and y.shape == (big.n_row,) and np.isfinite(y).all()):
        raise SystemExit("circuit5M: xch spmv output is wrong")
    launches |= {"xch_mul": xops.xch_mul.launches,
                 "xch_route4": xops.xch_route4.launches}
    del state

    # --- 5. every kernel of each path ran in that path ---
    print(f"launches in the main paths: {launches}")
    if min(launches.values()) < 1:
        raise SystemExit("a kernel of the main path was never launched")

    kernels = []
    slab_src = "singlespmv_tpu_torch/csrc/slab.cu"
    for kname, line, names in (("slab_spmv", 263, ("g7jac200sc",)),
                               ("slab_spmv_blk", 310,
                                ("raefsky3", "torso1"))):
        last = results[names[-1]]
        kernels.append({
            "name": kname, "route": "cuda", "source": slab_src,
            "replaces": f"singlespmv_tpu/ops/pallas/slab.py:{line}",
            "launches": launches[kname],
            "max_abs_err": max(results[n]["max_abs_err"] for n in names),
            "ms": last["ms"], "plain_ms": last["plain_ms"]})
    for kname, line in (("xch_mul", 48), ("xch_route4", 151)):
        last = results[XCH_MATS[-1]][kname]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "singlespmv_tpu_torch/csrc/xch.cu",
            "replaces": f"singlespmv_tpu/ops/pallas/xch.py:{line}",
            "launches": launches[kname],
            "max_abs_err": max(results[n][kname]["max_abs_err"]
                               for n in XCH_MATS),
            "ms": last["ms"], "plain_ms": last["plain_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    sys.exit(rc)
