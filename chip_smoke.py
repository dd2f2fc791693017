"""Smoke run of the PyTorch/CUDA port (singlespmv_tpu_torch) on one GPU.

    python3 chip_smoke.py          # from the root of the repository

1. prints the card's name and power limit, builds the CUDA kernels of
   ``singlespmv_tpu_torch/csrc`` with nvcc for sm_90a (one nvcc per source,
   in parallel);
2. holds each kernel against its plain PyTorch version on the card, at the
   stream shapes of the states below (every call of a state, and of its
   nested long-row state), and times kernel, plain version and the whole
   spmv call: in float32, and in float64 the native-fp64 builds of the slab
   unit kernel (torso1 and g7jac200sc, the float64 planner's unit-only
   plans) and of both xch kernels (webbase-1M and ASIC_680ks);
3. drives the slab main path: ``run_benchmark`` with format="slab" in float32
   on the full-size raefsky3 and torso1 stand-ins (both plan blk mode), and
   the full-size g7jac200sc stand-in's spmv with the planner's unit-only plan
   against the float64 COO oracle;
4. drives the xch main path: ``run_benchmark`` with format="xch" in float32
   on the full-size webbase-1M and ASIC_680ks stand-ins, and the spmv of the
   full-size circuit5M stand-in (several kernel calls per pass, a nested
   long-row state) against the float64 COO oracle;
5. drives the hyb main path: ``run_benchmark`` with format="hyb" in float32
   on the full-size Chebyshev4 and PR02R stand-ins (a band peel plus a slab
   residual); then, on those in float32 and on Chebyshev4 in float64, times
   a hyb spmv, its dia part and its residual, and holds the residual's
   kernels against their plain versions at the residual's shapes;
6. drives the float64 paths: ``run_benchmark`` in float64 with
   format="slab" on torso1, "xch" on webbase-1M and "hyb" on Chebyshev4;
   each must pass Verify and agree with the float64 COO oracle to
   1e-12·max|y|, which a float32 computation would not;
7. checks that each path launched each of its kernels: the launch counts are
   set to 0 just before a path and read just after it.

Each phase prints its seconds.

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
F64_TOL = 1e-12     # the same at float64, and an f64 spmv vs the oracle
REPS = 20
SLAB_MATS = ("raefsky3", "torso1", "g7jac200sc")
XCH_MATS = ("webbase-1M", "ASIC_680ks", "circuit5M")
HYB_MATS = ("Chebyshev4", "PR02R")
SLAB64_MATS = ("g7jac200sc", "torso1")
XCH64_MATS = ("ASIC_680ks", "webbase-1M")


class Phase:
    """Prints the seconds a phase took."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        print(f"phase {self.name}: {time.perf_counter() - self.t0:.1f} s",
              flush=True)


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
    copies whose name contains ``match`` (torch.profiler, CUDA activity).
    Where three traces in a row see none, the time per call on the device's
    clock (``_cuda_ms``), which is an upper bound."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(3):   # a trace now and then comes back empty
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if match in e.key)
        if us > 0:
            return us / reps / 1e3
        print(f"torch.profiler saw no device time for {match!r} "
              f"(trace {attempt + 1} of 3)", flush=True)
    print(f"busy time for {match!r} taken on the device's clock instead "
          "(host gaps included)", flush=True)
    return _cuda_ms(fn, reps)


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


def compare_kernel(label, state, slab, ops, x, tol=TOL):
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
        "label": label, "dtype": str(x.dtype), "mode": state.mode,
        "kernel": ("slab_spmv_blk" if state.mode == "blk" else "slab_spmv")
        + ("_f64" if x.dtype == torch.float64 else ""),
        "planes": state.planes,
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
    print(f"kernel {label}: {res}", flush=True)
    if not rel <= tol:
        raise SystemExit(f"{label}: kernel disagrees with its plain version "
                         f"(max |diff| / max |out| = {rel:.3g} > {tol})")
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


def compare_xch(label, state, xch, ops, x, tol=TOL):
    """Phase 2 for one xch state: each kernel vs its plain version on every
    call of the state and of its nested state."""
    calls = _xch_calls(state, xch, ops, x)
    res = {"label": label, "dtype": str(x.dtype),
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
        if not rel <= tol:
            raise SystemExit(f"{label} {name}: kernel disagrees with its "
                             f"plain version (max |diff| / max |out| = "
                             f"{rel:.3g} > {tol})")
    res["spmv_ms"] = _cuda_ms(lambda: xch.spmv(state, x))
    res["spmv_busy_ms"] = _busy_ms(lambda: xch.spmv(state, x))
    print(f"kernel {label}: {json.dumps(res)}", flush=True)
    return res


def by_kernel(compared):
    """{kernel: [its comparison results]} over compare_kernel and compare_xch
    results."""
    out = {}
    for res in compared:
        if "kernel" in res:
            out.setdefault(res["kernel"], []).append(res)
            continue
        sfx = "_f64" if res["dtype"] == str(torch.float64) else ""
        for k in ("xch_mul", "xch_route4"):
            out.setdefault(k + sfx, []).append(res[k] | {"label": res["label"]})
    return out


def compare_rest(label, state, slab, xch, ops, xops, x, tol):
    """Phase 2 for a hyb state's residual, on the engine it rides."""
    if state.rest_fmt == "slab":
        return compare_kernel(label, state.rest_state, slab, ops, x, tol)
    return compare_xch(label, state.rest_state, xch, xops, x, tol)


def run_path(mats, cfg, run_benchmark, keys, dev, oracle=None,
             rest=("SLAB", "XCH")):
    """run_benchmark on each stand-in; fails unless Verify passes, unless a
    hyb residual rides an engine in ``rest`` and, with ``oracle`` (the COO
    float64 product), unless y agrees with the oracle to
    F64_TOL·max|y_oracle|."""
    for name in mats:
        r = run_benchmark(mats[name], cfg, name=name, device=dev,
                          log=lambda m: None)
        rep = r.report
        extra = " ".join(f"{k}: {rep.get(k)}" for k in keys)
        rel = None
        if oracle is not None:
            x = oracle["x"](mats[name])
            want = oracle["spmv"](mats[name], x)
            rel = float(np.abs(r.y - want).max()
                        / max(np.abs(want).max(), 1e-300))
        print(f"run_benchmark {name}: Verify: {rep['Verify']} "
              f"Dtype: {rep['Dtype']} GFLOPS: {r.gflops} "
              f"Time(s): {r.seconds} {extra} "
              f"Chip: {rep['Chip']} MaxAbsErr: {rep.get('MaxAbsErr')} "
              f"oracle_rel_err: {rel} "
              f"OptimizeTime(s): {rep['OptimizeTime(s)']}", flush=True)
        if not (r.verify_ok and r.y.shape == (mats[name].n_row,)
                and np.isfinite(r.y).all()
                and rep["Dtype"] == cfg.dtype
                and r.y.dtype == np.dtype(cfg.dtype)):
            raise SystemExit(f"{name}: run_benchmark output is wrong")
        if rel is not None and not rel <= F64_TOL:
            raise SystemExit(f"{name}: float64 run off the oracle by "
                             f"{rel:.3g} > {F64_TOL} of max|y|")
        if "RestFormat" in keys and rep["RestFormat"] not in rest:
            raise SystemExit(f"{name}: hyb residual {rep['RestFormat']}")


def _counts(*wrappers):
    """The launch counts of the wrappers, f32 and f64 builds."""
    return {w.__name__ + sfx: getattr(w, attr)
            for w in wrappers
            for sfx, attr in (("", "launches"), ("_f64", "launches_f64"))
            if hasattr(w, attr)}


def _zero(*wrappers):
    for w in wrappers:
        w.launches = 0
        if hasattr(w, "launches_f64"):
            w.launches_f64 = 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from singlespmv_tpu_torch import Config
    from singlespmv_tpu_torch.core import (create_random_vector,
                                           reference_spmv, verify_result)
    from singlespmv_tpu_torch.data import synthesize_structured
    from singlespmv_tpu_torch.formats import dia, hyb, slab, xch
    from singlespmv_tpu_torch.harness import run_benchmark
    from singlespmv_tpu_torch.ops import _build
    from singlespmv_tpu_torch.ops import slab as ops
    from singlespmv_tpu_torch.ops import xch as xops

    dev = torch.device("cuda")
    cfg = Config(**CFG_KW)
    xcfg = cfg.replace(format="xch")
    cfg64 = cfg.replace(dtype="float64")
    xcfg64 = xcfg.replace(dtype="float64")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card.splitlines()[0]}")

    # --- 1. build ---
    with Phase("build"):
        b = _build.build()
        for cmd in b.commands:
            print(f"build: {' '.join(cmd)}")
        print(f"build: {b.seconds:.1f} s")
        for line in b.log.splitlines():
            if "registers" in line or "Compiling entry" in line:
                print(f"  {line.strip()}")
        _build.load()

    def x_of(coo, dtype=np.float32):
        return torch.from_numpy(create_random_vector(
            coo.n_col, dtype=dtype)).to(dev)

    # --- 2. kernels vs plain versions at the main paths' shapes ---
    with Phase("synthesize"):
        mats = {n: synthesize_structured(n)
                for n in SLAB_MATS + XCH_MATS + HYB_MATS}
    g7 = mats["g7jac200sc"]
    unit_plan = slab._estimate_cols(
        g7.row.astype(np.int64), g7.col.astype(np.int64), g7.nnz,
        unit_only=True)
    unit_plan.update(hub_cols=None, cols_eff=None, hub_off=0)
    plans = {"raefsky3": None, "torso1": None, "g7jac200sc": unit_plan}
    compared = []
    with Phase("slab kernels float32"):
        for name in SLAB_MATS:
            st = slab.convert(mats[name], cfg, plan=plans[name]).to(dev)
            compared.append(compare_kernel(name, st, slab, ops,
                                           x_of(mats[name])))
            del st
    xstates = {}
    with Phase("xch kernels float32"):
        for name in XCH_MATS:
            t0 = time.perf_counter()
            xstates[name] = xch.convert(mats[name], xcfg).to(dev)
            torch.cuda.synchronize()
            print(f"xch convert {name}: {time.perf_counter() - t0:.1f} s")
            compared.append(compare_xch(name, xstates[name], xch, xops,
                                        x_of(mats[name])))
            if name != "circuit5M":
                del xstates[name]
    with Phase("slab kernels float64"):
        for name in SLAB64_MATS:
            t0 = time.perf_counter()
            st = slab.convert(mats[name], cfg64).to(dev)
            print(f"slab float64 convert {name}: "
                  f"{time.perf_counter() - t0:.1f} s")
            if not (st.mode == "unit" and st.val[0].dtype == torch.float64):
                raise SystemExit(f"{name}: float64 slab plan is not unit "
                                 "mode over float64 values")
            compared.append(compare_kernel(
                name, st, slab, ops, x_of(mats[name], np.float64), F64_TOL))
            del st
    with Phase("xch kernels float64"):
        for name in XCH64_MATS:
            st = xch.convert(mats[name], xcfg64).to(dev)
            if st.val1[0].dtype != torch.float64:
                raise SystemExit(f"{name}: float64 xch state holds "
                                 f"{st.val1[0].dtype}")
            compared.append(compare_xch(
                name, st, xch, xops, x_of(mats[name], np.float64), F64_TOL))
            del st

    slab_k, xch_k = (ops.slab_spmv, ops.slab_spmv_blk), (xops.xch_mul,
                                                         xops.xch_route4)
    launches = {}

    def count_path(path, wrappers, need):
        """Adds the path's launch counts; fails if a kernel in ``need`` was
        not launched."""
        got = _counts(*wrappers)
        print(f"launches in the {path} path: {got}", flush=True)
        for k in need:
            if got[k] < 1:
                raise SystemExit(f"{path}: kernel {k} was never launched")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        return got

    # --- 3. the slab main path; count the launches it makes ---
    run_cfg = Config(**CFG_KW, calibrate_seconds=0.2, n_trials=3)
    with Phase("slab path float32"):
        _zero(*slab_k)
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
        count_path("slab float32", slab_k, ("slab_spmv", "slab_spmv_blk"))
        del state

    # --- 4. the xch main path; count the launches it makes ---
    with Phase("xch path float32"):
        _zero(*xch_k)
        run_path({n: mats[n] for n in ("webbase-1M", "ASIC_680ks")},
                 run_cfg.replace(format="xch"), run_benchmark,
                 ("PadFactor", "KBlk", "POh", "PeelOffs", "LongRows"), dev)
        big, state = mats["circuit5M"], xstates.pop("circuit5M")
        if not (len(state.win1) > 1 and len(state.gids2) > 1
                and state.long is not None):
            raise SystemExit("circuit5M: expected several kernel calls per "
                             "pass and a nested long-row state")
        x_host = create_random_vector(big.n_col, dtype=np.float32)
        y = xch.spmv(state, torch.from_numpy(x_host).to(dev)).cpu().numpy()
        ok, det = verify_result(big, x_host, y, dtype=np.float32)
        print(f"xch circuit5M: Verify: {'PASS' if ok else 'FAIL'} "
              f"{json.dumps(xch.report_fields(state, xcfg))} "
              f"calls {len(state.win1)} / {len(state.gids2)} "
              f"max_abs_err {det['max_abs_err']}")
        if not (ok and y.shape == (big.n_row,) and np.isfinite(y).all()):
            raise SystemExit("circuit5M: xch spmv output is wrong")
        count_path("xch float32", xch_k, ("xch_mul", "xch_route4"))
        del state

    # --- 5. the hyb main path: band peel plus slab residual ---
    hyb_keys = ("PeelDiags", "PeelNnz", "RestFormat", "RestNnz",
                "RestPadFactor")
    with Phase("hyb path float32"):
        _zero(*slab_k, *xch_k)
        run_path({n: mats[n] for n in HYB_MATS},
                 run_cfg.replace(format="hyb"), run_benchmark, hyb_keys, dev,
                 rest=("SLAB",))
        got = count_path("hyb float32", slab_k + xch_k, ())
        if not got["slab_spmv"] + got["slab_spmv_blk"]:
            raise SystemExit("hyb float32: no residual kernel launched")

    # --- 5b. where a hyb spmv's time goes, and the residual's kernels
    #     against their plain versions at the residual's shapes ---
    for name, dtype in [(n, "float32") for n in HYB_MATS] + [
            ("Chebyshev4", "float64")]:
        with Phase(f"hyb kernels {name} {dtype}"):
            st = hyb.convert(mats[name], cfg.replace(
                format="hyb", dtype=dtype)).to(dev)
            x = x_of(mats[name], np.dtype(dtype))
            rest = {"slab": slab, "xch": xch}[st.rest_fmt]
            print(f"hyb {name} {dtype}: " + json.dumps({
                "rest_fmt": st.rest_fmt,
                "spmv_ms": _cuda_ms(lambda: hyb.spmv(st, x)),
                "spmv_busy_ms": _busy_ms(lambda: hyb.spmv(st, x)),
                "dia_ms": _cuda_ms(lambda: dia.spmv(st.dia_state, x)),
                "dia_busy_ms": _busy_ms(lambda: dia.spmv(st.dia_state, x)),
                "rest_busy_ms": _busy_ms(
                    lambda: rest.spmv(st.rest_state, x))}), flush=True)
            compared.append(compare_rest(
                f"{name} hyb residual", st, slab, xch, ops, xops, x,
                F64_TOL if dtype == "float64" else TOL))
            del st

    # --- 6. the float64 paths, held to the oracle at F64_TOL ---
    oracle = {"x": lambda coo: create_random_vector(coo.n_col),
              "spmv": reference_spmv}
    run64 = run_cfg.replace(dtype="float64")
    for fmt, name, keys, wrappers, need in (
            ("slab", "torso1", ("PadFactor", "RoutePlanes"), slab_k,
             ("slab_spmv_f64",)),
            ("xch", "webbase-1M", ("KBlk", "POh", "PeelOffs", "LongRows"),
             xch_k, ("xch_mul_f64", "xch_route4_f64")),
            ("hyb", "Chebyshev4", hyb_keys, slab_k + xch_k, ())):
        with Phase(f"{fmt} path float64"):
            _zero(*slab_k, *xch_k)
            run_path({name: mats[name]}, run64.replace(format=fmt),
                     run_benchmark, keys, dev, oracle=oracle)
            got = count_path(f"{fmt} float64", wrappers, need)
            if any(got.get(k) for k in ("slab_spmv", "slab_spmv_blk",
                                        "xch_mul", "xch_route4")):
                raise SystemExit(f"{fmt} float64: a float32 kernel ran")
            if fmt == "hyb" and not sum(got.values()):
                raise SystemExit("hyb float64: no residual kernel launched")

    # --- 7. every kernel of each path ran in that path ---
    print(f"launches in the main paths: {launches}")

    kernels = []
    slab_src = "singlespmv_tpu_torch/csrc/slab.cu"
    xch_src = "singlespmv_tpu_torch/csrc/xch.cu"
    checks = by_kernel(compared)
    print("kernel checks: " + json.dumps(
        {k: [r["label"] for r in rs] for k, rs in checks.items()}))
    # max_abs_err over every state checked; ms and plain_ms of one of them
    for kname, src, line, timed in (
            ("slab_spmv", slab_src, "slab.py:263", "g7jac200sc"),
            ("slab_spmv_blk", slab_src, "slab.py:310", "torso1"),
            ("xch_mul", xch_src, "xch.py:48", "circuit5M"),
            ("xch_route4", xch_src, "xch.py:151", "circuit5M"),
            ("slab_spmv_f64", slab_src, "slab.py:463", "torso1"),
            ("xch_mul_f64", xch_src, "xch.py:495", "webbase-1M"),
            ("xch_route4_f64", xch_src, "xch.py:594", "webbase-1M")):
        rs = checks.get(kname, [])
        t = [r for r in rs if r["label"] == timed]
        if not t:
            raise SystemExit(f"{kname}: not checked on {timed}")
        kernels.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": f"singlespmv_tpu/ops/pallas/{line}",
            "launches": launches[kname],
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            "ms": t[0]["ms"], "plain_ms": t[0]["plain_ms"]})
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
