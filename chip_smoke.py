"""Smoke run of the PyTorch/CUDA port (singlespmv_tpu_torch) on one GPU.

    python3 chip_smoke.py          # from the root of the repository

Its phases, in the order they run:

1. prints the card's name and power limit, builds the CUDA kernels of
   ``singlespmv_tpu_torch/csrc`` with nvcc for sm_90a (one nvcc per source,
   in parallel), and synthesizes the stand-ins in worker processes (one
   thread each, one core left to the timing process);
2. holds each kernel against its plain PyTorch version on the card, at the
   stream shapes of the states below (every call of a state, and of its
   nested long-row state), and times kernel, plain version and the whole
   spmv call: the slab spmv route ``slab_spmv_rows`` (its direct kernel, or
   its merge kernel where ``route_rows`` set a merge span) on every chunk of
   raefsky3 and torso1 (blk) and g7jac200sc (unit) in float32 and of torso1
   and g7jac200sc (the float64 planner's unit-only plans) in float64, with
   the bound of the idx-plane layout it replaced beside its own and the
   time ``route_rows`` took at convert; the xch spmv's kernel
   ``xch_fused_rows`` (both passes in one launch a pass-2 call, the
   products in registers) in float32 and, in float64, its native-fp64
   build (webbase-1M and ASIC_680ks), on every pass-2 call of the state and
   its nested states, with torch's ``A_csr @ x`` beside it, the busy time
   and bounds of the pair it replaced beside its own, and the fused spmv
   against the pair's within each row's reorder bound; that pair, now on
   the profiling phases and the calibration only: ``xch_mul`` and the
   route ``xch_route4_rows``, the latter with the bound of the idx-plane
   layout it replaced beside its own; the bucket
   kernels on the full-size bkt_g states (1024-row buckets) of g7jac200sc,
   lhr34, twotone, raefsky3 and thermomech_dK and the bkt state (128-row
   buckets) of raefsky3: the spmv's fused stage A + B
   ``bucket_fused_rows`` (the products in registers) with torch's
   ``A_csr @ x`` beside it and the busy time of the unfused pair it
   replaced beside its own; that pair, the first port, on no path: stage A
   ``block_gather_mul`` and stage B ``bucket_rows`` on the run-end stream
   with the bound of the idx-plane layout beside its own; and the first
   port's stage B (``bucket_reduce``, ``bucket_reduce_grouped``,
   ``lane_unpermute``, on no path) with ``torch.gather``'s time beside
   ``lane_unpermute``'s; and the scan kernels: ``segmented_scan_tiles`` on
   torso1's ss stream and webbase-1M's csr5 normal track,
   ``block_gather_scan`` on the css streams of thermomech_dK and raefsky3,
   and the fp64 builds of both on g7jac200sc's ss and css streams;
2b. xch's v3 σ-plane path (ROADMAP B.15; ``run_xch_v3``): webbase-1M and
   ASIC_680ks converted under ``plan=estimate_v3(coo, cfg) | {"route_v":
   3}`` (host seconds printed), at float32 and rounded to bfloat16; every
   call's ``xch_mul`` and ``xch_route`` (float and bfloat16 builds) against
   its plain version, each timed beside its bound; the v3 spmv through the
   oracle and against the v4 fused spmv of phase 2's state, each row within
   the sum of both layouts' proven bounds (``tests/torch_bounds.py:
   accuracy_bound``); its busy time, eager wall and chained Time(s) beside
   torch's ``A_csr @ x`` and the v4 spmv's busy time; fails unless the path
   launched ``xch_mul`` and ``xch_route`` (their ``_bf16`` builds at
   bfloat16);
3. SpMM, Y = A @ X: holds the panel kernels against their plain versions
   on interleaved panels (``slab_spmm`` on g7jac200sc's unit-only plan at
   B = 8, 16 and 32, ``xch_mul_panel`` and ``xch_route4_panel`` on every
   call of webbase-1M's and ASIC_680ks's states, nested ones included, at
   B = 8 and 16), with torch's CSR product ``A_csr @ X`` beside each, then
   drives ``spmm_fn`` at B = 1 (the spmv), 8 and 32 on webbase-1M and
   ASIC_680ks (xch), unbalance-16384 (bsr), g7jac200sc (slab unit) and torso1
   (slab blk: the column loop), printing the table of
   ``results/r5_tpu_spmm.txt`` with torch's own CSR product beside each row
   and every column of Y held to the oracle; auto with ``spmm_b`` = 8 on
   webbase-1M and g7jac200sc; and float64 SpMM with xch on ASIC_680ks at
   B = 8 (the column loop over the fp64 spmv) against the oracle at
   1e-12·max|Y|;
3b. bfloat16 SpMM (ROADMAP A.10b), on phase 2's and 3's states rounded
   to bfloat16 (``as_bfloat16``; hyb on Chebyshev4 and csr converted at
   bfloat16): ``spmm_fn`` at B 8 on g7jac200sc (slab unit), webbase-1M
   (xch, a peel and nested long rows), Chebyshev4 (hyb),
   unbalance-16384 (bsr) and g7jac200sc (csr) and auto with ``spmm_b`` 8
   on webbase-1M and g7jac200sc (estimates, trials, pick), every column
   through ``verify_result(dtype=bfloat16)``; fails unless the three
   panels' ``*_bf16`` builds launched there and no other build did; then
   the panels against their plain versions (``slab_spmm`` on g7jac200sc at
   B 8, 16, 32, the xch pair on webbase-1M and ASIC_680ks at B 8, 16): per
   call at ``TOL``, every column of the kernels' Y and of the plain Y
   within ``tests/torch_bounds.py:accuracy_bound``'s rule, two calls
   within each row's ``reorder_bound``; one ``spmm_bf16_row`` a kernel
   (busy µs against the bound, the chained spmm at B 8 beside phase 3's
   float32 one, torch's bfloat16 CSR ``A @ X``);
4. drives the slab main path: ``run_benchmark`` with format="slab" in float32
   on the full-size raefsky3 and torso1 stand-ins (both plan blk mode), and
   the full-size g7jac200sc stand-in's spmv with the planner's unit-only plan
   against the float64 COO oracle;
5. drives the xch main path: ``run_benchmark`` with format="xch" in float32
   on the full-size webbase-1M and ASIC_680ks stand-ins, with its phases
   profiled (the phases run the pair, Mul then Sum, whose launches there
   count in no path), and fails unless ``xch_fused_rows`` ran;
6. drives the hyb main path: ``run_benchmark`` with format="hyb" in float32
   on the full-size Chebyshev4 and PR02R stand-ins (a band peel plus a slab
   residual) and webbase-1M (whose hyper-sparse residual rides xch); then,
   on the first two in float32 and on Chebyshev4 in float64, times
   a hyb spmv, its dia part and its residual, and holds the residual's
   kernels (the slab route on all three) against their plain versions at
   the residual's shapes;
7. drives the bkt path: ``run_benchmark`` with format="bkt" on raefsky3
   (128-row buckets) and g7jac200sc (1024-row buckets), and fails unless
   ``bucket_fused_rows`` ran, or if the unfused pair or the first port's
   stage B did;
8. drives the scan formats: ``run_benchmark`` in float32 with format="css"
   on thermomech_dK and webbase-1M, "ss" on torso1 and "csr5" on torso1 and
   webbase-1M (css and ss with their phases profiled, ss its scan steps
   too);
9. drives the auto path: ``run_benchmark`` with format="auto" in float32 on
   g7jac200sc, lhr34, twotone, mac_econ_fwd500, raefsky3 and thermomech_dK
   (bkt_g among the measured candidates), webbase-1M (the hyper-sparse
   class) and Chebyshev4 (hyb), its trials at ``AUTO_TRIAL_WINDOW_S`` (0.1 s
   a timed loop, where the headline's are 0.35), printing every engine's
   estimate (css's and
   ss's with their ranks), the measured trials, the chosen engine and every
   candidate auto skipped; fails on any skip that is not a guard error;
10. drives the float64 paths: ``run_benchmark`` in float64 with
   format="slab" on torso1, "xch" on webbase-1M, "hyb" on Chebyshev4, and
   "auto", "css" and "ss" on g7jac200sc; each must pass Verify and agree with
   the float64 COO oracle to 1e-12·max|y|, which a float32 computation would
   not;
11. the calibration path: holds ``xch_route`` against its plain version on
   calibrate's own inputs (H 16,384 at 8 and 16 planes, and a case whose
   sg0/sg1 prune by groups of pg 4), each probe kernel on the inputs of
   every probe that times it (``microbench.KERNEL_CASES``: each kernel
   configuration of ``PROBES``, ``probe_pal2step``'s and the bfloat16 lane
   gather among them) with a PyTorch call beside the transpose, the bin
   sums and the accumulate (the gathers held exactly), the transpose at
   ``ODD_TRANSPOSES`` (shapes the TPU could not take, inputs one float past
   16 bytes), the bin sums with bins outside [0, 128), the accumulate at
   ``microbench.dynslice_odd_offs`` (unsorted, equal, negative and past
   y's end, T 1 and 3), the sublane gather at ``ODD_SUBLANE`` (its table
   as slices of lanes, and past shared memory; the probes' 64 and 8 rows
   stage it whole), and ``probe_slab``'s kernel at every
   (T, S8, stage) of its nine rows and at stage "route", each kernel timed
   at its first shape and ``xch_route`` at both of calibrate's; then
   drives ``calibrate.measure`` (printing the six fitted keys, its
   ``route_slot_s`` beside the first port's ``ROUTE_SLOT_S_FIRST_PORT``, each flagged as left out by ``calibrate.screen``, taken
   or left to the default by ``chipconst.load``, what is kept saved only
   to a temporary file), ``microbench.run`` over the 35 ``PROBES`` and
   ``probe_pal2step`` (printing the TSV and ``PROBE_PAIRS``: each
   hand-written probe's G elem/s beside the probe of the same motion that
   the reference left to XLA), and ``probe_slab.main``'s nine rows, each
   probe's loop at ``CAL_TARGET_S`` on its captured chain (CUDA-graph
   replays), with a ``probe_chain`` line a probe: the captured µs an
   iteration beside its kernel's busy µs and the old eager loop's µs (one
   run, for the record, counted in no path);
12. driver timing: every ``run_benchmark`` times a spmv as the
   reference's driver does, by the median of marginals over chained runs
   (CUDA-graph replays of ``harness/driver.py:CHAIN`` calls).  The runs of
   ``DRIVER_RUNS`` in the paths above (raefsky3 and torso1 slab, webbase-1M
   and ASIC_680ks xch, Chebyshev4 hyb, g7jac200sc auto, float32) go through
   a state cache, and each prints its chained Time(s) beside the eager wall
   of 20 calls and the busy time of one call of the cached state.  This
   phase fails where a Time(s) is under 0.8 of its busy time (read from a
   complete trace) and where a graph replay's y is off the eager y past a
   row's reorder bound (``core/oracle.py:reorder_bound``: (k_i − 1)·eps·
   Σ_j|a_ij x_j| for the k_i run totals the card adds into row i in a free
   order); prints the A/B of the chain's length (1, 8 and
   64 calls) on raefsky3 and torso1; checks the phases of the profiled runs
   above (xch on ASIC_680ks, ss on torso1 with its step times, css on
   thermomech_dK) and of a csr run on raefsky3, failing where a phase is
   missing or, on a state without a peel, the phases sum to under 0.8 of
   Time(s); runs torso1 (slab) and g7jac200sc (auto) again from the cache
   (their OptimizeTime then the load; the file untouched, the same engine,
   both y passing Verify and within each row's reorder bound); and writes one ``trace_dir`` trace, which
   must hold device events;
13. the campaign layer: ellg's passes kernel ``ellg_rows`` (every pass
   of a state in one launch) against its plain version on the ellg states
   of raefsky3 and g7jac200sc (between them one and several members a
   row; a pass of one member carries no src), timed beside its bound and
   beside the first port of the passes (stage A at gran 128, then the row
   sums and adds in torch); that first port's ``block_gather_mul`` at gran
   128 against its plain version on every pass, each pass timed beside its
   bound (uncounted: it is on no path); then drives
   ``run_benchmark`` with format="ellg" on both, and "coo", "ell", "jds",
   "bcoo" and "hostlib" on raefsky3 (hostlib on the host, as its
   ``PREFERRED_DEVICE`` says), each to a Verify PASS; then the headline
   module ``singlespmv_tpu_torch.bench`` with ``--names`` g7jac200sc lhr34
   (its JSON line must carry the root bench.py's keys), a two-row sweep
   (ell, ellg) on lhr34 and ``format-logs`` over the sweep's logs;
14. the solver layer (``ops/{solvers,ilu,sptrsv,spgemm}.py``) at the size
   of a 3D solve, 100³ unknowns: (a) CG in float64 on the 7-point Poisson
   matrix with format="slab", without a preconditioner and with IC(0)
   (which must take fewer iterations), (b) BiCGStab with ILU(0) in float32
   on the 7-point upwind convection–diffusion matrix (cell Péclet 10
   along x), slab, (c) BiCGStab in float32 under the solvers' default
   cfg (auto) on the ASIC_680ks stand-in made strictly diagonally
   dominant, printing auto's choice; each must converge with a true
   residual ‖b − A x‖ (float64 COO oracle) within 1.001·tol·‖b‖ (float64)
   or 10·tol·‖b‖ (float32), and prints its iterations, its wall, capture
   and replay seconds, the CUDA graph's nodes beside the estimate that
   sized its chunk, one spmv's chained Time(s) on its state, one
   preconditioner apply on a chained runner, and the same solve run
   eagerly (the chunk function without capture); (d) SpGEMM g7jac200sc ·
   g7jac200sc in float64 against scipy's ``A @ A`` (the same pattern,
   values within 1e-12 of max|C|); (e) SpTRSV on (a)'s IC(0) factor L and
   Lᵀ against scipy's ``spsolve_triangular`` (1e-10 of max|y|), with a
   solve's chained time and its time a level;
14b. bfloat16 (ROADMAP A.10): (a) the bfloat16 build of each kernel
   against its plain version, per call as the float32 ones are, on
   g7jac200sc (slab unit) and torso1 (slab blk), webbase-1M (xch and the
   csr5 normal track), thermomech_dK (bkt_g and css) and raefsky3 (bkt):
   the float32 checks' states with their values rounded to bfloat16
   (``as_bfloat16``: the layout does not depend on the value type), and
   ``ellg_rows`` on raefsky3's ellg state converted at bfloat16, each
   timed beside its bound at 2-byte values and torch's bfloat16 CSR
   product, the whole spmv's times on webbase-1M's xch; then two calls of
   the whole bfloat16 spmv on the card, every row within its
   ``reorder_bound`` (float32 accumulator, bfloat16 output), the first
   through the bfloat16 oracle; (b) ``run_benchmark`` at bfloat16 through
   auto (trials at ``BF16_TRIAL_WINDOW_S``) on the six ``DRIVER_RUNS``
   stand-ins and through slab, xch, hyb, bkt, ellg, ss, csr5, css and csr
   on raefsky3, each to a Verify PASS, printing a ``bf16_row`` with the
   chained Time(s) and GFLOPS beside the float32 run of the same stand-in
   and format where this smoke made one; fails where a bfloat16 kernel
   never launched in (b) or a float32 or float64 kernel did;
14c. the parallel layer (``singlespmv_tpu_torch/parallel/``, ROADMAP
   A.14; ``run_parallel``): on a local mesh, every shard on the card,
   DistXch at R 4 on webbase-1M (all-gather) and R 8 on a 1,048,576-row
   band (a ppermute ring), the largest shard's ``xch_fused_rows`` calls
   (and the pair's, and on webbase-1M its two panel kernels at B 8)
   against their plain versions, each y through the oracle, each step's
   chained µs beside the single-device xch Time(s), ``DistXch.spmm`` at
   B 8; DistSpMV (2 × 2, float32 and float64, and ``gather_x`` at R 4) and
   HaloSpMV (rounds on the band, boundary on torso1),
   ``segmented_scan_tiles`` against its plain version on DistSpMV's
   stacked stream and HaloSpMV's local and halo streams, ``exchange_elems``
   and ``n_collectives``; the weak and strong scaling tables, each point a
   CUDA graph of 8 steps (what sharding costs on one card); the dryrun;
   and DistXch and DistSpMV on NCCL at world size 1 in a process started
   with the phase, whose host work overlaps the phase's;
15. the xch path on circuit5M (several kernel calls per pass, a nested
   long-row state): the time ``route_rows`` takes, kernels against their
   plain versions on every call, then its spmv against the float64 COO
   oracle;
16. checks that each path launched each of its kernels: the launch counts
   are set to 0 just before a path and read just after it; the slab, hyb,
   auto, float64 and solver paths the slab route ``slab_spmv_rows``, the
   xch, hyb, float64 and parallel paths ``xch_fused_rows`` and the
   parallel path ``segmented_scan_tiles``, the bkt and auto paths
   ``bucket_fused_rows``, the ellg path ``ellg_rows``, the xch v3 path
   ``xch_mul`` and ``xch_route``; and
   that no path launched the kernels that left the spmv path:
   ``xch_route4``, ``slab_spmv`` / ``slab_spmv_blk``, the bucket pair
   ``block_gather_mul`` / ``bucket_rows``, the first port's stage B and
   the xch pair ``xch_mul`` / ``xch_route4_rows`` (the calibration and
   xch v3 paths excepted, which run ``xch_mul``; their checks above, and
   the xch path's profiled phases, put the counts back).

Each phase prints its seconds.

A busy time is read from a torch.profiler trace only when the trace is
complete: each of its ``REPS`` calls, delimited by spin kernels, holds the
same number of matched device events, for the port's own kernels as many
as their wrappers' launch counters rose by (``harness/driver.py:
busy_seconds``).  After three incomplete traces the time is taken on the
device's clock instead, an upper bound, and the result that holds it is
marked ``"busy_from": "events"`` (``events_ms`` names its keys).

Prints a JSON line of per-kernel results (kernel, plain-version and, where
one PyTorch call computes the same function, that call's device time: for
the product kernels torch's CSR product ``A_csr @ x`` (cuSPARSE's kernels)
on the same matrix, dtype and B, the whole product where an xch kernel is
one of two passes; the launches on the main paths; the bound: the larger
of the bytes the call must move at 3.35 TB/s and its operations at the
card's peak; for ``xch_fused_rows`` the pair's busy time and summed
bounds (``pair_ms``, ``pair_bound_ms``); for ``xch_route4_rows`` and the
slab route's three rows
(``slab_spmv``, ``slab_spmv_blk`` and ``slab_spmv_f64``: one kernel, whose
f32 launches the first two share) also ``bound_ms_idx_layout``, the bound
of the same work on the idx-plane layout it replaced), and as its last line
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result, when
no CUDA device is present or any phase fails.
"""
import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import weakref

import numpy as np
import torch

CFG_KW = dict(format="slab", dtype="float32")
TOL = 1e-5          # kernel vs plain version, relative to max|out|: the
#                     prefix and the atomics sum in other orders
F64_TOL = 1e-12     # the same at float64, and an f64 spmv vs the oracle
REPS = 20
PLAIN_REPS = 3      # the panels' plain versions: B spmv plain versions a call
SLAB_MATS = ("raefsky3", "torso1", "g7jac200sc")
XCH_MATS = ("webbase-1M", "ASIC_680ks", "circuit5M")
HYB_MATS = ("Chebyshev4", "PR02R")
SLAB64_MATS = ("g7jac200sc", "torso1")
XCH64_MATS = ("ASIC_680ks", "webbase-1M")
BKT_MATS = (("g7jac200sc", 1024), ("lhr34", 1024), ("twotone", 1024),
            ("raefsky3", 1024), ("thermomech_dK", 1024), ("raefsky3", 128))
AUTO_MATS = ("g7jac200sc", "lhr34", "twotone", "mac_econ_fwd500",
             "raefsky3", "thermomech_dK", "webbase-1M", "Chebyshev4")
GUARD_ERRORS = ("ValueError", "TypeError", "MemoryError", "OutOfMemoryError")
SPMM_B = (8, 32)         # the SpMM path's panels (B = 1: the spmv)
SLAB_PANEL_B = (8, 16, 32)   # slab_spmm's checks (its gate: B <= 32)
XCH_PANEL_B = (8, 16)    # the xch panel kernels' checks (their gate: B <= 16)
SPMM_MATS = (("webbase-1M", "xch"), ("ASIC_680ks", "xch"),
             ("unbalance-16384", "bsr"), ("g7jac200sc", "slab"),
             ("torso1", "slab"))
SPMM_WINDOW_S = 0.05     # each timed run of the SpMM table lasts this
PANEL_KERNELS = ("slab_spmm", "xch_mul_panel", "xch_route4_panel")
HBM_BPS = 3.35e12   # H100 SXM device memory, NVIDIA's data sheet
PEAK_OPS = {torch.float32: 67e12,   # float32 outside the tensor cores
            torch.float64: 34e12,   # float64 outside the tensor cores
            torch.bfloat16: 67e12}  # bfloat16 values: the sums run in float32
SFX = {torch.float32: "", torch.float64: "_f64", torch.bfloat16: "_bf16"}


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


class EventsMs(float):
    """A time per call on the device's clock (``_cuda_ms``, host gaps
    included), taken where no profiler trace was complete: an upper bound
    of the busy time, never a busy time.  ``_marked`` tags each result that
    holds one with ``"busy_from": "events"``."""


def _busy_ms(fn, match="", reps=REPS, launches=None):
    """Milliseconds per call that the device spends in kernels, memsets and
    copies whose name contains ``match`` (torch.profiler), from a trace
    that holds every matched event of its ``reps`` calls: each call the
    same number, which for the port's own kernels must equal what their
    wrappers' launch counters rose by (``launches``;
    ``driver.busy_seconds``).  Where three traces in a row are incomplete,
    the time per call on the device's clock as an ``EventsMs``.  Fails
    where the match disagrees with the counters and where a complete trace
    holds no device time."""
    from singlespmv_tpu_torch.harness.driver import TraceError, busy_seconds

    try:
        sec = busy_seconds(fn, match, reps, launches,
                           log=lambda m: print(m, flush=True))
    except TraceError as e:
        raise SystemExit(f"busy time: {e}")
    if sec is not None:
        return sec * 1e3
    print(f"busy time for {match!r} taken on the device's clock instead "
          "(host gaps included; \"busy_from\": \"events\")", flush=True)
    return EventsMs(_cuda_ms(fn, reps))


def _extra(on, timer, fn, *args, **kw):
    """``timer(fn, ...)``, or None where ``on`` is false: the times beside
    a kernel check, which phase bfloat16 takes on one state only and phase
    spmm bfloat16 at one B a kernel only."""
    return timer(fn, *args, **kw) if on else None


def _launched(*wrappers):
    """A function of no argument: the wrappers' launches so far, their f32
    and f64 builds together."""
    return lambda: sum(_counts(*wrappers).values())


def _marked(res):
    """``res`` (and the results nested in it) with ``"busy_from":
    "events"`` and ``"events_ms"``, the keys concerned, where a time in it
    is an ``EventsMs``."""
    keys = [k for k, v in res.items() if isinstance(v, EventsMs)]
    for v in res.values():
        if isinstance(v, dict):
            _marked(v)
    if keys:
        res |= {"busy_from": "events", "events_ms": keys}
    return res


LIBRARY_MATCH = "cusparse"   # torch's CSR products run cuSPARSE's kernels


def _library_ms(a_csr, x):
    """Milliseconds per call that the device spends in cuSPARSE's kernels
    for torch's CSR product ``a_csr @ x`` (torch.profiler): one PyTorch
    call computing the function of a product kernel, on no path of the
    port.  Prints the kernels of one trace, so that the match is seen."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn = lambda: a_csr @ x
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            names[e.name[:80]] = (names.get(e.name[:80], 0)
                                  + e.self_device_time_total)
    print(f"library kernels of A_csr @ x {tuple(x.shape)} {x.dtype}: {names}",
          flush=True)
    return _busy_ms(fn, LIBRARY_MATCH)


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _bound(nbytes, ops, dtype):
    """The least time of a call, in ms: the larger of its bytes over the
    card's memory rate and its operations over its peak for ``dtype``."""
    by_bytes, by_ops = nbytes / HBM_BPS, ops / PEAK_OPS[dtype]
    return {"bytes": int(nbytes), "ops": int(ops),
            "bound_ms": max(by_bytes, by_ops) * 1e3,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def _routed(*idx):
    """The end-lane entries that route a run total (idx >= 0)."""
    return sum(int((i >= 0).sum()) for i in idx)


def _rows_calls(state, x_table, ops, plain):
    """One function per chunk that runs the slab spmv route (or its plain
    version) over the chunk, as formats/slab.spmv calls it, adding into a
    zeroed y of its own."""
    fn = ops.slab_spmv_rows_ref if plain else ops.slab_spmv_rows
    return [lambda a=a: fn(*a, x_table, torch.zeros(
        state.n_row, dtype=ops.acc_dtype(x_table.dtype),
        device=x_table.device), state.m, state.t_step, state.merge)
        for a in zip(state.ybase, state.win, state.lane, state.sub,
                     state.val, state.hm1, state.dest)]


def compare_kernel(label, state, slab, ops, x, tol=TOL, a_csr=None,
                   extra=True):
    """Phase 2 for one slab state: the spmv route vs its plain version on
    every chunk; ``a_csr``, torch's CSR tensor of the state's matrix, times
    the library product beside it; with ``extra``, the whole-call times
    beside it (call, spmv, spmv busy)."""
    xt = slab.x_table(state, x)
    kern = _rows_calls(state, xt, ops, plain=False)
    ref = _rows_calls(state, xt, ops, plain=True)
    err, rel = _check_calls(label, "slab_spmv_rows", kern, ref, tol)
    # bytes the route must move: its streams (sub only when m > 1; two
    # bytes of dest a slot, win a row, ybase a step), the x table once, y
    # once; operations: a multiply, a prefix add and a run-total difference
    # per slot, an add per run end.  Beside it the bound of the idx-plane
    # layout of the first port (sig one byte a row, the idx planes, the
    # out blocks once)
    vsz, idx_bytes = x.element_size(), 0
    nbytes = state.n_row * ops.acc_dtype(x.dtype).itemsize
    for i, lane in enumerate(state.lane):
        h = lane.shape[0]
        streams = _nbytes(state.win[i], lane, state.val[i], state.hm1[i]) \
            + (_nbytes(state.sub[i]) if state.m > 1 else 0)
        nbytes += streams + _nbytes(state.dest[i], state.ybase[i], xt)
        idx_bytes += streams + _nbytes(state.uids[i], state.idx[i], xt) \
            + state.chunk_nu[i] * state.planes * 128 * vsz
        idx_bytes += h if state.mode == "blk" else _nbytes(state.sg0[i],
                                                           state.sg1[i])
    run_ends = sum(int((d >= 0).sum()) for d in state.dest)
    res = {
        "label": label, "dtype": str(x.dtype), "mode": state.mode,
        "kernel": ("slab_spmv_blk" if state.mode == "blk" else "slab_spmv")
        + SFX[x.dtype],
        "planes": state.planes,
        "kblk": state.idx[0].shape[0] if state.mode == "blk" else None,
        "m": state.m, "T": state.t_step, "stream_rows": state.n_slots // 128,
        "chunks": len(state.dest), "run_ends": run_ends,
        "merge": state.merge, "max_abs_err": err, "rel_err": rel,
        # device busy time: the route's kernels (direct and merge), the
        # plain version's kernels
        "ms": _busy_ms(lambda: [f() for f in kern], "slab_rows",
                       launches=_launched(ops.slab_spmv_rows)),
        "plain_ms": _busy_ms(lambda: [f() for f in ref]),
        # per call on the device's clock, host gaps included
        "call_ms": _extra(extra, _cuda_ms, lambda: [f() for f in kern]),
        "spmv_ms": _extra(extra, _cuda_ms, lambda: slab.spmv(state, x)),
        "spmv_busy_ms": _extra(extra, _busy_ms,
                               lambda: slab.spmv(state, x)),
        "library_ms": None if a_csr is None else _library_ms(a_csr, x),
        "bound_ms_idx_layout": _bound(
            idx_bytes, 3 * state.n_slots + _routed(*state.idx),
            x.dtype)["bound_ms"],
    } | _bound(nbytes, 3 * state.n_slots + run_ends, x.dtype)
    print(f"kernel {label}: {json.dumps(_marked(res))}", flush=True)
    return res


def _slab_convert(mats, name, slab, cfg, plan=None):
    """The slab state of stand-in ``name``, printing the host convert's
    seconds and the share of them ``route_rows`` takes (OptimizeTime)."""
    t0 = time.perf_counter()
    st = slab.convert(mats[name], cfg, plan=plan)
    t1 = time.perf_counter()
    slab.route_rows(st)
    routes = time.perf_counter() - t1
    print(f"slab {cfg.dtype} convert {name}: host {t1 - t0:.2f} s, of which "
          f"route_rows {routes:.3f} s; {st.mode}, planes {st.planes}, "
          f"m {st.m}, merge {st.merge}", flush=True)
    return st


def _states(state):
    """The state and its nested long-row states, outermost first."""
    while state is not None:
        yield state
        state = state.long


def _xch_calls(state, xch, ops, x):
    """{kernel: (kernel calls, plain-version calls)} over every call of the
    state and its nested states on the same inputs: the fused route as
    formats/xch.spmv makes its calls, and the pair as formats/xch.phases
    makes them (a route call adds into a y of its own, zeroed); each call
    is a function of no argument."""
    calls = {"xch_fused_rows": ([], []), "xch_mul": ([], []),
             "xch_route4_rows": ([], [])}
    for st in _states(state):
        for i, fused in enumerate((ops.xch_fused_rows,
                                   ops.xch_fused_rows_ref)):
            calls["xch_fused_rows"][i].extend(
                lambda a=a, st=st, f=fused: f(
                    *a, x, torch.zeros(st.n_row, dtype=ops.acc_dtype(
                        x.dtype), device=x.device), st.t2, st.merge2)
                for a in zip(st.base2, st.val2, st.col2, st.hm2, st.dest2))
        xt = xch.x_table(st, x)
        prod3 = xch.products(st, xt)
        for i, mul in enumerate((ops.xch_mul, ops.xch_mul_ref)):
            calls["xch_mul"][i].extend(
                lambda a=a, st=st, xt=xt, f=mul: f(*a, xt, st.m1, st.t1)
                for a in zip(st.win1, st.lane1, st.sub1, st.val1))
        for i, route in enumerate((ops.xch_route4_rows,
                                   ops.xch_route4_rows_ref)):
            calls["xch_route4_rows"][i].extend(
                lambda a=a, st=st, p=prod3, f=route: f(
                    *a, p, torch.zeros(st.n_row, dtype=ops.acc_dtype(p.dtype),
                                       device=p.device), st.m2, st.t2,
                    st.merge2)
                for a in zip(st.base2, st.cs2, st.win2, st.lane2, st.sub2,
                             st.hm2, st.dest2))
    return calls


def _check_calls(label, name, ks, rs, tol):
    """Runs each kernel call and its plain version; fails past ``tol`` of
    max|out|.  Returns (max |diff|, max |diff| / max |out|)."""
    err = rel = 0.0
    for k, r in zip(ks, rs):
        got, want = k(), r()
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        err = max(err, e)
        rel = max(rel, e / max(float(want.abs().max()), 1e-30))
        del got, want
    if not rel <= tol:
        raise SystemExit(f"{label} {name}: kernel disagrees with its plain "
                         f"version (max |diff| / max |out| = {rel:.3g} > "
                         f"{tol})")
    return err, rel


def compare_xch(label, state, xch, ops, x, tol=TOL, a_csr=None, extra=True,
                coo=None):
    """Phase 2 for one xch state: each kernel vs its plain version on every
    call of the state and of its nested state: the spmv's fused route
    ``xch_fused_rows``, and the pair it replaced (``xch_mul`` then
    ``xch_route4_rows``, whose launches here count in no path), with the
    pair's busy time and summed bounds beside the fused one's; ``a_csr``
    and ``extra`` as in ``compare_kernel``: the library time of the whole
    product stands beside each kernel.  With ``coo`` (the matrix of the
    values the state holds) the fused spmv and the pair's must agree
    within each row's reorder bound."""
    from singlespmv_tpu_torch import Config
    from singlespmv_tpu_torch.core.dtypes import name_of, to_host

    with uncounted(ops.xch_mul, ops.xch_route4_rows):
        res = _compare_xch(label, state, xch, ops, x, tol, a_csr, extra)
        if coo is not None:
            y_f = xch.spmv(state, x)
            y_p = xch.pair_spmv_acc(state, x).to(x.dtype)
            within, worst = reorder_check(
                coo, state, Config(format="xch", dtype=name_of(x.dtype)),
                to_host(x), to_host(y_f), to_host(y_p))
            res["xch_fused_rows"]["pair_reorder_worst_share"] = worst
            print(f"xch pair {label}: fused spmv against the pair's, worst "
                  f"row at {worst:.3g} of its reorder bound; bitwise equal "
                  f"{bool(torch.equal(y_f, y_p))}", flush=True)
            if not within:
                raise SystemExit(f"{label}: the fused xch spmv and the "
                                 "pair's differ past a row's reorder bound")
    f = res["xch_fused_rows"]
    print(f"xch pair {label}: fused {f['ms']:.6f} ms (bound "
          f"{f['bound_ms']:.6f}) against the pair {f['pair_ms']:.6f} ms "
          f"(bounds {f['pair_bound_ms']:.6f}); cuSPARSE {f['library_ms']} "
          "ms", flush=True)
    print(f"kernel {label}: {json.dumps(_marked(res))}", flush=True)
    return res


def _compare_xch(label, state, xch, ops, x, tol, a_csr, extra):
    calls = _xch_calls(state, xch, ops, x)
    res = {"label": label, "dtype": str(x.dtype),
           "plans": [{k: getattr(st, k) for k in (
               "m1", "m2", "t1", "t2", "kblk", "p_oh", "gb", "n_chunks",
               "p1", "n_slots1", "n_slots2", "merge2")} | {
               "calls": (len(st.win1), len(st.gids2)),
               "peel_offs": len(st.dia_offs)} for st in _states(state)]}
    # bytes each call must move: its streams (sub only when m > 1, one
    # product gathered per pass-2 slot), the x table once, its output once
    # (y once a state); operations: a multiply per pass-1 slot, a prefix add
    # and a run-total difference per pass-2 slot, an add per routed run
    # end.  The fused route: val2, col2, hm1, dest and base, x once and y
    # once a state; a multiply, a prefix add and a difference per pass-2
    # slot, an add per run end.  Beside the route's, the bound of the
    # idx-plane layout it replaced (sig one byte a row, the kblk idx planes,
    # the out groups once)
    vsz = x.element_size()
    cost = {"xch_fused_rows": [0, 0], "xch_mul": [0, 0],
            "xch_route4_rows": [0, 0]}
    idx_layout = [0, 0]
    library = None if a_csr is None else _library_ms(a_csr, x)
    for st in _states(state):
        cost["xch_fused_rows"][0] += st.n_row * ops.acc_dtype(
            x.dtype).itemsize + _nbytes(x)
        for b, v, c, hm, d in zip(st.base2, st.val2, st.col2, st.hm2,
                                  st.dest2):
            cost["xch_fused_rows"][0] += _nbytes(b, v, c, hm, d)
            cost["xch_fused_rows"][1] += 3 * v.numel() + int((d >= 0).sum())
        for win, lane, sub, val in zip(st.win1, st.lane1, st.sub1, st.val1):
            cost["xch_mul"][0] += _nbytes(win, lane, val, val, xch.x_table(
                st, x)) + (_nbytes(sub) if st.m1 > 1 else 0)
            cost["xch_mul"][1] += val.numel()
        cost["xch_route4_rows"][0] += st.n_row * ops.acc_dtype(
            x.dtype).itemsize
        for g, o, c, b, win, lane, sub, hm, idx, d, ng in zip(
                st.gids2, st.off2, st.cs2, st.base2, st.win2, st.lane2,
                st.sub2, st.hm2, st.idx2, st.dest2, st.chunk_ngrp):
            h = lane.shape[0]
            streams = (h * 128 * vsz + _nbytes(c, win, lane, hm)
                       + (_nbytes(sub) if st.m2 > 1 else 0))
            cost["xch_route4_rows"][0] += streams + _nbytes(b, d)
            cost["xch_route4_rows"][1] += 2 * h * 128 + int((d >= 0).sum())
            idx_layout[0] += (streams + _nbytes(g, o, idx) + h
                              + ng * st.gb * 128 * vsz)
            idx_layout[1] += 2 * h * 128 + _routed(idx)
    for name, (ks, rs) in calls.items():
        err, rel = _check_calls(label, name, ks, rs, tol)
        res[name] = {
            "max_abs_err": err, "rel_err": rel,
            # device busy time over all the calls: kernel, plain version
            # (the route's two kernels: the direct and the merge one)
            "ms": _busy_ms(lambda ks=ks: [f() for f in ks],
                           XCH_MATCH[name],
                           launches=_launched(getattr(ops, name))),
            "plain_ms": _busy_ms(lambda rs=rs: [f() for f in rs]),
            # the calls on the device's clock, host gaps included
            "call_ms": _extra(extra, _cuda_ms,
                              lambda ks=ks: [f() for f in ks]),
            "library_ms": library,    # the whole product's
        } | _bound(*cost[name], x.dtype)
    res["xch_route4_rows"]["bound_ms_idx_layout"] = _bound(
        *idx_layout, x.dtype)["bound_ms"]
    res["xch_fused_rows"]["pair_ms"] = (res["xch_mul"]["ms"]
                                        + res["xch_route4_rows"]["ms"])
    res["xch_fused_rows"]["pair_bound_ms"] = (
        res["xch_mul"]["bound_ms"] + res["xch_route4_rows"]["bound_ms"])
    res["spmv_ms"] = _extra(extra, _cuda_ms, lambda: xch.spmv(state, x))
    res["spmv_busy_ms"] = _extra(extra, _busy_ms,
                                 lambda: xch.spmv(state, x))
    return res


# each xch kernel's name in a torch.profiler trace: the route kernels are
# one template, told apart by their producer
XCH_MATCH = {"xch_fused_rows": "StreamGather", "xch_mul": "xch_mul_kernel",
             "xch_route4_rows": "GridProducts"}
XCH_PAIR = ("xch_mul", "xch_route4_rows")   # the fused route's pair: on the
#                   profiling phases and the calibration only


BUCKET_KERNELS = ("bucket_fused_rows",)   # bkt's and bkt_g's spmv path
BUCKET_PAIR = ("block_gather_mul", "bucket_rows")   # its first port: stage
#                                    A's product grid, read back by stage B
# the first port's stage B: checked in phase 2, on no path
BUCKET_FIRST_PORT = ("bucket_reduce", "bucket_reduce_grouped",
                     "lane_unpermute")


@contextlib.contextmanager
def uncounted(*wrappers):
    """Puts the wrappers' launch counts back as they were after the block:
    a kernel launched there to check or time it, off every path, counts in
    no path."""
    saved = {(w, attr): getattr(w, attr) for w in wrappers
             for _, attr in COUNTERS if hasattr(w, attr)}
    try:
        yield
    finally:
        for (w, attr), v in saved.items():
            setattr(w, attr, v)


@contextlib.contextmanager
def phases_uncounted(xch, xops):
    """xch's profiling phases (the pair: ``xch_mul``, then
    ``xch_route4_rows``) with their launches counted in no path, inside the
    block: the spmv runs the fused route, the phases the reference's two
    passes."""
    phases = xch.phases

    def wrapped(state):
        ph = phases(state)
        if ph is None:
            return None

        def quiet(fn):
            def run(st, inp):
                with uncounted(xops.xch_mul, xops.xch_route4_rows):
                    return fn(st, inp)
            return run

        return {k: quiet(fn) for k, fn in ph.items()}

    xch.phases = wrapped
    try:
        yield
    finally:
        xch.phases = phases


def by_kernel(compared):
    """{kernel: [its comparison results]} over the compare_* results."""
    out = {}
    for res in compared:
        if "kernel" in res:
            out.setdefault(res["kernel"], []).append(res)
            continue
        sfx = {str(t): s for t, s in SFX.items()}[res["dtype"]]
        for k in ("xch_fused_rows",) + XCH_PAIR + BUCKET_KERNELS \
                + BUCKET_PAIR + BUCKET_FIRST_PORT + PANEL_KERNELS:
            if k in res:
                out.setdefault(k + sfx, []).append(
                    res[k] | {"label": res["label"]}
                    | {e: res[e] for e in ("library_error",
                                           "reorder_worst_share",
                                           "accuracy_worst_share")
                       if e in res})
    return out


def compare_rest(label, state, slab, xch, ops, xops, x, tol):
    """Phase 2 for a hyb state's residual, on the engine it rides."""
    if state.rest_fmt == "slab":
        return compare_kernel(label, state.rest_state, slab, ops, x, tol)
    if state.rest_fmt in ("bkt", "bkt_g"):
        from singlespmv_tpu_torch.formats import bkt
        from singlespmv_tpu_torch.ops import bucket as bops

        return compare_bucket(label, state.rest_state, bkt, bops, x, tol)
    if state.rest_fmt == "css":
        from singlespmv_tpu_torch.formats import css

        return compare_scan(label, state.rest_state, css, x, tol)
    return compare_xch(label, state.rest_state, xch, xops, x, tol)


def compare_bucket(label, state, bkt, bops, x, tol=TOL, a_csr=None,
                   extra=True):
    """Phase 2 for one bkt state: its spmv kernel, the fused stage A + B
    ``bucket_fused_rows``, against its plain version on the inputs the spmv
    gives it, kernel and plain times, the bound and ``a_csr``'s product
    (torch's CSR tensor of the state's matrix: cuSPARSE); the unfused pair
    it replaced (stage A ``block_gather_mul``, then stage B
    ``bucket_rows`` on the products), each kernel the same way, with the
    pair's busy time beside the fused one and beside stage B the bound of
    the idx-plane layout; and the first port's stage B on the same
    products, with torch.gather's time beside lane_unpermute's (float32
    only, as the first port is).  The launches of the pair and of the
    first port here are not counted: their counters are as they were
    after."""
    grouped = state.row_group == 1024
    first_port = x.dtype == torch.float32
    nu_pad, sh, _, h = bkt._unit_rows(state)
    xt = bkt.x_table(state, x)
    a = (state.members, state.lane, state.src, state.val, xt, state.m)
    y = torch.zeros(state.n_row, dtype=torch.float32, device=x.device)
    off_path = [getattr(bops, k) for k in BUCKET_PAIR + BUCKET_FIRST_PORT]
    with uncounted(*off_path):
        prod = bops.block_gather_mul(*a)
        rows = (prod.view(h, 128), state.hm1r, state.dest, state.yrow, y, sh,
                nu_pad, state.parts)
        fused = a + rows[1:]
        b = (bkt.stage_b_input(state, prod), state.hm1, state.idx,
             nu_pad) + ((state.n_chunks,) if grouped else ())
        stage_b = "bucket_reduce_grouped" if grouped else "bucket_reduce"
        y_tab = getattr(bops, stage_b)(*b) if first_port else None
        slots, run_ends = state.n_slots, int((state.dest >= 0).sum())
        # bytes: each stream once (src only when m > 1), the x table, the
        # out; operations: a multiply per slot (A), a prefix add and a
        # difference per slot and an add per run end (B).  bucket_rows
        # streams the products, hm1r and dest, yrow once, y once; the
        # idx-plane layout the products, hm1 and K idx planes, and its row
        # table once; the fused launch stage A's inputs and stage B's but
        # the products, with no product out and none in
        stage_a_in = _nbytes(state.members, state.lane, state.val, xt) + (
            _nbytes(state.src) if state.m > 1 else 0)
        calls = {
            "bucket_fused_rows": (fused, _bound(
                stage_a_in + _nbytes(*rows[1:5]), 3 * slots + run_ends,
                torch.float32)),
            "block_gather_mul": (a, _bound(stage_a_in + _nbytes(prod), slots,
                                           torch.float32)),
            "bucket_rows": (rows, _bound(_nbytes(*rows[:5]),
                                         2 * slots + run_ends,
                                         torch.float32)),
        }
        if first_port:
            calls[stage_b] = (b, _bound(_nbytes(*b[:3], y_tab),
                                        2 * slots + _routed(state.idx),
                                        torch.float32))
        library = dict.fromkeys(("bucket_fused_rows", "bucket_rows"),
                                None if a_csr is None else lambda: a_csr @ x)
        if state.balanced and first_port:
            u = (bkt.y_table_t(state, y_tab), state.src_lane,
                 state.src_chunk)
            calls["lane_unpermute"] = (u, _bound(_nbytes(*u, u[0]), 0,
                                                 torch.float32))
            flat = state.src_chunk.long() * 128 + state.src_lane.long()
            library["lane_unpermute"] = lambda: torch.gather(u[0], 1, flat)
        res = {"label": label, "dtype": str(x.dtype), "row_group":
               state.row_group, "m": state.m, "K": state.k, "S": state.s,
               "G": state.g, "col_groups": state.g_tot,
               "rb_pad": state.rb_pad, "units": nu_pad, "stream_rows": h,
               "run_ends": run_ends, "parts": state.parts,
               "slots": slots, "pad": round(slots / max(state.nnz, 1), 3),
               "balanced": state.balanced}
        cusparse_ms = None if a_csr is None else _library_ms(a_csr, x)
        for name, (args, bound) in calls.items():
            fn, ref = getattr(bops, name), getattr(bops, name + "_ref")
            if name in ("bucket_rows", "bucket_fused_rows"):
                # adds into y: a zeroed y each call
                run = lambda f, n=len(args): f(  # noqa: E731
                    *args[:n - 4], y.zero_(), *args[n - 3:])
            else:
                run = lambda f: f(*args)                        # noqa: E731
            got = run(fn).clone()
            want = run(ref)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            rel = err / max(float(want.abs().max()), 1e-30)
            lib = library.get(name)
            if name == "lane_unpermute" and not torch.equal(lib(), want):
                raise SystemExit(f"{label} {name}: torch.gather computes "
                                 "another function")
            match = "GatherProducts" if name == "bucket_fused_rows" \
                else "StreamProducts" if name == "bucket_rows" \
                else f"{name}_"
            res[name] = {
                "max_abs_err": err, "rel_err": rel,
                "ms": _busy_ms(lambda: run(fn), match,
                               launches=_launched(fn)),
                "plain_ms": _busy_ms(lambda: run(ref)),
                "call_ms": _extra(extra and name == "bucket_fused_rows",
                                  _cuda_ms, lambda: run(fn)),
                "library_ms": None if lib is None
                else cusparse_ms if name in ("bucket_rows",
                                             "bucket_fused_rows")
                else _busy_ms(lib),
            } | bound
            if not rel <= tol:
                raise SystemExit(f"{label} {name}: kernel disagrees with its "
                                 f"plain version (max |diff| / max |out| = "
                                 f"{rel:.3g} > {tol})")
    res["bucket_fused_rows"]["pair_ms"] = (res["block_gather_mul"]["ms"]
                                           + res["bucket_rows"]["ms"])
    res["bucket_fused_rows"]["pair_bound_ms"] = (
        res["block_gather_mul"]["bound_ms"] + res["bucket_rows"]["bound_ms"])
    if first_port:
        res["bucket_rows"]["bound_ms_idx_layout"] = res[stage_b]["bound_ms"]
    res["spmv_ms"] = _extra(extra, _cuda_ms, lambda: bkt.spmv(state, x))
    res["spmv_busy_ms"] = _extra(extra, _busy_ms,
                                 lambda: bkt.spmv(state, x))
    f = res["bucket_fused_rows"]
    print(f"bucket pair {label}: fused {f['ms']:.6f} ms (bound "
          f"{f['bound_ms']:.6f}) against the unfused pair {f['pair_ms']:.6f}"
          f" ms (bounds {f['pair_bound_ms']:.6f}); cuSPARSE "
          f"{f['library_ms']} ms", flush=True)
    print(f"kernel {label}: {json.dumps(_marked(res))}", flush=True)
    return res


def compare_scan(label, state, mod, x, tol=TOL, extra=True):
    """Phase 9 for one ss, csr5 or css state: its scan kernel against the
    plain version on the stream its spmv scans, kernel and plain times, the
    bound, and the whole spmv's time.  No one PyTorch call computes a
    segmented scan, so there is no library time."""
    from singlespmv_tpu_torch.ops import blockgather as gops
    from singlespmv_tpu_torch.ops import segscan as sops

    name = mod.__name__.rsplit(".", 1)[1]
    if name == "css":
        args = (state.block_ids, state.col, state.val, state.heads,
                mod.x_table(state, x))
        fn, ref = gops.block_gather_scan, gops.block_gather_scan_ref
        kernel, match = "block_gather_scan", "block_gather_scan_kernel"
        # bytes: tile ids, col, val, heads and the x table in, out once (of
        # the accumulator type); operations: a multiply and an add per slot
        nbytes = _nbytes(*args) + state.val.numel() * 4 * (
            2 if x.dtype == torch.float64 else 1)
        ops_per = 2
    else:
        prod = (mod.normal_products(state, x) if name == "csr5"
                else mod.mul(state, x))
        args = (prod, state.heads)
        fn, ref = sops.segmented_scan_tiles, sops.segmented_scan_tiles_ref
        kernel, match = "segmented_scan_tiles", "segscan_kernel"
        nbytes = _nbytes(prod, state.heads) + prod.numel() * 4 * (
            2 if x.dtype == torch.float64 else 1)
        ops_per = 1
    got, want = fn(*args), ref(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    rel = err / max(float(want.abs().max()), 1e-30)
    h, w = state.heads.shape
    del got, want
    res = {
        "label": label, "dtype": str(x.dtype),
        "kernel": kernel + SFX[x.dtype],
        "stream": [h, w], "nnz": state.nnz,
        "pad": round(h * w / max(state.nnz, 1), 3),
        "max_abs_err": err, "rel_err": rel,
        "ms": _busy_ms(lambda: fn(*args), match, launches=_launched(fn)),
        "plain_ms": _busy_ms(lambda: ref(*args)),
        "call_ms": _extra(extra, _cuda_ms, lambda: fn(*args)),
        "spmv_ms": _extra(extra, _cuda_ms, lambda: mod.spmv(state, x)),
        "spmv_busy_ms": _extra(extra, _busy_ms, lambda: mod.spmv(state, x)),
        "library_ms": None,
    } | _bound(nbytes, ops_per * h * w, x.dtype)
    print(f"kernel {label}: {json.dumps(_marked(res))}", flush=True)
    if not rel <= tol:
        raise SystemExit(f"{label} {kernel}: kernel disagrees with its plain "
                         f"version (max |diff| / max |out| = {rel:.3g} > "
                         f"{tol})")
    return res


def compare_slab_spmm(label, state, slab, ops, X, a_csr, tol=TOL,
                      timed=True):
    """Phase 3: ``slab_spmm`` against its plain version on every chunk of a
    unit-mode state, for the panel X (n_col, B) of float32 or bfloat16
    (float32 out blocks either way), with torch's ``a_csr @ X`` beside it
    (None: torch refuses it).  Without ``timed`` the times stay None."""
    xp = slab.x_table(state, X)
    n_cols = X.shape[1]
    args = [(*a, xp, nu, state.m, state.t_step)
            for *a, nu in zip(state.uids, state.sg0, state.sg1, state.win,
                              state.lane, state.sub, state.val, state.hm1,
                              state.idx, state.chunk_nu)]
    kern = [lambda a=a: ops.slab_spmm(*a) for a in args]
    ref = [lambda a=a: ops.slab_spmm_ref(*a) for a in args]
    err, rel = _check_calls(label, "slab_spmm", kern, ref, tol)
    # bytes: the streams once (sub only when m > 1; idx only the planes
    # [sg0, sg1] of each step, which are all the kernel reads), the panel,
    # B columns of out blocks; operations: per column a multiply, a prefix
    # add and a difference per slot and an add per routed run end
    nbytes = _nbytes(xp)
    for i, lane in enumerate(state.lane):
        lo = state.sg0[i].clamp(min=0)
        hi = state.sg1[i].clamp(max=state.planes - 1)
        routed = int((hi - lo + 1).clamp(min=0).sum())  # planes over steps
        nbytes += _nbytes(state.uids[i], state.sg0[i], state.sg1[i],
                          state.win[i], lane, state.val[i], state.hm1[i])
        nbytes += routed * state.t_step * 128
        nbytes += _nbytes(state.sub[i]) if state.m > 1 else 0
        nbytes += state.chunk_nu[i] * n_cols * state.planes * 128 * 4
    on = timed
    res = {
        "label": label, "dtype": str(X.dtype),
        "kernel": "slab_spmm" + SFX[X.dtype],
        "B": n_cols, "planes": state.planes, "m": state.m, "T": state.t_step,
        "stream_rows": state.n_slots // 128, "chunks": len(args),
        "max_abs_err": err, "rel_err": rel,
        "ms": _extra(on, _busy_ms, lambda: [f() for f in kern],
                     "slab_spmm_kernel", launches=_launched(ops.slab_spmm)),
        "plain_ms": _extra(on, _busy_ms, lambda: [f() for f in ref],
                           reps=PLAIN_REPS),
        "call_ms": _extra(on, _cuda_ms, lambda: [f() for f in kern]),
        "spmm_ms": _extra(on, _cuda_ms, lambda: slab.spmm(state, X)),
        "spmm_busy_ms": _extra(on, _busy_ms, lambda: slab.spmm(state, X)),
        "library_ms": _extra(on and a_csr is not None, _library_ms, a_csr,
                             X),
    } | _bound(nbytes, n_cols * (3 * state.n_slots + _routed(*state.idx)),
               X.dtype)
    print(f"kernel {label}: {json.dumps(_marked(res))}", flush=True)
    return res


def compare_xch_panels(label, state, xch, ops, X, a_csr, tol=TOL,
                       timed=True):
    """Phase 3: ``xch_mul_panel`` and ``xch_route4_panel`` against their
    plain versions on every call of the state and of its nested state, for
    the panel X (n_col, B) of float32 or bfloat16 (products of X's type,
    float32 out rows), with torch's ``a_csr @ X`` (the whole product; None:
    torch refuses it) beside each.  Without ``timed`` the times stay
    None."""
    n_cols, vsz = X.shape[1], X.element_size()
    calls = {"xch_mul_panel": ([], []), "xch_route4_panel": ([], [])}
    cost = {k: [0, 0] for k in calls}
    for st in _states(state):
        xp = xch.x_table(st, X)
        prods = [ops.xch_mul_panel(w, la, su, va, xp, st.m1, st.t1)
                 for w, la, su, va in zip(st.win1, st.lane1, st.sub1,
                                          st.val1)]
        prod4 = torch.cat(prods, 0).view(st.n_chunks, st.p1, 128, n_cols)
        del prods
        cost["xch_mul_panel"][0] += _nbytes(xp)
        for a in zip(st.win1, st.lane1, st.sub1, st.val1):
            for i, fn in enumerate((ops.xch_mul_panel, ops.xch_mul_panel_ref)):
                calls["xch_mul_panel"][i].append(
                    lambda a=a, st=st, xp=xp, f=fn: f(*a, xp, st.m1, st.t1))
            win, lane, sub, val = a
            # bytes: the streams once, B x tables, B product rows per slot
            cost["xch_mul_panel"][0] += (
                _nbytes(win, lane, val) + n_cols * _nbytes(val)
                + (_nbytes(sub) if st.m1 > 1 else 0))
            cost["xch_mul_panel"][1] += n_cols * val.numel()
        for *a, ng in zip(st.gids2, st.off2, st.cs2, st.win2, st.lane2,
                          st.sub2, st.hm2, st.sig2, st.idx2, st.chunk_ngrp):
            for i, fn in enumerate((ops.xch_route4_panel,
                                    ops.xch_route4_panel_ref)):
                calls["xch_route4_panel"][i].append(
                    lambda a=a, st=st, p=prod4, ng=ng, f=fn: f(
                        *a, p, ng, st.gb, st.m2, st.t2, st.p_oh))
            g, o, c, win, lane, sub, hm, _, idx = a
            h = lane.shape[0]
            # bytes: the streams once (sig one byte a row), per column one
            # product gathered per slot (of X's type) and the float32 out
            # rows; operations: per column a prefix add and a difference
            # per slot and an add per routed run end
            cost["xch_route4_panel"][0] += (
                _nbytes(g, o, c, win, lane, hm, idx) + h
                + (_nbytes(sub) if st.m2 > 1 else 0)
                + n_cols * (h * 128 * vsz + ng * st.gb * 128 * 4))
            cost["xch_route4_panel"][1] += n_cols * (2 * h * 128
                                                     + _routed(idx))
    res = {"label": label, "dtype": str(X.dtype), "B": n_cols,
           "states": len(list(_states(state)))}
    on = timed
    library = _extra(on and a_csr is not None, _library_ms, a_csr, X)
    for name, (ks, rs) in calls.items():
        err, rel = _check_calls(label, name, ks, rs, tol)
        res[name] = {
            "max_abs_err": err, "rel_err": rel,
            "ms": _extra(on, _busy_ms, lambda ks=ks: [f() for f in ks],
                         f"{name}_kernel",
                         launches=_launched(getattr(ops, name))),
            "plain_ms": _extra(on, _busy_ms, lambda rs=rs: [f() for f in rs],
                               reps=PLAIN_REPS),
            "call_ms": _extra(on, _cuda_ms, lambda ks=ks: [f() for f in ks]),
            "library_ms": library,    # the whole product's
        } | _bound(*cost[name], X.dtype)
    res["spmm_ms"] = _extra(on, _cuda_ms, lambda: xch.spmm(state, X))
    res["spmm_busy_ms"] = _extra(on, _busy_ms, lambda: xch.spmm(state, X))
    print(f"kernel {label}: {json.dumps(_marked(res))}", flush=True)
    return res


def torch_csr(coo, dev, dtype=np.float32):
    """torch's own CSR tensor of ``coo`` on ``dev`` with values of
    ``dtype``: the yardstick of the product kernels and of the SpMM table
    (``A_csr @ X``), on no path of the port."""
    row, col, val = coo.row, coo.col, coo.val
    if not np.all(row[1:] >= row[:-1]):
        order = np.lexsort((col, row))
        row, col, val = row[order], col[order], val[order]
    crow = np.zeros(coo.n_row + 1, np.int64)
    np.cumsum(np.bincount(row, minlength=coo.n_row), out=crow[1:])
    vals = torch.from_numpy(val.astype(
        np.float32 if dtype == "bfloat16" else dtype))
    return torch.sparse_csr_tensor(
        torch.from_numpy(crow), torch.from_numpy(col.astype(np.int64)),
        vals.to(torch.bfloat16) if dtype == "bfloat16" else vals,
        size=(coo.n_row, coo.n_col)).to(dev)


def verify_columns(label, coo, X, Y, verify_result, dtype=np.float32):
    """Holds every column of Y to the float64 COO oracle; fails on one
    FAIL.  Returns the largest max_abs_err."""
    from singlespmv_tpu_torch.core.dtypes import to_host

    X, Y = to_host(X), to_host(Y)
    if Y.shape != (coo.n_row, X.shape[1]) or not np.isfinite(Y).all():
        raise SystemExit(f"{label}: Y has shape {Y.shape} or is not finite")
    worst = 0.0
    for b in range(X.shape[1]):
        ok, det = verify_result(coo, X[:, b], Y[:, b], dtype=dtype)
        if not ok:
            raise SystemExit(f"{label}: column {b} Verify FAIL {det}")
        worst = max(worst, det["max_abs_err"])
    return worst


def print_scan_estimates(reports):
    """Prints where auto priced css and ss on each stand-in; fails if ss,
    priced on every matrix, is missing."""
    for name, rep in reports.items():
        est = dict(e.rsplit(" ", 1)
                   for e in rep["AutoEstimates(us)"].split(", "))
        ranked = list(est)
        where = {k: (est[k], ranked.index(k) + 1) if k in est else None
                 for k in ("css", "ss")}
        print(f"auto {name} scan estimates (us, rank of {len(ranked)}): "
              f"{where}", flush=True)
        if where["ss"] is None:
            raise SystemExit(f"{name}: auto did not price ss")


def run_path(mats, cfg, run_benchmark, keys, dev, oracle=None,
             rest=("SLAB", "XCH"), driver=None):
    """run_benchmark on each stand-in; fails unless Verify passes, unless a
    hyb residual rides an engine in ``rest`` and, with ``oracle`` (the COO
    float64 product), unless y agrees with the oracle to
    F64_TOL·max|y_oracle|.  Time(s) is the driver's chained time.  The runs
    of ``DRIVER_RUNS`` go through ``driver``'s state cache, and
    ``driver.measure`` puts the eager wall and the busy time of a call
    beside them.  Returns {name: report}."""
    reports = {}
    for name in mats:
        cache_dir = driver.cache_dir(name, cfg) if driver else None
        r = run_benchmark(mats[name], cfg, name=name, device=dev,
                          cache_dir=cache_dir, log=lambda m: None)
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
              f"Time(s): {r.seconds} (chained) {extra} "
              f"Chip: {rep['Chip']} MaxAbsErr: {rep.get('MaxAbsErr')} "
              f"oracle_rel_err: {rel} "
              f"OptimizeTime(s): {rep['OptimizeTime(s)']}"
              + (" (convert and the cache's save)" if cache_dir else ""),
              flush=True)
        if not (r.verify_ok and r.y.shape == (mats[name].n_row,)
                and np.isfinite(r.y).all()
                and rep["Dtype"] == cfg.dtype
                and r.y.dtype == cfg.np_dtype):   # bfloat16: float32 host
            raise SystemExit(f"{name}: run_benchmark output is wrong")
        if rel is not None and not rel <= F64_TOL:
            raise SystemExit(f"{name}: float64 run off the oracle by "
                             f"{rel:.3g} > {F64_TOL} of max|y|")
        if "RestFormat" in keys and rep["RestFormat"] not in rest:
            raise SystemExit(f"{name}: hyb residual {rep['RestFormat']}")
        if cache_dir:
            driver.measure(name, cfg, r, mats[name], dev)
        reports[name] = rep
        RUNS[(name, cfg.format, cfg.dtype)] = {
            "Time(s)": r.seconds, "GFLOPS": r.gflops,
            "chosen": rep.get("ChosenFormat")}
    return reports


RUNS = {}    # (stand-in, format, dtype) → the chained Time(s) and GFLOPS


DRIVER_RUNS = (("raefsky3", "slab"), ("torso1", "slab"),
               ("webbase-1M", "xch"), ("ASIC_680ks", "xch"),
               ("Chebyshev4", "hyb"), ("g7jac200sc", "auto"))
DRIVER_KEEP = (("raefsky3", "slab"), ("torso1", "slab"),
               ("g7jac200sc", "auto"))   # states the driver phase reads
CHAIN_AB = (1, 8, 64)    # calls a graph chains, in the A/B of CHAIN
BUSY_SHARE = 0.8         # Time(s) below this share of the busy time fails
PHASE_SHARE = 0.8        # the phases' times below this share of Time(s)


def reorder_check(coo, state, cfg, x, y1, y2):
    """(ok, worst): whether y1 and y2, two results of one spmv on ``state``
    and x (host arrays), lie within each row's reorder bound of each other
    (``core/oracle.py:reorder_bound``, k_i from ``formats.adds_per_row``:
    the run totals the card adds into row i in a free order, and one more
    where a peel adds after them), and the largest share of its row's
    bound a drift took.  It replaced C.7's fixed 1e-6·max|y|, which a
    correct program broke."""
    from singlespmv_tpu_torch.core.oracle import reorder_bound
    from singlespmv_tpu_torch.formats import adds_per_row

    out = cfg.dtype
    acc = "float64" if out == "float64" else "float32"
    bound = reorder_bound(coo, np.asarray(x, np.float64),
                          adds_per_row(state, cfg), acc, out)
    drift = np.abs(np.asarray(y1, np.float64) - np.asarray(y2, np.float64))
    worst = float(np.max(drift / np.maximum(bound, 1e-300), initial=0.0))
    return bool((drift <= bound).all()), worst


class DriverRuns:
    """The float32 runs of ``DRIVER_RUNS``: each goes through a state cache
    (``run_benchmark(cache_dir=...)``), so that ``measure`` reads the very
    state the driver timed, and puts beside its chained Time(s) the eager
    wall (``_cuda_ms``, 20 calls) and the busy time of one call
    (``_busy_ms``), and the y of a graph replay beside the eager y."""

    def __init__(self):
        self.dir = tempfile.mkdtemp(prefix="state_cache_")
        weakref.finalize(self, shutil.rmtree, self.dir, ignore_errors=True)
        self.rows = {}
        self.results = {}

    def cache_dir(self, name, cfg):
        if cfg.dtype == "float32" and (name, cfg.format) in DRIVER_RUNS:
            return self.dir
        return None

    def path(self, name, fmt):
        return os.path.join(self.dir, f"{name}-{fmt}")

    def load(self, name, cfg, coo, dev):
        from singlespmv_tpu_torch.formats import cache

        st = cache.load_state(self.path(name, cfg.format), coo, cfg, dev)
        if st is None:
            raise SystemExit(f"{name}: the driver's cached {cfg.format} "
                             "state did not load")
        return st

    def measure(self, name, cfg, res, coo, dev):
        from singlespmv_tpu_torch.core import create_random_vector
        from singlespmv_tpu_torch.formats import spmv_fn
        from singlespmv_tpu_torch.harness.driver import (CHAIN,
                                                         make_chained_runner)

        from singlespmv_tpu_torch.core.dtypes import to_host, value_tensor

        st = self.load(name, cfg, coo, dev)
        spmv = spmv_fn(cfg)
        x = value_tensor(create_random_vector(coo.n_col),
                         cfg.dtype).to(dev)     # the driver's x
        eager = spmv(st, x)
        graph = make_chained_runner(spmv, st, x, name=f"{name} {cfg.format}")
        y = graph(2 * CHAIN)            # the output of the chain's graph
        torch.cuda.synchronize()
        scale = float(eager.abs().max())
        drift = float((y - eager).abs().max())
        graph_ok, worst = reorder_check(coo, st, cfg, to_host(x),
                                        to_host(y), to_host(eager))
        del graph, y
        busy = _busy_ms(lambda: spmv(st, x))
        row = {"matrix": name, "format": cfg.format,
               "chosen": res.report.get("ChosenFormat"),
               "time_us": res.seconds * 1e6, "busy_us": busy * 1e3,
               "busy_complete": not isinstance(busy, EventsMs),
               "eager_wall_us": _cuda_ms(lambda: spmv(st, x)) * 1e3,
               "graph_drift": drift, "max_y": scale,
               "graph_within_reorder_bound": graph_ok,
               "graph_worst_share_of_bound": worst,
               "optimize_s": res.report["OptimizeTime(s)"]}
        self.rows[name] = row
        self.results[name] = res
        print(f"driver timing {name} {cfg.format}: Time(s) chained "
              f"{row['time_us']:.2f} us, busy {row['busy_us']:.2f} us, eager "
              f"wall {row['eager_wall_us']:.2f} us; graph vs eager y drift "
              f"{drift:.3g} of max|y| {scale:.3g}, worst row at {worst:.3g} "
              "of its reorder bound", flush=True)
        if (name, cfg.format) not in DRIVER_KEEP:
            for suffix in (".npz", ".json"):
                os.remove(self.path(name, cfg.format) + suffix)


def check_auto(reports):
    """Prints every candidate that auto skipped (at convert or at its first
    calls); fails unless each was skipped for a guard error."""
    for name, rep in reports.items():
        for key in ("AutoFailed", "AutoExcluded"):
            for entry in filter(None, rep.get(key, "none").split("; ")):
                if entry == "none":
                    continue
                print(f"auto {name} skipped ({key}): {entry}", flush=True)
                if entry.split(": ")[1] not in GUARD_ERRORS:
                    raise SystemExit(f"{name}: auto skipped a candidate for "
                                     f"a reason that is no guard error: "
                                     f"{entry}")


CAL_MATCH = {       # wrapper → its kernel's name in a torch.profiler trace
    "xch_route": "xch_route_kernel", "lane_gather": "gather_mul_kernel",
    "gather1024": "gather_mul_kernel", "palette_gather": "gather_mul_kernel",
    "pal2step": "gather_mul_kernel", "sublane_gather": "gather_mul_",
    "onehot_bins": "onehot_bins_kernel",
    "dynslice_accum": "dynslice_accum_kernel",
    "seg_scan": "segscan_steps_kernel", "seg_scan_roll": "segscan_steps_kernel",
    "tile_transpose": "tile_transpose_kernel", "slab_step": "probe_slab_kernel"}
# kernel line name → (wrapper, source, the TPU kernel's function)
CAL_KERNELS = {   # xch_route's row is a path row (phase "xch v3")
    "probe_lane_gather": ("lane_gather", "csrc/probes.cu",
                          "singlespmv_tpu/harness/microbench.py:118"),
    "probe_gather1024": ("gather1024", "csrc/probes.cu",
                         "singlespmv_tpu/harness/microbench.py:166"),
    "probe_palette_gather": ("palette_gather", "csrc/probes.cu",
                             "singlespmv_tpu/harness/microbench.py:212"),
    "probe_pal2step": ("pal2step", "csrc/probes.cu",
                       "singlespmv_tpu/harness/microbench.py:265"),
    "probe_onehot_inkernel": ("onehot_bins", "csrc/probes.cu",
                              "singlespmv_tpu/harness/microbench.py:324"),
    "probe_sublane_gather": ("sublane_gather", "csrc/probes.cu",
                             "singlespmv_tpu/harness/microbench.py:364"),
    "probe_dynslice_accum": ("dynslice_accum", "csrc/probes.cu",
                             "singlespmv_tpu/harness/microbench.py:435"),
    "probe_seg_scan": ("seg_scan", "csrc/probes.cu",
                       "singlespmv_tpu/harness/microbench.py:478"),
    "probe_seg_scan_roll": ("seg_scan_roll", "csrc/probes.cu",
                            "singlespmv_tpu/harness/microbench.py:520"),
    "probe_pallas_tile_transpose": (
        "tile_transpose", "csrc/probes.cu",
        "singlespmv_tpu/harness/microbench.py:565"),
    "probe_slab": ("slab_step", "csrc/probe_slab.cu",
                   "scripts/probe_slab.py:28"),
}
CAL_TARGET_S = 0.03     # the probes' loop length (the reference's: 0.25 s)
# calibrate's route_slot_s on the first port's xch_route kernel (a shared
# accumulator of float atomics a block of 32 rows): this script's fit on
# an NVIDIA H100 80GB HBM3 at 700 W
ROUTE_SLOT_S_FIRST_PORT = 5.555160775827517e-13
# (CB, NU, S, offset in floats) of the transposes held beside the probe's
ODD_TRANSPOSES = ((13, 11, 3, 0), (40, 24, 1, 0), (17, 9, 8, 1),
                  (24, 40, 128, 1), (9, 300, 12, 0))
ODD_ONEHOT_G = (8, 8192)  # the bin sums with bins outside [0, 128)
# (x rows, G) of the sublane gather beside the probes' 1,024, 64 and 8 rows:
# a table staged as slices of lanes at a small size, and one past shared
# memory, which the kernel reads from device memory
ODD_SUBLANE = ((129, 296), (3000, 8192))
# each hand-written probe beside the probe of the same motion that the
# reference left to XLA, printed after microbench.run
PROBE_PAIRS = (("pallas_tile_transpose", "xla_transpose_s128"),
               ("onehot_inkernel_route", "onehot_mxu_route"))


def _check_one(label, fn, args, kw, ref, bound, match, library=None,
               tol=TOL, timed=True):
    """One kernel call against its plain version on the card: errors and
    the bound, and when ``timed`` the kernel, plain and library busy times.
    ``library`` is one PyTorch call computing the same function, checked
    against the plain version's result with ``check`` before it is timed."""
    got, want = fn(*args, **kw), ref(*args, **kw)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    rel = err / max(float(want.float().abs().max()), 1e-30)
    res = {"label": label, "max_abs_err": err, "rel_err": rel, "ms": None,
           "plain_ms": None, "call_ms": None, "library_ms": None} | bound
    if timed:
        if library is not None:
            call, check = library
            if not check(want):
                raise SystemExit(f"{label}: the library call computes "
                                 "another function")
            res["library_ms"] = _busy_ms(call)
        res |= {"ms": _busy_ms(lambda: fn(*args, **kw), match,
                               launches=_launched(fn)),
                "plain_ms": _busy_ms(lambda: ref(*args, **kw)),
                "call_ms": _cuda_ms(lambda: fn(*args, **kw))}
    print(f"kernel {label}: {json.dumps(_marked(res))}", flush=True)
    if not rel <= tol:
        raise SystemExit(f"{label}: kernel disagrees with its plain version "
                         f"(max |diff| / max |out| = {rel:.3g} > {tol})")
    return res


def compare_calibration(dev):
    """The calibration path's kernels against their plain versions at every
    shape the path gives them: ``xch_route`` on calibrate's own inputs (H
    16,384 at planes 8 and 16, and a case whose sg0/sg1 prune, pg 4 <
    planes), each probe kernel on the inputs of every probe of ``PROBES``
    that times it and ``probe_pal2step``'s (the gathers exactly), the odd
    transposes, bin sums, accumulates and sublane tables, ``slab_step`` at
    every (T, S8, stage) of ``probe_slab.ROWS`` and at stage "route".  Only the
    first check of each kernel (and dtype) is timed.  Returns {kernel line
    name: [results]}, the timed one first."""
    from singlespmv_tpu_torch.harness import calibrate, microbench
    from singlespmv_tpu_torch.harness import probe_slab as pslab
    from singlespmv_tpu_torch.ops import probes
    from singlespmv_tpu_torch.ops import xch as xops

    out = {}
    rng = np.random.default_rng(0)
    # xch_route: bytes are the streams, the active planes of idx, the
    # product chunks once and the out rows; operations a prefix add and a
    # difference per slot and an add per routed run end
    cases = []
    for planes in (16, 8):
        a, ngb = calibrate._route_args(rng, 16 * 1024, planes, 1, 64,
                                       device=dev)
        cases.append((f"xch_route planes {planes}", a, ngb, 1, planes, 64,
                      16, 8))
    a, _ = calibrate._route_args(rng, 16 * 1024, 16, 8, 64, device=dev)
    a[1] = (a[0] // 2).contiguous()
    n_steps = a[0].shape[0]
    a[3] = torch.from_numpy(rng.integers(-2, 18, n_steps).astype(
        np.int32)).to(dev)
    a[4] = torch.from_numpy(rng.integers(-2, 18, n_steps).astype(
        np.int32)).to(dev)
    cases.append(("xch_route pruned pg 4", a, int(a[1][-1]) + 1, 8, 16, 64,
                  2, 4))
    for label, a, ngb, m, planes, T, g_grp, pg in cases:
        uids, _, cs, sg0, sg1, win, lane, sub, hm1, idx, prod3 = a
        act = xops._active_planes(sg0, sg1, planes, pg)   # (n_steps, planes)
        rows = act.repeat_interleave(T, 0).T[:, :, None]  # (planes, H, 1)
        nbytes = (_nbytes(uids, cs, sg0, sg1, win, lane, hm1, prod3)
                  + int(act.sum()) * T * 128 + ngb * g_grp * planes * 512
                  + (_nbytes(sub) if m > 1 else 0))
        ops = 2 * lane.numel() + int(((idx >= 0) & rows).sum())
        # both of calibrate's cases are timed: route_slot_s fits their
        # difference
        out.setdefault("xch_route", []).append(_check_one(
            label, xops.xch_route, (*a, ngb, m, planes, T, g_grp, pg), {},
            xops.xch_route_ref, _bound(nbytes, ops, torch.float32),
            CAL_MATCH["xch_route"], timed="pruned" not in label))
        del a
    # the probe kernels on every probe's inputs, each kernel (and dtype)
    # timed on the first: its probe's defaults, and bfloat16's w 512
    line_of = {w: k for k, (w, _, _) in CAL_KERNELS.items()}
    timed = set()
    for name, (case, ckw) in microbench.KERNEL_CASES.items():
        fn, args, kw = case(**ckw, device=dev)
        ref = getattr(probes, fn.__name__ + "_ref")
        res = ref(*args, **kw)
        n = res.numel()
        nbytes = _nbytes(*args, res)
        ops = {"seg_scan": 7, "seg_scan_roll": kw.get("steps", 7),
               "tile_transpose": 0}.get(fn.__name__, 1) * n
        library = None
        if fn is probes.tile_transpose:
            cb, nu, s = args[0].shape[0], kw["nu"], kw["s"]
            v3 = args[0].view(cb, nu, s)
            library = (lambda v3=v3: v3.transpose(0, 1).contiguous(),
                       lambda want, v3=v3: torch.equal(
                           v3.transpose(0, 1).reshape(want.shape), want))
        elif fn is probes.onehot_bins:
            tiles = args[0].shape[0] // 8
            idx64 = args[0].view(tiles, -1).long()
            src = args[1].view(tiles, -1)
            acc = torch.zeros(tiles, 128, device=dev)
            library = (lambda: acc.scatter_add_(1, idx64, src),
                       lambda want: torch.allclose(
                           torch.zeros_like(acc).scatter_add_(1, idx64, src),
                           want[::8], rtol=0,
                           atol=TOL * float(want.abs().max())))
            ops = args[1].numel()
        elif fn is probes.dynslice_accum:
            dst = (args[0].long()[:, None]
                   + torch.arange(8, device=dev)).reshape(-1)
            y = torch.zeros(1024, 128, device=dev)
            library = (lambda: y.index_add_(0, dst, args[1]),
                       lambda want: torch.allclose(
                           torch.zeros_like(y).index_add_(0, dst, args[1]),
                           want, rtol=0, atol=TOL * float(want.abs().max())))
            ops = args[1].numel()
        kname = line_of[fn.__name__]
        first = (kname, res.dtype) not in timed
        timed.add((kname, res.dtype))
        out.setdefault(kname, []).append(_check_one(
            f"{kname} {name}", fn, args, kw, ref,
            _bound(nbytes, ops, torch.float32), CAL_MATCH[fn.__name__],
            library, tol=0 if fn in probes.GATHERS else TOL,
            timed=first))
        del fn, args, res, library
    # the transpose at shapes the TPU could not take (S 3 and 1, CB and NU
    # not multiples of 8; offsets of one float, which take the scalar path)
    # and the bin sums with bins outside [0, 128), which add nowhere
    for cb, nu, s, off in ODD_TRANSPOSES:
        a = torch.from_numpy(rng.standard_normal(cb * nu * s + off).astype(
            np.float32)).to(dev)[off:].view(cb, nu * s)
        out["probe_pallas_tile_transpose"].append(_check_one(
            f"probe_pallas_tile_transpose CB {cb} NU {nu} S {s} offset {off}",
            probes.tile_transpose, (a,), {"nu": nu, "s": s},
            probes.tile_transpose_ref,
            _bound(2 * _nbytes(a), 0, torch.float32),
            CAL_MATCH["tile_transpose"], timed=False))
    for g in ODD_ONEHOT_G:
        bins = torch.from_numpy(rng.integers(-8, 200, (g, 128)).astype(
            np.int32)).to(dev)
        val = torch.from_numpy(rng.standard_normal((g, 128)).astype(
            np.float32)).to(dev)
        out["probe_onehot_inkernel"].append(_check_one(
            f"probe_onehot_inkernel G {g} bins in [-8, 200)",
            probes.onehot_bins, (bins, val), {}, probes.onehot_bins_ref,
            _bound(3 * _nbytes(val), val.numel(), torch.float32),
            CAL_MATCH["onehot_bins"], timed=False))
    # the accumulate at offs the probe never draws (unsorted, equal, past
    # both ends of y, T 1 and 3), and the sublane gather at a table staged
    # as slices and at one read from device memory
    v = torch.from_numpy(rng.standard_normal((8 * 4096, 128)).astype(
        np.float32)).to(dev)
    for label, o in microbench.dynslice_odd_offs().items():
        offs, vt = torch.from_numpy(o).to(dev), v[:8 * len(o)]
        out["probe_dynslice_accum"].append(_check_one(
            f"probe_dynslice_accum {label}", probes.dynslice_accum,
            (offs, vt), {}, probes.dynslice_accum_ref,
            _bound(_nbytes(offs, vt) + 1024 * 512, vt.numel(),
                   torch.float32),
            CAL_MATCH["dynslice_accum"], timed=False))
    for rows, g in ODD_SUBLANE:
        idx = torch.from_numpy(rng.integers(0, rows, (g, 128)).astype(
            np.int32)).to(dev)
        val = torch.from_numpy(rng.standard_normal((g, 128)).astype(
            np.float32)).to(dev)
        x = torch.from_numpy(rng.standard_normal((rows, 128)).astype(
            np.float32)).to(dev)
        out["probe_sublane_gather"].append(_check_one(
            f"probe_sublane_gather rows {rows} G {g}", probes.sublane_gather,
            (idx, val, x), {}, probes.sublane_gather_ref,
            _bound(_nbytes(idx, val, x, val), val.numel(), torch.float32),
            CAL_MATCH["sublane_gather"], tol=0, timed=False))
    # slab_step at every row of probe_slab.main and at stage "route", timed
    # at T 32, S8 8, "all": bytes the streams its stage reads, x once and
    # the out blocks; operations a multiply (gather stages), a prefix add
    # and a difference (totals stages), an add per routed run end (route
    # stages) or per slot
    slab_rows = sorted(set(pslab.ROWS) | {(32, 8, "route")},
                       key=lambda r: (r != (32, 8, "all"), r))
    inputs = {}
    for T, s8, stage in slab_rows:
        if (T, s8) not in inputs:
            n_steps = 3200 // (T // 8)
            arrs = pslab.make_inputs(np.random.default_rng(7), n_steps, T,
                                     s8, pslab.CB, pslab.NU)
            inputs[T, s8] = [torch.from_numpy(v).to(dev) for v in arrs]
        uids, base, lane, sub, val, hm1, idx, x = inputs[T, s8]
        nbytes = _nbytes(uids, base, val, x) + pslab.NU * 8 * 512
        ops = 0
        if stage in probes.MULTIPLY_STAGES:
            ops += val.numel()
            nbytes += _nbytes(lane) if stage != "window" else 0
            nbytes += _nbytes(sub) if stage in ("all", "select") else 0
        if stage in probes.TOTALS_STAGES:
            ops += 2 * val.numel()
            nbytes += _nbytes(hm1)
        if stage in probes.ROUTE_STAGES:
            ops += _routed(idx)
            nbytes += _nbytes(idx)
        else:
            ops += val.numel()
        first = "probe_slab" not in out
        out.setdefault("probe_slab", []).append(_check_one(
            f"probe_slab T {T} S8 {s8} {stage}", probes.slab_step,
            (uids, base, lane, sub, val, hm1, idx, x, pslab.NU, T,
             stage), {}, probes.slab_step_ref,
            _bound(nbytes, ops, torch.float32), CAL_MATCH["slab_step"],
            timed=first))
    return out


def eager_probe_seconds(dev):
    """{probe: seconds an iteration} of the microbench's 35 probes and
    ``probe_pal2step`` on a host loop of eager calls
    (``microbench.loop_chain``): the timing before the probes' chains were
    captured as CUDA graphs, one run, for the record."""
    from singlespmv_tpu_torch.harness import microbench

    captured = microbench.chained
    microbench.chained = microbench.loop_chain
    try:
        rows = microbench.run(target_s=CAL_TARGET_S, device=dev,
                              log=lambda m: None)
        _, pal = microbench.probe_pal2step(device=dev, target_s=CAL_TARGET_S)
    finally:
        microbench.chained = captured
    return {r[0]: r[2] for r in rows} | {"pal2step_w1024_k1": pal}


def probe_kernel_busy(dev):
    """{probe: its kernel's busy ms a call} on the probe's own inputs, for
    every call of ``microbench.KERNEL_CASES``."""
    from singlespmv_tpu_torch.harness import microbench

    out = {}
    for name, (case, ckw) in microbench.KERNEL_CASES.items():
        fn, args, kw = case(**ckw, device=dev)
        out[name] = _busy_ms(lambda: fn(*args, **kw), CAL_MATCH[fn.__name__],
                             launches=_launched(fn))
        del fn, args
    return out


def run_calibration_path(dev, eager, busy):
    """The calibration path through its entry points: calibrate.measure
    (saved to a temporary file, never into the tree), the microbench's 35
    probes and probe_pal2step, and probe_slab's nine rows.  Each probe's
    seconds an iteration come from its captured chain; a ``probe_chain``
    line puts them beside its kernel's busy time (``busy``, ms) and the
    eager loop's (``eager``, seconds)."""
    from singlespmv_tpu_torch.core import chipconst
    from singlespmv_tpu_torch.harness import calibrate, microbench
    from singlespmv_tpu_torch.harness import probe_slab as pslab
    from singlespmv_tpu_torch.harness.roofline import detect_chip

    vals = calibrate.measure(dev, log=lambda m: print(f"calibrate: {m}",
                                                      flush=True))
    print(f"calibrated route_slot_s = {vals['route_slot_s']!r} s a plane "
          f"slot, beside {ROUTE_SLOT_S_FIRST_PORT!r} with the first port's "
          "xch_route kernel; the planner prices with neither yet (no "
          "chip_constants.json is committed, and the fit reads the "
          "wrapper's host time: ROADMAP A.7b)", flush=True)
    if set(vals) != {"hbm_bps", "step_fixed_s", "base_slot_s", "sel_slot_s",
                     "route_slot_s", "scatter_rate"} or not all(
                         np.isfinite(v) and v >= 0 for v in vals.values()):
        raise SystemExit(f"calibrate: unexpected keys or values {vals}")
    keep, why = calibrate.screen(vals, detect_chip(dev).hbm_gbps)
    for k, v in vals.items():
        take = (f"left out by calibrate.main: {why[k]}" if k in why else
                "taken by chipconst.load" if v > 0 else
                "default kept by chipconst.load")
        print(f"calibrated {k} = {v!r} ({take}; v5e default "
              f"{chipconst.DEFAULTS[k]!r})", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        path = chipconst.save(keep, os.path.join(tmp, "chip_constants.json"))
        with open(path) as f:
            print(f"calibrate: saved {json.load(f)} to a temporary file")
    print(f"calibrated_keys {json.dumps(vals)}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        tsv = os.path.join(tmp, "micro.tsv")
        rows = microbench.run(out=tsv, target_s=CAL_TARGET_S, device=dev,
                              log=lambda m: print(f"probe {m}", flush=True))
        with open(tsv) as f:
            print("microbench TSV:\n" + f.read(), flush=True)
    if len(rows) != 35 or not all(np.isfinite(r[2]) and r[2] > 0
                                  for r in rows):
        raise SystemExit(f"microbench: expected 35 timed probes, got {rows}")
    rate = {r[0]: r[3] for r in rows}
    for mine, xla in PROBE_PAIRS:
        print(f"probe pair: {mine} {rate[mine]:.2f} G elem/s, {xla} "
              f"{rate[xla]:.2f} G elem/s", flush=True)
    elems, sec = microbench.probe_pal2step(device=dev, target_s=CAL_TARGET_S)
    print(f"probe pal2step_w1024_k1 {elems / sec / 1e9:10.2f} G elem/s   "
          f"({sec * 1e6:9.1f} us)", flush=True)
    for name, _, s_iter, _ in rows + [("pal2step_w1024_k1", elems, sec,
                                       None)]:
        b = busy.get(name)
        print("probe_chain " + json.dumps({
            "probe": name, "captured_us": s_iter * 1e6,
            "kernel_busy_us": None if b is None else b * 1e3,
            "busy_from": "events" if isinstance(b, EventsMs) else
            (None if b is None else "trace"),
            "eager_loop_us": eager[name] * 1e6}), flush=True)
    slab_rows = pslab.main(dev, CAL_TARGET_S,
                           log=lambda m: print(f"probe_slab {m}", flush=True))
    if len(slab_rows) != 9 or not all(r[3] > 0 for r in slab_rows):
        raise SystemExit(f"probe_slab: expected 9 timed rows, got "
                         f"{slab_rows}")
    return vals


ELLG_MATS = ("raefsky3", "g7jac200sc")   # ellg plans m 1 and m > 1 there
NEW_FORMATS = ("coo", "ell", "jds", "bcoo", "hostlib")   # run on raefsky3
HEADLINE_MATS = ("g7jac200sc", "lhr34")   # the two smallest suite stand-ins
SWEEP_TODO = ("prefix,format,calibrate_seconds,n_trials\n"   # two rows,
              "ell,ell,0.05,3\nellg,ellg,0.05,3\n")        # on lhr34


def compare_ellg(label, state, ellg, bops, x, per_pass=True):
    """The campaign's kernel checks for one ellg state: its passes' kernel
    ``ellg_rows`` (every pass in one launch) against its plain version,
    timed beside its bound and beside the first port of the passes
    (``ellg_rows_ref`` with stage A on the kernel); and that first port's
    stage A,
    ``block_gather_mul`` at gran 128, against its plain version on every
    pass, at the pass's shapes (its panel of the x table, m members, src
    None where m is 1), each pass timed with its bound (its launches not
    counted), where ``per_pass``.  Returns (the ``ellg_rows`` result, a
    result per pass)."""
    xp = torch.zeros(-(-state.n_col // 128) * 128, dtype=x.dtype,
                     device=x.device)
    xp[: state.n_col] = x
    y = torch.zeros(state.n_row, dtype=torch.float32, device=x.device)
    table = ellg.row_passes(state.passes)
    run = lambda f: f(table, xp, y.zero_())                  # noqa: E731
    got = run(bops.ellg_rows).clone()
    want = run(bops.ellg_rows_ref)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    rel = err / max(float(want.abs().max()), 1e-30)
    if not rel <= TOL:
        raise SystemExit(f"{label}: ellg_rows disagrees with its plain "
                         f"version ({rel:.3g} > {TOL} of max|y|)")
    slots = sum(p.lane.numel() for p in state.passes)
    # bytes: each pass's members, lane, val, src where m > 1 and blocks
    # where not full, each col-block of x that a pass's panel holds once
    # (passes may share a panel), y once; operations: a multiply and an
    # add a slot
    in_panel = np.zeros(xp.numel() // 128, bool)
    for p in state.passes:
        in_panel[p.panel_base: p.panel_base + p.panel_cb] = True
    nbytes = y.numel() * 4 + int(in_panel.sum()) * 128 * x.element_size() \
        + sum(_nbytes(p.members, p.lane, p.val)
              + (_nbytes(p.src) if p.m > 1 else 0)
              + (0 if p.blocks is None else _nbytes(p.blocks))
              for p in state.passes)
    with uncounted(bops.block_gather_mul):
        pair_ms = _busy_ms(lambda: bops.ellg_rows_ref(
            table, xp, y.zero_(), stage_a=bops.block_gather_mul))
    # the library: torch's CSR of the passes' matrix (the rest taken away)
    # times x, at x's value type
    a_csr = torch_csr(ellg.to_coo(dataclasses.replace(
        state, rest_fmt="", rest_state=None)), x.device,
        "bfloat16" if x.dtype == torch.bfloat16 else np.float32)
    library_ms = _library_ms(a_csr, x)
    del a_csr
    rows = {"label": label, "dtype": str(x.dtype),
            "kernel": "ellg_rows" + SFX[x.dtype],
            "passes": [f"t{p.t}m{p.m}{'' if p.full else ' blocks'}"
                       for p in state.passes], "slots": slots,
            "max_abs_err": err, "rel_err": rel,
            "ms": _busy_ms(lambda: run(bops.ellg_rows), "ellg_rows_kernel",
                           launches=_launched(bops.ellg_rows)),
            "plain_ms": _busy_ms(lambda: run(bops.ellg_rows_ref)),
            "call_ms": _cuda_ms(lambda: run(bops.ellg_rows)),
            "first_port_ms": pair_ms, "library_ms": library_ms} | _bound(
        nbytes, 2 * slots, x.dtype)
    print(f"kernel ellg {label} ellg_rows: {json.dumps(_marked(rows))}",
          flush=True)
    out = []
    for i, p in enumerate(state.passes if per_pass else ()):
        lo = p.panel_base * 128
        xpan = xp[lo: lo + p.panel_cb * 128].view(p.panel_cb, 128)
        args = (p.members, p.lane, p.src, p.val, xpan, p.m)
        with uncounted(bops.block_gather_mul):
            got = bops.block_gather_mul(*args, gran=128).clone()
            want = bops.block_gather_mul_ref(*args, gran=128)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            rel = err / max(float(want.abs().max()), 1e-30)
            if not rel <= TOL:
                raise SystemExit(f"{label} pass {i}: block_gather_mul at "
                                 f"gran 128 disagrees with its plain version "
                                 f"({rel:.3g} > {TOL} of max|out|)")
            slots = p.lane.numel()
            # bytes: members, lane, val, src where m > 1, the panel once,
            # the products out; operations: a multiply a slot
            res = {"label": f"{label} pass {i}", "t": p.t, "m": p.m,
                   "full": p.full, "shape": list(p.lane.shape), "gran": 128,
                   "slots": slots, "panel_cb": p.panel_cb,
                   "max_abs_err": err, "rel_err": rel,
                   "ms": _busy_ms(
                       lambda: bops.block_gather_mul(*args, gran=128),
                       "block_gather_mul_",
                       launches=_launched(bops.block_gather_mul)),
                   "plain_ms": _busy_ms(
                       lambda: bops.block_gather_mul_ref(*args, gran=128)),
                   "library_ms": None} | _bound(
                _nbytes(p.members, p.lane, p.val, xpan)
                + x.element_size() * slots
                + (_nbytes(p.src) if p.m > 1 else 0), slots, x.dtype)
        print(f"kernel ellg {res['label']}: {json.dumps(_marked(res))}",
              flush=True)
        out.append(res)
    return rows, out


def _bench_py_keys():
    """The keys of the JSON line of the repository's root bench.py."""
    import ast

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "bench.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and getattr(
                node.targets[0], "id", None) == "line":
            return [k.value for k in node.value.keys]
    raise SystemExit("bench.py: no JSON line found")


def run_campaign_tools(mats, dev, card):
    """The campaign's entry points: the headline module on
    ``HEADLINE_MATS``, a two-row sweep on lhr34 and ``format-logs`` over
    its logs.  Fails unless each runs, every row passes Verify and the
    headline prints bench.py's keys."""
    import io

    from singlespmv_tpu_torch import bench, cli
    from singlespmv_tpu_torch.core import write_matrix_market
    from singlespmv_tpu_torch.harness.report import parse_blocks
    from singlespmv_tpu_torch.harness.suite import read_tsv
    from singlespmv_tpu_torch.harness.sweep import run_sweep

    work = tempfile.mkdtemp(prefix="campaign_")
    try:
        tsv = os.path.join(work, "headline.tsv")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            bench.main(["--names", *HEADLINE_MATS, "--out", tsv,
                        "--cache-dir", os.path.join(work, "cache"),
                        "--prefetch", "2"])
        line = json.loads(out.getvalue().strip().splitlines()[-1])
        print(f"headline ({card}): {json.dumps(line)}", flush=True)
        rows = read_tsv(tsv)
        for r in rows:
            print(f"headline_row {json.dumps(r)}", flush=True)
        if list(line) != _bench_py_keys() or sorted(line["detail"]) != \
                sorted(HEADLINE_MATS) or any(r["Verify"] != "PASS"
                                             for r in rows):
            raise SystemExit(f"headline: wrong line or rows: {line}")
        mtx = os.path.join(work, "lhr34.mtx")
        write_matrix_market(mtx, mats["lhr34"])
        logs = os.path.join(work, "log")
        t0 = time.perf_counter()
        failures = run_sweep(SWEEP_TODO, [mtx], logs, device=dev,
                             log=lambda m: None)
        with open(os.path.join(logs, "manifest.json")) as f:
            manifest = json.load(f)
        print(f"sweep: {failures} failures in {time.perf_counter() - t0:.1f}"
              f" s, manifest {manifest}", flush=True)
        text = ""
        for prefix in ("ell", "ellg"):
            with open(os.path.join(logs, f"{prefix}.log")) as f:
                text += f.read()
        with open(os.path.join(logs, "all.log"), "w") as f:
            f.write(text)
        table = io.StringIO()
        with contextlib.redirect_stdout(table):
            rc = cli.main(["format-logs", os.path.join(logs, "all.log"),
                           "--keys", "Verify", "Time(s)"])
        print("format-logs:\n" + table.getvalue().rstrip(), flush=True)
        got = [ln.split("\t") for ln in table.getvalue().splitlines()]
        if failures or rc or len(got) != 3 or len(parse_blocks(text)) != 2 \
                or {r[2] for r in got[1:]} != {"ELL", "ELLG"} \
                or any(r[7] != "PASS" for r in got[1:]):
            raise SystemExit("sweep or format-logs: wrong result")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def run_campaign(mats, dev, card, count_path, wrappers):
    """Phase "campaign": ``compare_ellg`` on every pass of ``ELLG_MATS``
    (which must plan m = 1 and m > 1 between them), then the ellg path and
    ``NEW_FORMATS`` on raefsky3 through ``run_benchmark``, then
    ``run_campaign_tools``; ``count_path`` reads the launches of
    ``wrappers`` after each path.  Returns (the ``ellg_rows`` checks, the
    per-pass checks of its first port's stage A, the ellg path's launches
    of that stage A: 0, or the path fails)."""
    from singlespmv_tpu_torch import Config
    from singlespmv_tpu_torch.core import create_random_vector
    from singlespmv_tpu_torch.formats import ellg
    from singlespmv_tpu_torch.harness import run_benchmark
    from singlespmv_tpu_torch.ops import bucket as bops

    cfg = Config(format="ellg")
    run_cfg = cfg.replace(calibrate_seconds=0.2, n_trials=3)
    rows, checks, members = [], [], set()
    for name in ELLG_MATS:
        t0 = time.perf_counter()
        st = ellg.convert(mats[name], cfg)
        print(f"ellg convert {name}: {time.perf_counter() - t0:.2f} s, "
              f"{json.dumps(ellg.report_fields(st, cfg))}", flush=True)
        members |= {p.m for p in st.passes}
        x = torch.from_numpy(create_random_vector(
            mats[name].n_col, dtype=np.float32)).to(dev)
        r, per_pass = compare_ellg(f"{name} ellg", st.to(dev), ellg, bops,
                                   x)
        rows.append(r)
        checks += per_pass
        del st
    if 1 not in members or not members - {1}:
        raise SystemExit(f"ellg stand-ins {ELLG_MATS} plan m in "
                         f"{sorted(members)}: not both m = 1 and m > 1")
    _zero(*wrappers)
    run_path({n: mats[n] for n in ELLG_MATS}, run_cfg, run_benchmark,
             ("Levels", "RestFormat", "RestNnz", "PadFactor"), dev,
             rest=("BKT_G", "CSR", "NONE"))
    launched = count_path("campaign ellg", wrappers, (
        "ellg_rows", "bucket_fused_rows"))["block_gather_mul"]
    _zero(*wrappers)
    for fmt in NEW_FORMATS:
        rep = run_path({"raefsky3": mats["raefsky3"]},
                       run_cfg.replace(format=fmt), run_benchmark,
                       ("Architecture", "PreferredDevice", "Library"),
                       dev)["raefsky3"]
        on_host = (rep["Architecture"] == "CPU"
                   and rep.get("PreferredDevice") == "cpu")
        if on_host != (fmt == "hostlib"):
            raise SystemExit(f"{fmt}: ran on {rep['Architecture']}")
    count_path("campaign formats", wrappers, ())
    _zero(*wrappers)
    run_campaign_tools(mats, dev, card)
    count_path("campaign tools", wrappers, ("ellg_rows",))
    return rows, checks, launched


SOLVER_GRID = 100        # the solver phase's grids: 100³ unknowns, 6.94 M
#                          nonzeros, the size of a 3D solve users run
SOLVER_PECLET = 10.0     # (b)'s cell Péclet number along x
SOLVER_WINDOW_S = 0.05   # each timed run of the phase's chained timings
F32_RESIDUAL = 10        # float32: the true residual within this many
#                          tol·‖b‖ (recurrence and true residual drift apart
#                          by rounding)
SPTRSV_TOL = 1e-10       # (e) against scipy, of max|y|
SPGEMM_TOL = 1e-12       # (d) against scipy, of max|C|


def grid_operator(n, peclet=0.0):
    """The 7-point operator on an n³ grid with Dirichlet boundaries: −Δ
    (``peclet`` 0: SPD), or −Δ plus first-order upwind convection along x
    at cell Péclet number ``peclet`` (nonsymmetric, an M-matrix)."""
    from singlespmv_tpu_torch.core.types import COOMatrix

    idx = np.arange(n ** 3).reshape(n, n, n)     # x the fastest index
    rows, cols = [idx.ravel()], [idx.ravel()]
    vals = [np.full(n ** 3, 6.0 + peclet)]
    for axis in range(3):
        lo = np.take(idx, np.arange(n - 1), axis=axis).ravel()
        hi = np.take(idx, np.arange(1, n), axis=axis).ravel()
        upwind = peclet if axis == 2 else 0.0
        rows += [hi, lo]
        cols += [lo, hi]
        vals += [np.full(lo.size, -1.0 - upwind), np.full(lo.size, -1.0)]
    return COOMatrix.from_triplets(n ** 3, n ** 3, np.concatenate(rows),
                                   np.concatenate(cols), np.concatenate(vals))


def dominant(coo):
    """``coo`` with each row's diagonal set to the sum of |a_ij| over its
    other entries, plus 1: strictly diagonally dominant."""
    from singlespmv_tpu_torch.core.types import COOMatrix

    off = coo.row != coo.col
    r, c, v = coo.row[off], coo.col[off], coo.val[off]
    d = np.bincount(r, weights=np.abs(v), minlength=coo.n_row) + 1.0
    i = np.arange(coo.n_row)
    return COOMatrix.from_triplets(coo.n_row, coo.n_col,
                                   np.concatenate([r, i]),
                                   np.concatenate([c, i]),
                                   np.concatenate([v, d]))


def chained_seconds(fn, first, arg, dev, name):
    """Seconds per call of ``fn(first, arg)``: the driver's trials
    (``median_seconds`` of 3 marginals) over replays of a CUDA graph of one
    call, the loop doubled until a run lasts ``SOLVER_WINDOW_S``."""
    from singlespmv_tpu_torch.harness import driver as hdriver

    timed = hdriver.runner_clock(hdriver.make_chained_runner(
        fn, first, arg, name=name, chain=1), dev)
    loop = hdriver.calibrate_loop(timed, SOLVER_WINDOW_S, 1 << 12)
    return hdriver.median_seconds(timed, loop, 3)


def report_solve(label, res, coo, b, tol, bound, make_loop, maxiter, M,
                 cfg, dev, card):
    """Holds a solve to its bound and prints its timings: the true residual
    ‖b − A x‖ from the float64 COO oracle must be within ``bound``·tol·‖b‖;
    beside the solve's own seconds, one spmv's chained Time(s) on its
    state, one preconditioner apply on a chained runner, and the same
    solve run again eagerly (the chunk function without capture).  Returns
    the printed row."""
    from singlespmv_tpu_torch.core import reference_spmv
    from singlespmv_tpu_torch.formats import spmv_fn
    from singlespmv_tpu_torch.harness.driver import marginal_seconds

    bn = float(np.linalg.norm(b))
    true = float(np.linalg.norm(
        b - reference_spmv(coo, res.x.astype(np.float64))))
    info = res.info
    print(f"solver {label}: {info['format']} iterations {res.iterations} "
          f"converged {res.converged} residual {res.residual:.6g} (the "
          f"recurrence's) true {true:.6g} bound {bound * tol * bn:.6g}",
          flush=True)
    if not (res.converged and np.isfinite(res.x).all()
            and true <= bound * tol * bn):
        raise SystemExit(f"solver {label}: not converged or the true "
                         f"residual {true:.3g} is past {bound}·tol·‖b‖")
    spmv = spmv_fn(cfg)
    bd = torch.from_numpy(b.astype(cfg.np_dtype)).to(dev)
    spmv_s = marginal_seconds(spmv, res.state, bd, dev, SOLVER_WINDOW_S,
                              name=f"{label} spmv")
    m_s = None if M is None else chained_seconds(
        lambda m, v: m(v), M, bd, dev, f"{label} M")
    loop = make_loop(spmv, res.state, bd, tol=tol, maxiter=maxiter, M=M)
    eager = loop.run_eager(info["chunk"])
    eager_it = int(loop.carry["it"])
    run = info["chunks"] * info["chunk"]
    row = {"solve": label, "card": card, "format": info["format"],
           "iterations": res.iterations, "residual": res.residual,
           "true_residual": true, "tol_bnorm": tol * bn,
           "convert_s": info["convert_s"], "wall_s": info["wall_s"],
           "capture_s": info.get("capture_s"), "replay_s": info["loop_s"],
           "replay_s_per_iter": info["loop_s"] / max(res.iterations, 1),
           "replay_s_per_run_iter": info["loop_s"] / max(run, 1),
           "chunk": info["chunk"], "replays": info["chunks"],
           "graph_nodes": info.get("graph_nodes"),
           "graph_nodes_est": info["chunk"] * info["nodes_per_iter_est"],
           "spmv_time_s": spmv_s, "m_apply_s": m_s,
           "eager_s": eager["loop_s"],
           "eager_s_per_iter": eager["loop_s"] / max(eager_it, 1),
           "eager_iterations": eager_it,
           "eager_x_rel_diff": float(np.abs(
               loop.carry["x"].cpu().numpy() - res.x).max()
               / max(np.abs(res.x).max(), 1e-300))}
    print(f"solver {label}: wall {row['wall_s']:.3f} s (capture "
          f"{row['capture_s']} s), replays {row['replay_s']:.3f} s = "
          f"{row['replay_s_per_iter'] * 1e3:.4f} ms an iteration, "
          f"{row['replays']} replays of {row['chunk']} iterations, graph "
          f"{row['graph_nodes']} nodes (estimate "
          f"{row['graph_nodes_est']}); spmv Time(s) "
          f"{spmv_s * 1e6:.2f} us; M apply "
          f"{'-' if m_s is None else f'{m_s * 1e3:.4f} ms'} (chained); "
          f"eager {row['eager_s']:.3f} s = "
          f"{row['eager_s_per_iter'] * 1e3:.4f} ms an iteration, "
          f"{eager_it} iterations", flush=True)
    print(f"solver_row {json.dumps(row)}", flush=True)
    return row


def run_solvers(mats, dev, card, count_path, wrappers, n=SOLVER_GRID):
    """Phase "solvers": (a) CG with and without IC(0) in float64 on the
    Poisson matrix (slab), (b) BiCGStab with ILU(0) in float32 on the
    convection–diffusion matrix (slab), (c) BiCGStab in float32 under the
    solvers' default cfg (auto) on ASIC_680ks made strictly diagonally
    dominant, (d) SpGEMM g7jac200sc · g7jac200sc in float64 against scipy,
    (e) SpTRSV with (a)'s IC(0) factor L and Lᵀ against scipy;
    ``count_path`` reads the launches of ``wrappers`` after each solve."""
    import scipy.sparse as sp
    from scipy.sparse.linalg import spsolve_triangular

    from singlespmv_tpu_torch import Config
    from singlespmv_tpu_torch.ops import ilu, solvers, spgemm, sptrsv

    rng = np.random.default_rng(0)
    rows = []
    pois = grid_operator(n)
    b = rng.uniform(-1.0, 1.0, pois.n_row)
    cfg64 = Config(format="slab", dtype="float64", verify=False)
    t0 = time.perf_counter()
    M = ilu.ic0_preconditioner(pois, cfg64, device=dev)
    print(f"solver (a): {n}³ Poisson, nnz {pois.nnz}; IC(0) and its plans "
          f"{time.perf_counter() - t0:.2f} s, levels {M.l_plan.n_levels} / "
          f"{M.u_plan.n_levels}, rows a level {M.l_plan.rows_per_level}, "
          f"apply estimate {M.graph_nodes} operations", flush=True)
    its = {}
    for label, m in (("(a) cg f64", None), ("(a) cg+ic0 f64", M)):
        _zero(*wrappers)
        res = solvers.cg(pois, b, cfg=cfg64, tol=1e-8, maxiter=2000, M=m,
                         device=dev)
        count_path(f"solvers {label}", wrappers, ("slab_spmv_rows_f64",))
        rows.append(report_solve(label, res, pois, b, 1e-8, 1.001,
                                 solvers.cg_loop, 2000, m, cfg64, dev, card))
        its[label] = res.iterations
        del res
    if not its["(a) cg+ic0 f64"] < its["(a) cg f64"]:
        raise SystemExit(f"solver (a): IC(0) took no fewer iterations {its}")

    # (e) SpTRSV alone on (a)'s factor, against scipy
    L = ilu.ic0(pois)
    Lc = sp.csr_matrix((L.val, (L.row, L.col)), shape=(L.n_row, L.n_col))
    bt = rng.uniform(-1.0, 1.0, L.n_row)
    btd = torch.from_numpy(bt).to(dev)
    for label, plan, mat in (("L", M.l_plan, Lc), ("Lt", M.u_plan,
                                                    Lc.T.tocsr())):
        y = sptrsv.solve(plan, btd).cpu().numpy()
        t0 = time.perf_counter()
        want = spsolve_triangular(mat, bt, lower=plan.lower)
        host_s = time.perf_counter() - t0
        rel = float(np.abs(y - want).max() / np.abs(want).max())
        sec = chained_seconds(sptrsv.solve, plan, btd, dev, f"sptrsv {label}")
        print(f"sptrsv (e) {label} lower={plan.lower} ({card}): levels "
              f"{plan.n_levels}, rows a level {plan.rows_per_level}, k "
              f"{plan.k}; rel_err {rel:.3g} against scipy (its "
              f"{host_s:.2f} s on the host); a solve {sec * 1e3:.4f} ms "
              f"chained, {sec / plan.n_levels * 1e6:.3f} us a level",
              flush=True)
        if not rel <= SPTRSV_TOL:
            raise SystemExit(f"sptrsv {label}: {rel:.3g} off scipy")
    del M, L, Lc

    conv = grid_operator(n, SOLVER_PECLET)
    cfg32 = Config(format="slab", dtype="float32", verify=False)
    t0 = time.perf_counter()
    M = ilu.ilu0_preconditioner(conv, cfg32, device=dev)
    print(f"solver (b): {n}³ convection–diffusion, Péclet {SOLVER_PECLET} "
          f"along x, nnz {conv.nnz}; ILU(0) and its plans "
          f"{time.perf_counter() - t0:.2f} s, levels {M.l_plan.n_levels} / "
          f"{M.u_plan.n_levels}", flush=True)
    _zero(*wrappers)
    res = solvers.bicgstab(conv, b, cfg=cfg32, tol=1e-5, maxiter=1000, M=M,
                           device=dev)
    count_path("solvers (b) bicgstab+ilu0 f32", wrappers,
               ("slab_spmv_rows",))
    rows.append(report_solve("(b) bicgstab+ilu0 f32", res, conv, b, 1e-5,
                             F32_RESIDUAL, solvers.bicgstab_loop, 1000, M,
                             cfg32, dev, card))
    del res, M, conv

    asic = dominant(mats["ASIC_680ks"])
    b3 = rng.uniform(-1.0, 1.0, asic.n_row)
    _zero(*wrappers)
    res = solvers.bicgstab(asic, b3, tol=1e-5, device=dev)
    got = count_path("solvers (c) bicgstab auto f32", wrappers, ())
    print(f"solver (c): ASIC_680ks, diagonal Σ|a_ij| + 1; ChosenFormat "
          f"{res.state.chosen}; launches {json.dumps({k: v for k, v in got.items() if v})}",
          flush=True)
    rows.append(report_solve(
        "(c) bicgstab auto f32", res, asic, b3, 1e-5, F32_RESIDUAL,
        solvers.bicgstab_loop, 1000, None,
        Config(format="auto", dtype="float32", verify=False), dev, card))
    del res

    # (d) SpGEMM against scipy: the same pattern, values within SPGEMM_TOL
    g7 = mats["g7jac200sc"]
    t0 = time.perf_counter()
    c = spgemm.spgemm_coo(g7, g7, Config(dtype="float64"), device=dev)
    sec = time.perf_counter() - t0
    A = sp.csr_matrix((g7.val, (g7.row, g7.col)), shape=(g7.n_row, g7.n_col))
    ref = (A @ A).tocoo()
    order = np.lexsort((ref.col, ref.row))
    same = (c.nnz == ref.nnz and np.array_equal(c.row, ref.row[order])
            and np.array_equal(c.col, ref.col[order]))
    rel = float(np.abs(c.val - ref.data[order]).max()
                / np.abs(ref.data).max()) if same else float("inf")
    print(f"spgemm (d) g7jac200sc²: nnz {c.nnz} (scipy {ref.nnz}), pattern "
          f"{'equal' if same else 'DIFFERS'}, rel_err {rel:.3g}; "
          f"{sec:.2f} s with the host's grouping", flush=True)
    if not (same and rel <= SPGEMM_TOL):
        raise SystemExit("spgemm (d): off scipy's A @ A")
    return rows


BF16_KERNEL_STATES = (("g7jac200sc", "slab"), ("torso1", "slab"),
                      ("webbase-1M", "xch"), ("thermomech_dK", "bkt_g"),
                      ("raefsky3", "bkt"), ("webbase-1M", "csr5"),
                      ("thermomech_dK", "css"))   # the timed rows' states
BF16_EXTRA = (("webbase-1M", "xch"),)   # states whose whole spmv is timed
BF16_FORMATS = ("slab", "xch", "hyb", "bkt", "ellg", "ss", "csr5", "css",
                "csr")    # driven on raefsky3
BF16_KERNELS = ("slab_spmv_rows_bf16", "xch_fused_rows_bf16",
                "bucket_fused_rows_bf16",
                "ellg_rows_bf16", "segmented_scan_tiles_bf16",
                "block_gather_scan_bf16")
AUTO_TRIAL_WINDOW_S = 0.1    # auto's trial window in the auto paths here
#                              (its default 0.35 s is the headline's): the
#                              depth cut that made room for phase bfloat16
BF16_TRIAL_WINDOW_S = 0.05   # and in phase bfloat16, to keep it near 90 s


class TrialWindow:
    """Sets ``auto.TRIAL_WINDOW_S`` for a block, says so, and puts it
    back: the smoke's auto trials time shorter loops than the headline's,
    so its choices are noisier."""

    def __init__(self, seconds):
        self.seconds = seconds

    def __enter__(self):
        from singlespmv_tpu_torch.formats import auto

        self.was, auto.TRIAL_WINDOW_S = auto.TRIAL_WINDOW_S, self.seconds
        print(f"auto trials here: {self.seconds} s a timed loop (the "
              f"headline's {self.was} s)", flush=True)

    def __exit__(self, *exc):
        from singlespmv_tpu_torch.formats import auto

        auto.TRIAL_WINDOW_S = self.was


def as_bfloat16(state):
    """``state`` with its floating tensors, the values, rounded to
    bfloat16 (to nearest, as ``round_values`` rounds a float32 value), the
    nested states' too.  A float32 state's layout, routes included, does
    not depend on the value type, since the accumulator stays float32:
    for slab, xch, bkt, csr5 and css this is the state the bfloat16
    convert builds under the same plan, field for field."""
    def cast(v):
        if isinstance(v, torch.Tensor):
            return v.to(torch.bfloat16) if v.is_floating_point() else v
        if isinstance(v, tuple):
            return tuple(cast(a) for a in v)
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            return as_bfloat16(v)
        return v

    return dataclasses.replace(state, **{
        f.name: cast(getattr(state, f.name))
        for f in dataclasses.fields(state)})


def bf16_library(a_csr, x):
    """``a_csr`` where one bfloat16 CSR product ``a_csr @ x`` runs on the
    card (cuSPARSE), else (None, the error torch raised)."""
    try:
        a_csr @ x
        torch.cuda.synchronize()
        return a_csr, None
    except RuntimeError as e:
        msg = str(e).strip().splitlines()[0][:200]
        print(f"bfloat16 A_csr @ x: torch refuses it: {msg}", flush=True)
        return None, msg


def run_bfloat16(mats, dev, card, count_path, wrappers, f32_states):
    """Phase "bfloat16" (ROADMAP A.10): (a) each bfloat16 kernel against
    its plain version on the states of the float32 checks
    (``BF16_KERNEL_STATES``, taken from ``f32_states`` through
    ``as_bfloat16``: per call at ``TOL``, as the float32 kernels are; the
    whole-call times on ``BF16_EXTRA`` only), and two calls of the whole
    bfloat16 spmv (kernels, y rounded once) within each row's reorder
    bound of each other (float32 accumulator, bfloat16 output), the first
    through the bfloat16 oracle; (b) ``run_benchmark`` at bfloat16 through
    auto on the six ``DRIVER_RUNS`` stand-ins and through ``BF16_FORMATS``
    on raefsky3, each to a Verify PASS, printing the chained Time(s) and
    GFLOPS beside the float32 run of the same stand-in and format where
    this smoke made one; fails where a path launched no bfloat16 kernel of
    ``BF16_KERNELS`` or any float32 or float64 kernel (a bfloat16 call
    never widens to another kernel).  Returns (the comparison results, the
    launch counts of (b))."""
    from singlespmv_tpu_torch import Config
    from singlespmv_tpu_torch.core import create_random_vector, verify_result
    from singlespmv_tpu_torch.core.dtypes import (round_values, to_host,
                                                  value_tensor)
    from singlespmv_tpu_torch.core.types import COOMatrix
    from singlespmv_tpu_torch.formats import bkt, csr5, css, ellg, slab, xch
    from singlespmv_tpu_torch.harness import run_benchmark
    from singlespmv_tpu_torch.ops import bucket as bops
    from singlespmv_tpu_torch.ops import slab as ops
    from singlespmv_tpu_torch.ops import xch as xops

    cfg = Config(format="slab", dtype="bfloat16")
    mods = {"slab": slab, "xch": xch, "bkt": bkt, "bkt_g": bkt,
            "csr5": csr5, "css": css}
    compared, csrs = [], {}
    t0 = time.perf_counter()
    for name, fmt in BF16_KERNEL_STATES:
        t1 = time.perf_counter()
        coo, mod = mats[name], mods[fmt]
        fcfg = cfg.replace(format="bkt", bkt_row_group=1024
                           if fmt == "bkt_g" else 128) \
            if fmt.startswith("bkt") else cfg.replace(format=fmt)
        st = as_bfloat16(f32_states.pop((name, fmt)))
        xh = round_values(create_random_vector(coo.n_col), "bfloat16")
        x = value_tensor(xh, "bfloat16").to(dev)
        if name not in csrs:
            csrs[name] = bf16_library(torch_csr(coo, dev, "bfloat16"), x)
        a_csr, lib_err = csrs[name]
        label = f"{name} {fmt}"
        extra = (name, fmt) in BF16_EXTRA
        stored = COOMatrix(coo.n_row, coo.n_col, coo.row, coo.col,
                           round_values(coo.val, "bfloat16"))
        if fmt == "slab":
            res = compare_kernel(name, st, slab, ops, x, a_csr=a_csr,
                                 extra=extra)
        elif fmt == "xch":
            res = compare_xch(name, st, xch, xops, x, a_csr=a_csr,
                              extra=extra, coo=stored)
        elif fmt.startswith("bkt"):
            res = compare_bucket(label, st, bkt, bops, x, a_csr=a_csr,
                                 extra=extra)
        else:
            res = compare_scan(label, st, mod, x, extra=extra)
        if lib_err is not None:
            res["library_error"] = lib_err
        # the whole spmv twice on the card; values as the state stores them
        y1, y2 = (to_host(mod.spmv(st, x)) for _ in range(2))
        within, worst = reorder_check(stored, st, fcfg, xh, y1, y2)
        ok = verify_result(coo, xh, y1, dtype="bfloat16")[0]
        res["reorder_worst_share"] = worst
        print(f"bfloat16 {label} ({time.perf_counter() - t1:.1f} s): two "
              f"spmv calls, worst row at {worst:.3g} of its reorder bound; "
              f"Verify {['FAIL', 'PASS'][ok]}", flush=True)
        if not (within and ok):
            raise SystemExit(f"bfloat16 {label}: two calls of the spmv "
                             "differ past a row's reorder bound, or fail "
                             "the oracle")
        compared.append(res)
        del st
    # ellg's passes kernel at bfloat16, on raefsky3's ellg state converted
    # at bfloat16 (the first port's stage A checked per pass at float32)
    t1 = time.perf_counter()
    st = ellg.convert(mats["raefsky3"], cfg.replace(format="ellg")).to(dev)
    xh = round_values(create_random_vector(mats["raefsky3"].n_col),
                      "bfloat16")
    res, _ = compare_ellg("raefsky3 ellg", st, ellg, bops,
                          value_tensor(xh, "bfloat16").to(dev),
                          per_pass=False)
    compared.append(res)
    print(f"bfloat16 raefsky3 ellg ({time.perf_counter() - t1:.1f} s)",
          flush=True)
    del st
    print(f"bfloat16 (a): {time.perf_counter() - t0:.1f} s", flush=True)
    # (b) the bfloat16 paths through run_benchmark
    t0 = time.perf_counter()
    _zero(*wrappers)
    run_cfg = Config(format="auto", dtype="bfloat16", calibrate_seconds=0.05,
                     n_trials=2)
    with TrialWindow(BF16_TRIAL_WINDOW_S):
        runs = [(n, "auto") for n, _ in DRIVER_RUNS] + [
            ("raefsky3", f) for f in BF16_FORMATS]
        for name, fmt in runs:
            rcfg = run_cfg.replace(format=fmt)
            t1 = time.perf_counter()
            rep = run_path({name: mats[name]}, rcfg, run_benchmark,
                           ("ChosenFormat",), dev)[name]
            f32 = RUNS.get((name, fmt, "float32"))
            print("bf16_row " + json.dumps({
                "matrix": name, "format": fmt,
                "chosen": rep.get("ChosenFormat"), "verify": rep["Verify"],
                "time_s": rep["Time(s)"],
                "gflops": rep["Performance(GFLOPS)"],
                "f32_time_s": f32 and f32["Time(s)"],
                "f32_gflops": f32 and f32["GFLOPS"],
                "f32_chosen": f32 and f32["chosen"],
                "optimize_s": rep["OptimizeTime(s)"],
                "trial_window_s": BF16_TRIAL_WINDOW_S,
                "seconds": round(time.perf_counter() - t1, 1),
                "card": card}), flush=True)
    print(f"bfloat16 (b): {time.perf_counter() - t0:.1f} s", flush=True)
    got = count_path("bfloat16", wrappers, BF16_KERNELS)
    wide = {k: v for k, v in got.items() if v and not k.endswith("_bf16")}
    if wide:
        raise SystemExit(f"bfloat16: a float32 or float64 kernel ran: {wide}")
    return compared, got


BF16_SPMM_B = 8          # the bfloat16 spmm_fn path's panels
BF16_SPMM_PATH = (("g7jac200sc", "slab"), ("webbase-1M", "xch"),
                  ("Chebyshev4", "hyb"), ("unbalance-16384", "bsr"),
                  ("g7jac200sc", "csr"))
BF16_SPMM_AUTO = ("webbase-1M", "g7jac200sc")   # two driver stand-ins
BF16_PANEL_CHECKS = ((("g7jac200sc", "slab"), SLAB_PANEL_B),
                     (("webbase-1M", "xch"), XCH_PANEL_B),
                     (("ASIC_680ks", "xch"), XCH_PANEL_B))
# the timed checks: the stand-in and B of the float32 kernel line's
BF16_PANEL_TIMED = {("g7jac200sc", "slab"): 32, ("webbase-1M", "xch"): 16}
BF16_PANEL_KERNELS = tuple(k + "_bf16" for k in PANEL_KERNELS)
SPMM_F32_US = {}   # (stand-in, B) → phase 3's chained µs of the f32 spmm


class PlainPanels:
    """Sets the format modules' three panel wrappers to their plain
    versions for a block, so that ``spmm`` on the card's tensors gives the
    plain Y beside the kernels' Y; puts them back after."""

    def __enter__(self):
        from singlespmv_tpu_torch.formats import slab, xch
        from singlespmv_tpu_torch.ops import slab as ops
        from singlespmv_tpu_torch.ops import xch as xops

        self.was = (slab.slab_spmm, xch.xch_mul_panel, xch.xch_route4_panel)
        slab.slab_spmm = ops.slab_spmm_ref
        xch.xch_mul_panel = xops.xch_mul_panel_ref
        xch.xch_route4_panel = xops.xch_route4_panel_ref

    def __exit__(self, *exc):
        from singlespmv_tpu_torch.formats import slab, xch

        slab.slab_spmm, xch.xch_mul_panel, xch.xch_route4_panel = self.was


def _torch_bounds():
    """``tests/torch_bounds.py`` of this checkout: the proven accuracy
    bound of the port's bfloat16 products, which the CPU tests hold the
    port to (it imports only the port)."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    import torch_bounds

    return torch_bounds


def bf16_panel_bounds(stored, Xh, state, fmt, xmax):
    """(n_row, B): ``tests/torch_bounds.py:accuracy_bound``'s rule for each
    column of a bfloat16 Y, with the prefix mass M_i taken once, at the
    entrywise max|X| over the state's panels (``xmax``, float64), which
    bounds every column's M_i from above.  Returns (the float64 oracle of
    the stored values, the bounds)."""
    from singlespmv_tpu_torch.core.oracle import reference_spmv, ulp

    tb = _torch_bounds()
    up = tb.U_BF16 if tb.rounds_products(state, fmt) else 0.0
    t = 2.0 * tb.gamma(tb.PREFIX_ADDS) * (1.0 + up) * tb.prefix_mass(
        state, fmt, torch.from_numpy(xmax))
    g = tb.gamma(stored.row_lengths())
    rs, bs = [], []
    for b in range(Xh.shape[1]):
        xh = Xh[:, b].astype(np.float64)
        s = np.bincount(stored.row, weights=np.abs(stored.val * xh[
            stored.col]), minlength=stored.n_row)
        r = reference_spmv(stored, xh)
        e = up * s + t + g * ((1.0 + up) * s + t)
        rs.append(r)
        bs.append(e + 0.5 * ulp("bfloat16", np.abs(r) + e))
    return np.stack(rs, 1), np.stack(bs, 1)


def run_spmm_bfloat16(mats, coos, held, dev, card, count_path, wrappers):
    """Phase "spmm bfloat16" (ROADMAP A.10b).  States come from phases 2
    and 3 (``held``: (stand-in, format) → float32 state on the card)
    through ``as_bfloat16``; the others (csr, hyb) are converted at
    bfloat16.  (a) The path, counted: ``spmm_fn`` at bfloat16 and
    ``BF16_SPMM_B`` on ``BF16_SPMM_PATH`` and auto with ``spmm_b`` = 8 on
    ``BF16_SPMM_AUTO`` (estimates, trials, pick), every Y through
    ``verify_result(dtype=bfloat16)`` column by column; fails unless the
    three ``*_bf16`` panel builds launched and no other build did.  (b) The
    panel kernels, not counted: on ``BF16_PANEL_CHECKS`` each kernel call
    against its plain version (at ``TOL`` of max|out|, float32 outs; the
    products equal), every column of the kernels' Y and of the plain Y
    (``PlainPanels``) within ``bf16_panel_bounds`` of the oracle of the
    stored values, two calls of the kernels' Y within each row's
    ``reorder_bound``; the checks at ``BF16_PANEL_TIMED`` timed, and a row
    printed per kernel: busy µs against the bound, the chained spmm µs at
    B 8 beside phase 3's float32 one, torch's bfloat16 CSR ``A @ X``.
    Returns the comparison results."""
    from singlespmv_tpu_torch import Config
    from singlespmv_tpu_torch.core import verify_result
    from singlespmv_tpu_torch.core.dtypes import round_values, to_host
    from singlespmv_tpu_torch.core.oracle import reorder_bound
    from singlespmv_tpu_torch.core.types import COOMatrix
    from singlespmv_tpu_torch.formats import (adds_per_row, auto, get_format,
                                              slab, spmm_fn, xch)
    from singlespmv_tpu_torch.harness.driver import marginal_seconds
    from singlespmv_tpu_torch.ops import slab as ops
    from singlespmv_tpu_torch.ops import xch as xops

    cfg = Config(format="slab", dtype="bfloat16")
    rng = np.random.default_rng(19)

    def coo_of(name):
        return coos.get(name) or mats[name]

    def panel(name, n_cols):
        Xh = round_values(rng.uniform(-1.0, 1.0, (coo_of(name).n_col,
                                                  n_cols)), "bfloat16")
        return Xh, torch.from_numpy(Xh).to(dev, torch.bfloat16)

    states = {}
    for name, fmt in BF16_SPMM_PATH + tuple(k for k, _ in BF16_PANEL_CHECKS):
        if (name, fmt) in states:
            continue
        t0 = time.perf_counter()
        if (name, fmt) in held:
            states[name, fmt] = as_bfloat16(held[name, fmt])
            how = "rounded from float32"
        else:
            states[name, fmt] = get_format(fmt).convert(
                coo_of(name), cfg.replace(format=fmt)).to(dev)
            how = "converted at bfloat16"
        torch.cuda.synchronize()
        print(f"spmm bfloat16 state {name} {fmt}: {how} in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
    # (a) the path through spmm_fn and auto, counted
    _zero(*wrappers)
    for name, fmt in BF16_SPMM_PATH:
        st = states[name, fmt]
        Xh, X = panel(name, BF16_SPMM_B)
        Y = spmm_fn(cfg.replace(format=fmt))(st, X)
        if Y.dtype != torch.bfloat16:
            raise SystemExit(f"spmm bfloat16 {name} {fmt}: Y is {Y.dtype}")
        err = verify_columns(f"spmm bfloat16 {name} {fmt}", coo_of(name), X,
                             Y, verify_result, "bfloat16")
        print(f"spmm bfloat16 {name} {fmt} B{BF16_SPMM_B}: Verify: PASS "
              f"({BF16_SPMM_B} columns) max_abs_err {err}", flush=True)
    acfg = Config(format="auto", dtype="bfloat16", spmm_b=BF16_SPMM_B)
    with TrialWindow(BF16_TRIAL_WINDOW_S):
        for name in BF16_SPMM_AUTO:
            t0 = time.perf_counter()
            st = auto.convert(mats[name], acfg, device=dev).to(dev)
            rep = auto.report_fields(st, acfg)
            print(f"auto spmm_b={BF16_SPMM_B} bfloat16 {name} "
                  f"({time.perf_counter() - t0:.1f} s): " + " ".join(
                      f"{k}: {rep[k]}" for k in (
                          "ChosenFormat", "AutoEstimates(us)",
                          "AutoTrials(us)", "AutoFailed")), flush=True)
            check_auto({name: rep})
            Xh, X = panel(name, BF16_SPMM_B)
            err = verify_columns(f"auto spmm bfloat16 {name}", mats[name], X,
                                 auto.spmm(st, X), verify_result, "bfloat16")
            print(f"auto spmm_b={BF16_SPMM_B} bfloat16 {name}: Verify: PASS "
                  f"({BF16_SPMM_B} columns) max_abs_err {err}", flush=True)
            del st
    got = count_path("spmm bfloat16", wrappers, BF16_PANEL_KERNELS)
    wide = {k: v for k, v in got.items() if v and not k.endswith("_bf16")}
    if wide:
        raise SystemExit(f"spmm bfloat16: a float32 or float64 kernel ran: "
                         f"{wide}")
    # (b) the panel kernels against their plain versions, not counted
    compared, rows = [], []
    for (name, fmt), widths in BF16_PANEL_CHECKS:
        t0 = time.perf_counter()
        coo, st = coo_of(name), states[name, fmt]
        mod = slab if fmt == "slab" else xch
        fcfg = cfg.replace(format=fmt)
        stored = COOMatrix(coo.n_row, coo.n_col, coo.row, coo.col,
                           round_values(coo.val, "bfloat16"))
        panels = {n_cols: panel(name, n_cols) for n_cols in widths}
        xmax = np.max([np.abs(Xh).max(axis=1) for Xh, _ in panels.values()],
                      axis=0).astype(np.float64)
        adds = adds_per_row(st, fcfg)
        a_csr, lib_err = bf16_library(torch_csr(coo, dev, "bfloat16"),
                                      panels[widths[0]][1])
        for n_cols in widths:
            Xh, X = panels[n_cols]
            label = f"{name} B{n_cols}"
            timed = BF16_PANEL_TIMED.get((name, fmt)) == n_cols
            if fmt == "slab":
                res = compare_slab_spmm(label, st, slab, ops, X, a_csr,
                                        timed=timed)
            else:
                res = compare_xch_panels(label, st, xch, xops, X, a_csr,
                                         timed=timed)
            y1, y2 = (to_host(mod.spmm(st, X)).astype(np.float64)
                      for _ in range(2))
            with PlainPanels():
                yp = to_host(mod.spmm(st, X)).astype(np.float64)
            r, bound = bf16_panel_bounds(stored, Xh, st, fmt, xmax)
            share = max(float(np.max(np.abs(y - r) / bound))
                        for y in (y1, yp))
            drift = np.abs(y1 - y2)
            reorder = max(float(np.max(drift[:, b] / np.maximum(
                reorder_bound(stored, Xh[:, b].astype(np.float64), adds,
                              "float32", "bfloat16"), 1e-300), initial=0.0))
                          for b in range(n_cols))
            res |= {"accuracy_worst_share": share,
                    "reorder_worst_share": reorder}
            if lib_err is not None:
                res["library_error"] = lib_err
            print(f"spmm bfloat16 {label} {fmt}: kernels' and plain Y, worst "
                  f"column entry at {share:.3g} of its accuracy bound; two "
                  f"calls at {reorder:.3g} of the reorder bound", flush=True)
            if not (share <= 1.0 and reorder <= 1.0):
                raise SystemExit(f"spmm bfloat16 {label}: a Y left its "
                                 "accuracy bound, or two calls differ past "
                                 "the reorder bound")
            compared.append(res)
            if timed:
                Xh8, X8 = panel(name, BF16_SPMM_B)
                us = 1e6 * marginal_seconds(spmm_fn(fcfg), st, X8, dev,
                                            SPMM_WINDOW_S)
                for k in (("slab_spmm",) if fmt == "slab"
                          else ("xch_mul_panel", "xch_route4_panel")):
                    t = res if fmt == "slab" else res[k]
                    rows.append({
                        "kernel": k + "_bf16", "label": label,
                        "busy_us": t["ms"] * 1e3,
                        "bound_us": t["bound_ms"] * 1e3,
                        "bound_by": t["bound_by"],
                        "busy_from": "events" if isinstance(
                            t["ms"], EventsMs) else "trace",
                        f"spmm_B{BF16_SPMM_B}_bf16_us": us,
                        f"spmm_B{BF16_SPMM_B}_f32_us": SPMM_F32_US.get(
                            (name, BF16_SPMM_B)),
                        "torch_bf16_csr_us": "none" if t["library_ms"] is None
                        else t["library_ms"] * 1e3,
                        "card": card})
        print(f"spmm bfloat16 checks {name} {fmt}: "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        del a_csr
    for row in rows:
        print("spmm_bf16_row " + json.dumps(row), flush=True)
    _zero(*wrappers)      # the checks' launches count in no path
    return compared


PAR_BAND = 1_048_576     # (a)'s band: generate("band", PAR_BAND, 9, seed=2)
PAR_SPMM_B = 8           # DistXch.spmm's panel on webbase-1M
PAR_WINDOW_S = 0.05      # each timed run of a step's chained timing
PAR_WEAK_ROWS = 65_536   # (c)'s band: rows a shard (weak), 4 shards' (strong)
PAR_NCCL_TIMEOUT_S = 240
PAR_NCCL_MATRIX = (100_000, 1_000_000)   # (e): powerlaw(n, nnz, seed=4)


def compare_stacked_scan(label, prod, heads, tol):
    """Phase "parallel" (b): ``segmented_scan_tiles`` against its plain
    version on a distributed operator's stacked stream (every shard's
    products, as the step scans them in one call), timed beside its bound
    as ``compare_scan`` times it."""
    from singlespmv_tpu_torch.ops import segscan as sops

    got = sops.segmented_scan_tiles(prod, heads)
    want = sops.segmented_scan_tiles_ref(prod, heads)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    rel = err / max(float(want.abs().max()), 1e-30)
    del got, want
    h, w = prod.shape
    res = {
        "label": label, "dtype": str(prod.dtype),
        "kernel": "segmented_scan_tiles" + SFX[prod.dtype],
        "stream": [h, w], "max_abs_err": err, "rel_err": rel,
        "ms": _busy_ms(lambda: sops.segmented_scan_tiles(prod, heads),
                       "segscan_kernel",
                       launches=_launched(sops.segmented_scan_tiles)),
        "plain_ms": _busy_ms(
            lambda: sops.segmented_scan_tiles_ref(prod, heads)),
        "library_ms": None,
    } | _bound(_nbytes(prod, heads) + prod.numel() * prod.element_size(),
               h * w, prod.dtype)
    print(f"kernel {label}: {json.dumps(_marked(res))}", flush=True)
    if not rel <= tol:
        raise SystemExit(f"{label} segmented_scan_tiles: kernel disagrees "
                         f"with its plain version ({rel:.3g} > {tol})")
    return res


def _nccl_rank(init_file, n, nnz):
    """Phase "parallel" (e), in a process of its own on cuda:0: the dist
    backend on NCCL at world size 1, a file rendezvous; DistXch and
    DistSpMV on ``powerlaw(n, nnz, seed=4)``, each y through the oracle.
    Exits non-zero on a failure."""
    import datetime

    import torch.distributed as dist

    from singlespmv_tpu_torch import Config
    from singlespmv_tpu_torch.core import create_random_vector, verify_result
    from singlespmv_tpu_torch.data.generators import powerlaw
    from singlespmv_tpu_torch.parallel import DistSpMV, DistXch, make_mesh

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_IB_DISABLE", "1")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{init_file}",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    ok_all = True
    try:
        coo = powerlaw(n, nnz, seed=4)
        x = create_random_vector(coo.n_col, dtype=np.float32)
        mesh = make_mesh((("row", 1),), device="cuda", backend="dist")
        for op in (DistXch.convert(coo, Config(format="xch"), mesh),
                   DistSpMV.convert(coo, Config(format="ss"), mesh)):
            y = op(x).cpu().numpy()
            ok, det = verify_result(coo, x, y, dtype=np.float32)
            print(f"parallel nccl world 1 {type(op).__name__} on "
                  f"{mesh.device}: Verify: {'PASS' if ok else 'FAIL'} "
                  f"max_abs_err {det['max_abs_err']}", flush=True)
            ok_all &= bool(ok and np.isfinite(y).all())
    finally:
        dist.destroy_process_group()
    sys.exit(0 if ok_all else 1)


@contextlib.contextmanager
def nccl_started():
    """Phase "parallel" (e): starts ``_nccl_rank`` in a spawned process, so
    that its start and its host work overlap the phase's conversions.
    Yields a function that waits for it and fails on a non-zero exit or
    past ``PAR_NCCL_TIMEOUT_S`` from the start; on leaving, the process is
    killed if it still runs and its rendezvous removed."""
    import multiprocessing

    init = tempfile.mkdtemp(prefix="nccl_")
    proc = multiprocessing.get_context("spawn").Process(
        target=_nccl_rank, args=(os.path.join(init, "rendezvous"),
                                 *PAR_NCCL_MATRIX))
    t0 = time.perf_counter()
    proc.start()

    def done():
        proc.join(max(PAR_NCCL_TIMEOUT_S - (time.perf_counter() - t0), 1.0))
        if proc.is_alive():
            raise SystemExit("parallel: the NCCL rank did not finish in "
                             f"{PAR_NCCL_TIMEOUT_S} s")
        if proc.exitcode != 0:
            raise SystemExit(f"parallel: the NCCL rank exited "
                             f"{proc.exitcode}")

    try:
        yield done
    finally:
        if proc.is_alive():
            proc.kill()
            proc.join()
        shutil.rmtree(init, ignore_errors=True)


def run_parallel(mats, dev, card, count_path, wrappers, nccl_done):
    """Phase "parallel": the parallel layer (``singlespmv_tpu_torch/
    parallel/``) on one card, every shard of a local mesh on it.  Returns
    the kernel checks for the ``kernels`` line.

    (a) DistXch at R 4 on webbase-1M (scattered: all-gather) and at R 8 on
    ``generate("band", PAR_BAND, 9, seed=2)`` (banded: a ring of at most 3
    rounds), float32: the convert's host seconds, each shard's nnz and
    kernel calls, the largest shard's ``xch_fused_rows`` calls and the
    pair's (and on webbase-1M its ``xch_mul_panel`` and ``xch_route4_panel``
    calls at B 8) against their plain versions, y through the oracle, a
    step's chained µs (a CUDA graph, as the driver times, or eager CUDA
    events where the capture fails, and the line says which) beside the
    single-device xch
    Time(s) of the same stand-in, and ``DistXch.spmm`` at B 8 on
    webbase-1M, every column through the oracle;
    (b) DistSpMV on torso1 (ss) on a 2 × 2 mesh (float32 and float64) and
    with ``gather_x`` at R 4; HaloSpMV at R 4 in rounds mode on the band
    and in boundary mode on torso1: ``segmented_scan_tiles`` against its
    plain version on DistSpMV's stacked stream and on HaloSpMV's local and
    halo streams, each y through the oracle (float64 within ``F64_TOL``
    of max|y| too), ``exchange_elems`` and ``n_collectives``;
    (c) ``weak_scaling`` (the band at PAR_WEAK_ROWS rows a shard) and
    ``strong_scaling`` (the band at 4 · PAR_WEAK_ROWS rows) at mesh sizes
    1, 2, 4, each point a CUDA graph of 8 steps, the best of 3 replays
    (``parallel/bench.py:_time_op``): on one card this measures what
    sharding costs, not scaling across cards;
    (d) ``dryrun_multichip(8)``;
    (e) DistXch and DistSpMV under ``backend="dist"`` with NCCL at world
    size 1, in a process on cuda:0 (``_nccl_rank``) that ``nccl_started``
    starts with the phase; ``nccl_done`` waits for it.
    The kernel checks and the single-device xch timing come first; the
    launches of (a)–(d) after them are the path's.  Prints the seconds of
    each part."""
    from singlespmv_tpu_torch import Config
    from singlespmv_tpu_torch.core import (create_random_vector,
                                           reference_spmv, verify_result)
    from singlespmv_tpu_torch.data.generators import generate
    from singlespmv_tpu_torch.formats import xch
    from singlespmv_tpu_torch.harness.driver import (CaptureError,
                                                     marginal_seconds)
    from singlespmv_tpu_torch.ops import xch as xops
    from singlespmv_tpu_torch.parallel import (DistSpMV, DistXch, HaloSpMV,
                                               make_mesh)
    from singlespmv_tpu_torch.parallel.bench import (report, strong_scaling,
                                                     weak_scaling)
    from singlespmv_tpu_torch.parallel.dryrun import dryrun_multichip
    from singlespmv_tpu_torch.parallel.spmv import stream_products

    def mesh(*shape):
        return make_mesh(shape, device=dev)

    def x_of(coo, dtype=np.float32):
        xh = create_random_vector(coo.n_col, dtype=dtype)
        return xh, torch.from_numpy(xh).to(dev)

    xcfg = Config(format="xch", dtype="float32")
    ss32 = Config(format="ss", dtype="float32")
    parts, t_part = {}, [time.perf_counter()]

    def part(name):
        t = time.perf_counter()
        parts[name] = round(t - t_part[0], 1)
        t_part[0] = t

    t0 = time.perf_counter()
    band = generate("band", PAR_BAND, 9, seed=2)
    print(f"parallel: band {band.n_row} rows, {band.nnz} nnz, made in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    coos = {"webbase-1M": mats["webbase-1M"], "band": band,
            "torso1": mats["torso1"]}

    def converted(label, make):
        t0 = time.perf_counter()
        op = make()
        torch.cuda.synchronize()
        print(f"parallel {label}: convert host {time.perf_counter() - t0:.2f}"
              " s", flush=True)
        return op

    # --- (a) and (b): the operators, then each kernel against its plain
    #     version on a shard's or the stack's inputs ---
    dist_x = {}
    for name, R in (("webbase-1M", 4), ("band", 8)):
        op = converted(f"DistXch {name} R {R}", lambda: DistXch.convert(
            coos[name], xcfg, mesh(("row", R))))
        print(f"parallel DistXch {name} R {R}: x_mode {op.x_mode} n_rounds "
              f"{op.n_rounds} shards (nnz, calls) " + str([
                  (n, (len(st.win1), len(st.gids2)))
                  for n, st in zip(op.sub_nnz, op.states)]), flush=True)
        dist_x[name] = op
    if not (dist_x["band"].x_mode == "ring"
            and sum(dist_x["band"].n_rounds) <= 3):
        raise SystemExit(f"parallel: the band's DistXch took "
                         f"{dist_x['band'].x_mode} {dist_x['band'].n_rounds}, "
                         "not a ring of at most 3 rounds")
    ops = {
        "DistSpMV torso1 2x2": converted("DistSpMV torso1 2x2", lambda:
            DistSpMV.convert(coos["torso1"], ss32,
                             mesh(("row", 2), ("col", 2)))),
        "DistSpMV torso1 2x2 f64": converted(
            "DistSpMV torso1 2x2 f64", lambda: DistSpMV.convert(
                coos["torso1"], ss32.replace(dtype="float64"),
                mesh(("row", 2), ("col", 2)))),
        "DistSpMV torso1 gather_x R4": converted(
            "DistSpMV torso1 gather_x R4", lambda: DistSpMV.convert(
                coos["torso1"], ss32, mesh(("row", 4)), col_axis=None,
                gather_x=True)),
        "HaloSpMV band rounds R4": converted(
            "HaloSpMV band rounds R4", lambda: HaloSpMV.convert(
                band, ss32, mesh(("row", 4)), mode="rounds")),
        "HaloSpMV torso1 boundary R4": converted(
            "HaloSpMV torso1 boundary R4", lambda: HaloSpMV.convert(
                coos["torso1"], ss32, mesh(("row", 4)), mode="boundary")),
    }
    part("convert")
    compared = []
    for name, op in dist_x.items():
        k = int(np.argmax(op.sub_nnz))
        st = op.states[k]
        _, xd = x_of(coos[name])
        fp = op.footprints(xd)[k][: st.n_col]
        compared.append(compare_xch(f"{name} DistXch R{op.R} shard {k}", st,
                                    xch, xops, fp, extra=False))
        if name == "webbase-1M":      # DistXch.spmm's panel kernels
            X = torch.from_numpy(np.random.default_rng(1).uniform(-1.0, 1.0, (
                coos[name].n_col, PAR_SPMM_B)).astype(np.float32)).to(dev)
            compared.append(compare_xch_panels(
                f"{name} DistXch R{op.R} shard {k} B{PAR_SPMM_B}", st, xch,
                xops, op.footprints(X)[k][: st.n_col], None))
            del X
    for label in ("DistSpMV torso1 2x2", "DistSpMV torso1 2x2 f64"):
        op = ops[label]
        dtype = np.float64 if label.endswith("f64") else np.float32
        _, xd = x_of(coos["torso1"], dtype)
        prod = stream_products(op.streams, op.shard_x(xd))
        compared.append(compare_stacked_scan(
            label, prod, op.streams.heads.view(prod.shape),
            F64_TOL if dtype == np.float64 else TOL))
        del prod
    for label in ("HaloSpMV band rounds R4", "HaloSpMV torso1 boundary R4"):
        op = ops[label]
        _, xd = x_of(coos[label.split()[1]])
        x_loc = op.local_x(xd)
        for part_name, streams, xs in (("local", op.local, x_loc),
                                       ("halo", op.halo, op.exchange(x_loc))):
            if (part_name == "local" and op.merged) or not xs:
                continue
            prod = stream_products(streams, xs)
            compared.append(compare_stacked_scan(
                f"{label} {part_name}", prod, streams.heads.view(prod.shape),
                TOL))
            del prod
    part("kernel checks")
    # the single-device xch Time(s) of (a)'s stand-ins, from the xch path
    # where it ran them, else here
    single = {}
    for name in dist_x:
        single[name] = (RUNS.get((name, "xch", "float32"), {}).get("Time(s)"),
                        "phase xch path")
        if single[name][0] is None:
            st = xch.convert(coos[name], xcfg).to(dev)
            single[name] = (marginal_seconds(
                xch.spmv, st, x_of(coos[name])[1], dev, PAR_WINDOW_S,
                name="xch"), f"this phase, peel offsets {len(st.dia_offs)}")
            del st
    part("single-device xch")

    # --- the path: every launch from here is the path's ---
    _zero(*wrappers)
    for name, op in dist_x.items():
        coo = coos[name]
        xh, xd = x_of(coo)
        y = op(xd).cpu().numpy()
        ok, det = verify_result(coo, xh, y, dtype=np.float32)
        if not (ok and y.shape == (coo.n_row,) and np.isfinite(y).all()):
            raise SystemExit(f"parallel DistXch {name}: Verify FAIL {det}")
        try:
            sec = marginal_seconds(lambda o, a: o.step(a), op, xd, dev,
                                   PAR_WINDOW_S, name="DistXch")
            timed = "chained (CUDA graphs of 64 steps)"
        except CaptureError as e:
            print(f"parallel DistXch {name}: {e}; timed eagerly", flush=True)
            sec, timed = _cuda_ms(lambda: op.step(xd)) / 1e3, \
                "eager (CUDA events, host gaps included)"
        one, source = single[name]
        row = {"op": "DistXch", "matrix": name, "R": op.R,
               "x_mode": op.x_mode, "n_rounds": list(op.n_rounds),
               "step_us": sec * 1e6, "timed": timed,
               "single_device_xch_us": one * 1e6,
               "single_device_from": source, "ratio": sec / one,
               "shard_nnz": list(op.sub_nnz),
               "max_abs_err": det["max_abs_err"], "verify": "PASS"}
        print(f"parallel_row {json.dumps(row)}", flush=True)
    coo = coos["webbase-1M"]
    X = torch.from_numpy(np.random.default_rng(0).uniform(
        -1.0, 1.0, (coo.n_col, PAR_SPMM_B)).astype(np.float32)).to(dev)
    err = verify_columns("parallel DistXch spmm webbase-1M", coo, X,
                         dist_x["webbase-1M"].spmm(X), verify_result)
    print(f"parallel DistXch spmm webbase-1M B{PAR_SPMM_B}: Verify: PASS "
          f"({PAR_SPMM_B} columns) max_abs_err {err}", flush=True)
    del dist_x, X
    part("(a) DistXch")
    for label, op in ops.items():
        coo = coos[label.split()[1]]
        dtype = np.float64 if label.endswith("f64") else np.float32
        xh, xd = x_of(coo, dtype)
        y = op(xd).cpu().numpy()
        ok, det = verify_result(coo, xh, y, dtype=dtype)
        row = {"op": label.split()[0], "label": label, "R": op.R,
               "verify": "PASS" if ok else "FAIL",
               "max_abs_err": det["max_abs_err"],
               "step_ms_eager": _cuda_ms(lambda: op.step(xd))}
        if isinstance(op, HaloSpMV):
            row |= {"mode": op.mode, "exchange_elems": op.exchange_elems,
                    "n_collectives": op.n_collectives, "n_col": coo.n_col,
                    "local_nnz": op.local_nnz, "halo_nnz": op.halo_nnz}
        if dtype == np.float64:
            want = reference_spmv(coo, xh)
            row["oracle_rel_err"] = float(np.abs(y - want).max()
                                          / np.abs(want).max())
            ok = ok and row["oracle_rel_err"] <= F64_TOL
        print(f"parallel_row {json.dumps(row)}", flush=True)
        if not (ok and np.isfinite(y).all()):
            raise SystemExit(f"parallel {label}: {row}")
    del ops
    part("(b) DistSpMV, HaloSpMV")

    # --- (c) the scaling harness on the local mesh, (d) the dryrun ---
    print(f"parallel scaling, local mesh on one card ({card}): what sharding "
          "costs on one card, not scaling across cards", flush=True)
    pts = weak_scaling(lambda n: generate("band", PAR_WEAK_ROWS * n, 9,
                                          seed=n),
                       limit=4, device=dev)
    print(f"weak scaling, band {PAR_WEAK_ROWS} rows a shard, DistSpMV ss "
          f"f32, CUDA graphs of 8 steps:\n{report(pts)}", flush=True)
    pts = strong_scaling(generate("band", 4 * PAR_WEAK_ROWS, 9, seed=4),
                         limit=4, device=dev)
    print(f"strong scaling, band {4 * PAR_WEAK_ROWS} rows, DistSpMV ss "
          f"f32, CUDA graphs of 8 steps:\n{report(pts)}", flush=True)
    part("(c) scaling")
    dryrun_multichip(8, device=dev)
    print("parallel dryrun_multichip(8): OK", flush=True)
    part("(d) dryrun")
    count_path("parallel", wrappers, ("xch_fused_rows",
                                      "segmented_scan_tiles"))

    # --- (e) NCCL at world size 1: the process started with the phase ---
    nccl_done()
    part("(e) nccl")
    print(f"parallel nccl world 1: OK; seconds of the parts: {parts}",
          flush=True)
    return compared


V3_MATS = ("webbase-1M", "ASIC_680ks")   # the xch v3 phase's stand-ins
V3_WINDOW_S = 0.05       # each timed run of the v3 spmv's chained Time(s)
V3_MATCH = {"xch_mul": "xch_mul_kernel", "xch_route": "xch_route_kernel"}


def _v3_calls(st, x, xch, ops):
    """{kernel: (kernel calls, plain-version calls, bound)} over every call
    of the v3 spmv on ``st`` and x, as formats/xch.py:_mul_phase and
    _route_phase make them: ``xch_mul`` a pass-1 call on the x table,
    ``xch_route`` a pass-2 call on the product grid.  Bounds: ``xch_mul``
    its streams (sub when m1 > 1), val, the x table and its products once,
    a multiply a slot; ``xch_route`` its streams (uids, cs, sg0, sg1 a
    step, win a row, lane and hm1 a slot, sub when m2 > 1), the idx planes
    of the pg-groups its steps route, the product grid once and its out
    rows once, a prefix add and a difference a slot and an add a routed
    run end."""
    xt = xch.x_table(st, x)
    prod3 = xch.products(st, xt)
    calls = {"xch_mul": ([], [], [0, 0]), "xch_route": ([], [], [0, 0])}
    for a in zip(st.win1, st.lane1, st.sub1, st.val1):
        for i, f in enumerate((ops.xch_mul, ops.xch_mul_ref)):
            calls["xch_mul"][i].append(
                lambda a=a, f=f: f(*a, xt, st.m1, st.t1))
        win, lane, sub, val = a
        calls["xch_mul"][2][0] += _nbytes(win, lane, val, val, xt) + (
            _nbytes(sub) if st.m1 > 1 else 0)
        calls["xch_mul"][2][1] += val.numel()
    op = st.span * st.planes
    for a in zip(st.uids2, st.gids2, st.cs2, st.sg0_2, st.sg1_2, st.win2,
                 st.lane2, st.sub2, st.hm2, st.idx2, st.chunk_nb):
        uids, _, cs, sg0, sg1, win, lane, sub, hm1, idx, ngb = a
        for i, f in enumerate((ops.xch_route, ops.xch_route_ref)):
            calls["xch_route"][i].append(
                lambda a=a, f=f: f(*a[:10], prod3, a[10], st.m2, op, st.t2,
                                   xch.G_GRP))
        act = ops._active_planes(sg0, sg1, op, 8)   # (n_steps, planes)
        rows = act.repeat_interleave(st.t2, 0).T[:, :, None]
        calls["xch_route"][2][0] += (
            _nbytes(uids, cs, sg0, sg1, win, lane, hm1)
            + int(act.sum()) * st.t2 * 128 + ngb * xch.G_GRP * op * 512
            + (_nbytes(sub) if st.m2 > 1 else 0))
        calls["xch_route"][2][1] += (2 * lane.numel()
                                     + int(((idx >= 0) & rows).sum()))
    calls["xch_route"][2][0] += _nbytes(prod3)
    return calls


def run_xch_v3(mats, dev, card, count_path, v4_states, csr_of):
    """Phase "xch v3" (ROADMAP B.15): xch's v3 σ-plane engine on the
    full-size ``V3_MATS`` stand-ins, converted under ``plan=estimate_v3(
    coo, cfg) | {"route_v": 3}`` (the convert's host seconds printed), at
    float32 and rounded to bfloat16 (``as_bfloat16``).  Per state: every
    pass-1 call's ``xch_mul`` and every pass-2 call's ``xch_route`` against
    its plain version at ``TOL``, each kernel's busy µs against its bound
    (uncounted); the v3 spmv through ``verify_result`` against the float64
    COO oracle (bfloat16's under ``dtype=bfloat16``), and against the v4
    fused spmv on the same stand-in (``v4_states``, phase 2's), each row
    within the sum of both layouts' proven bounds
    (``tests/torch_bounds.py:accuracy_bound`` at the state's type: two
    layouts take their run totals from different stream rows' prefix sums,
    so the reorder bound, which holds one layout's totals fixed, does not
    apply); the whole v3 spmv's busy time, eager wall and chained
    ``Time(s)`` (``marginal_seconds``: CUDA-graph replays of chained
    calls), torch's ``A_csr @ x`` and the v4 fused spmv's busy time beside
    them.  The path's launches (the eager spmv and the chained runs) are
    counted: ``xch_mul`` and ``xch_route`` at float32, their ``_bf16``
    builds at bfloat16, and ``xch_mul``, off every v4 path, is allowed
    here and zeroed after.  Returns the comparison results."""
    from singlespmv_tpu_torch import Config
    from singlespmv_tpu_torch.core import create_random_vector, verify_result
    from singlespmv_tpu_torch.core.dtypes import (round_values, to_host,
                                                  value_tensor)
    from singlespmv_tpu_torch.formats import xch
    from singlespmv_tpu_torch.harness.driver import marginal_seconds
    from singlespmv_tpu_torch.ops import xch as xops

    tb = _torch_bounds()
    compared = []
    for name in V3_MATS:
        coo = mats[name]
        cfg = Config(format="xch")
        t0 = time.perf_counter()
        st32 = xch.convert(coo, cfg, plan=xch.estimate_v3(coo, cfg)
                           | {"route_v": 3})
        t1 = time.perf_counter()
        st32 = st32.to(dev)
        torch.cuda.synchronize()
        print(f"xch v3 convert {name}: host {t1 - t0:.2f} s; to the card "
              f"{time.perf_counter() - t1:.2f} s; " + json.dumps(
                  {k: getattr(st32, k) for k in (
                      "planes", "span", "m1", "m2", "t1", "t2", "n_chunks",
                      "p1", "n_buckets", "n_slots1", "n_slots2")}
                  | {"calls": (len(st32.win1), len(st32.uids2)),
                     "report": xch.report_fields(st32, cfg)}), flush=True)
        if not isinstance(st32, xch.XchState):
            raise SystemExit(f"{name}: route_v 3 gave {type(st32).__name__}")
        for dtype in ("float32", "bfloat16"):
            bf = dtype == "bfloat16"
            st = as_bfloat16(st32) if bf else st32
            v4 = as_bfloat16(v4_states[name]) if bf else v4_states[name]
            xh = round_values(create_random_vector(coo.n_col), dtype)
            x = value_tensor(xh, dtype).to(dev)
            label = f"{name} v3"
            sfx = SFX[x.dtype]
            res = {"label": label, "dtype": str(x.dtype)}
            # (a) the kernels against their plain versions, uncounted
            with uncounted(xops.xch_mul, xops.xch_route):
                for k, (ks, rs, cost) in _v3_calls(st, x, xch,
                                                   xops).items():
                    err, rel = _check_calls(label, k + sfx, ks, rs, TOL)
                    timed_plain = not bf or name == V3_MATS[0]
                    r = {"label": label, "kernel": k + sfx, "dtype": dtype,
                         "calls": len(ks), "max_abs_err": err,
                         "rel_err": rel,
                         "ms": _busy_ms(lambda ks=ks: [f() for f in ks],
                                        V3_MATCH[k], launches=_launched(
                                            getattr(xops, k))),
                         "plain_ms": _extra(timed_plain, _busy_ms,
                                            lambda rs=rs: [f() for f in rs]),
                         } | _bound(*cost, x.dtype)
                    res[k] = r
                    compared.append(r)
            # (b) the path: the eager spmv and its chained Time(s), counted
            _zero(xops.xch_mul, xops.xch_route)
            y = xch.spmv(st, x)
            sec = marginal_seconds(xch.spmv, st, x, dev, V3_WINDOW_S,
                                   name=label)
            count_path(f"xch v3 {name} {dtype}", (xops.xch_mul,
                                                   xops.xch_route),
                       ("xch_mul" + sfx, "xch_route" + sfx),
                       allow=(xops.xch_mul,))
            _zero(xops.xch_mul)    # counted: off every later path
            # (c) against the oracle and the v4 fused spmv, (d) the times
            # beside it; their launches count in no path
            with uncounted(xops.xch_mul, xops.xch_route):
                yh = to_host(y).astype(np.float64)
                ok, det = verify_result(coo, xh, yh, dtype=dtype)
                y4 = to_host(xch.spmv(v4, x)).astype(np.float64)
                sc = tb.stored(coo) if bf else dataclasses.replace(
                    coo, val=coo.val.astype(np.float32).astype(np.float64))
                b3 = tb.accuracy_bound(sc, xh, st, "xch", x, dtype=dtype)
                b4 = tb.accuracy_bound(sc, xh, v4, "xch", x, dtype=dtype)
                gap = np.abs(yh - y4)
                worst = float(np.max(gap / np.maximum(b3 + b4, 1e-300),
                                     initial=0.0))
                # the whole spmv's times, v4's and the library's
                if bf:
                    a_csr, lib_err = bf16_library(torch_csr(coo, dev,
                                                            "bfloat16"), x)
                else:
                    a_csr, lib_err = csr_of(name), None
                res |= {
                    "verify": "PASS" if ok else "FAIL",
                    "max_abs_err": det["max_abs_err"],
                    "v4_worst_share_of_bounds": worst,
                    "spmv_busy_ms": _busy_ms(lambda: xch.spmv(st, x)),
                    "spmv_ms": _cuda_ms(lambda: xch.spmv(st, x)),
                    "time_s": sec,
                    "v4_spmv_busy_ms": _busy_ms(lambda: xch.spmv(v4, x)),
                    "library_ms": None if a_csr is None
                    else _library_ms(a_csr, x),
                    "library_error": lib_err, "card": card}
            for k in ("xch_mul", "xch_route"):
                res[k]["library_ms"] = res["library_ms"]
                if lib_err is not None:
                    res[k]["library_error"] = lib_err
            print(f"xch v3 {name} {dtype}: Verify {res['verify']}, v3 "
                  f"against v4 worst row at {worst:.3g} of the two layouts' "
                  f"proven bounds; spmv busy {res['spmv_busy_ms']:.6f} ms, "
                  f"eager wall {res['spmv_ms']:.6f} ms, Time(s) {sec:.9g}; "
                  f"v4 fused busy {res['v4_spmv_busy_ms']:.6f} ms; cuSPARSE "
                  f"{res['library_ms']} ms ({card})", flush=True)
            print(f"kernel {label} {dtype}: {json.dumps(_marked(res))}",
                  flush=True)
            if not (ok and yh.shape == (coo.n_row,)
                    and np.isfinite(yh).all()):
                raise SystemExit(f"xch v3 {name} {dtype}: spmv output is "
                                 f"wrong: {det}")
            if worst > 1.0:
                raise SystemExit(f"xch v3 {name} {dtype}: v3 and v4 differ "
                                 "past a row's proven bounds")
            del st, v4, y
        del st32
    return compared


@contextlib.contextmanager
def routes_timed(xch):
    """The seconds that ``xch.route_rows`` takes inside the block, summed
    (a convert calls it once a state and once a nested state), in the list
    the block receives: the convert's own calls, not a second run."""
    spent = [0.0]
    route_rows = xch.route_rows

    def timed(state):
        t0 = time.perf_counter()
        try:
            return route_rows(state)
        finally:
            spent[0] += time.perf_counter() - t0

    xch.route_rows = timed
    try:
        yield spent
    finally:
        xch.route_rows = route_rows


COUNTERS = (("", "launches"), ("_f64", "launches_f64"),
            ("_bf16", "launches_bf16"))


def _counts(*wrappers):
    """The launch counts of the wrappers, f32, f64 and bf16 builds."""
    return {w.__name__ + sfx: getattr(w, attr)
            for w in wrappers for sfx, attr in COUNTERS if hasattr(w, attr)}


def _zero(*wrappers):
    for w in wrappers:
        for _, attr in COUNTERS:
            if hasattr(w, attr):
                setattr(w, attr, 0)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from singlespmv_tpu_torch import Config
    from singlespmv_tpu_torch.core import (create_random_vector,
                                           reference_spmv, verify_result)
    from singlespmv_tpu_torch.data.generators import generate
    from singlespmv_tpu_torch.formats import (auto, bkt, bsr, csr5, css, dia,
                                              hyb, slab, spmm_fn, spmv_fn, ss,
                                              xch)
    from singlespmv_tpu_torch.harness import run_benchmark, suite
    from singlespmv_tpu_torch.harness.driver import marginal_seconds
    from singlespmv_tpu_torch.ops import _build
    from singlespmv_tpu_torch.ops import blockgather as gops
    from singlespmv_tpu_torch.ops import bucket as bops
    from singlespmv_tpu_torch.ops import segscan as sops
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

    # --- 2. kernels vs plain versions at the main paths' shapes; circuit5M,
    #     the longest to build, is built while the others run ---
    mats = suite.StandIns(list(dict.fromkeys(
        ("circuit5M",) + SLAB_MATS + XCH_MATS + HYB_MATS + AUTO_MATS)))
    g7 = mats["g7jac200sc"]
    unit_plan = slab._estimate_cols(
        g7.row.astype(np.int64), g7.col.astype(np.int64), g7.nnz,
        unit_only=True)
    unit_plan.update(hub_cols=None, cols_eff=None, hub_off=0)
    plans = {"raefsky3": None, "torso1": None, "g7jac200sc": unit_plan}
    compared = []
    spmm_states = {}     # the states of phase 3, kept from their conversion
    f32_states = {}      # the states of phase 14b (a), rounded there
    csrs = {}            # torch's CSR tensors of the stand-ins, by dtype

    def csr_of(name, dtype=np.float32):
        """torch's CSR tensor of stand-in ``name``: the library yardstick."""
        key = (name, np.dtype(dtype).name)
        if key not in csrs:
            csrs[key] = torch_csr(mats[name], dev, dtype)
        return csrs[key]

    with Phase("slab kernels float32"):
        for name in SLAB_MATS:
            st = _slab_convert(mats, name, slab, cfg, plans[name]).to(dev)
            compared.append(compare_kernel(name, st, slab, ops,
                                           x_of(mats[name]),
                                           a_csr=csr_of(name)))
            if name in dict(SPMM_MATS):
                spmm_states[name] = st
            if (name, "slab") in BF16_KERNEL_STATES:
                f32_states[(name, "slab")] = st
            del st
    with Phase("xch kernels float32"):
        for name in XCH_MATS[:-1]:
            with routes_timed(xch) as routes:
                t0 = time.perf_counter()
                st = xch.convert(mats[name], xcfg)
            t1 = time.perf_counter()
            st = st.to(dev)
            torch.cuda.synchronize()
            print(f"xch convert {name}: host {t1 - t0:.2f} s, of which "
                  f"route_rows {routes[0]:.3f} s; to the card "
                  f"{time.perf_counter() - t1:.2f} s")
            compared.append(compare_xch(name, st, xch, xops,
                                        x_of(mats[name]),
                                        a_csr=csr_of(name), coo=mats[name]))
            spmm_states[name] = st
            if (name, "xch") in BF16_KERNEL_STATES:
                f32_states[(name, "xch")] = st
            del st
    with Phase("slab kernels float64"):
        for name in SLAB64_MATS:
            st = _slab_convert(mats, name, slab, cfg64).to(dev)
            if not (st.mode == "unit" and st.val[0].dtype == torch.float64):
                raise SystemExit(f"{name}: float64 slab plan is not unit "
                                 "mode over float64 values")
            compared.append(compare_kernel(
                name, st, slab, ops, x_of(mats[name], np.float64), F64_TOL,
                a_csr=csr_of(name, np.float64)))
            del st
    with Phase("xch kernels float64"):
        for name in XCH64_MATS:
            st = xch.convert(mats[name], xcfg64).to(dev)
            if st.val1[0].dtype != torch.float64:
                raise SystemExit(f"{name}: float64 xch state holds "
                                 f"{st.val1[0].dtype}")
            compared.append(compare_xch(
                name, st, xch, xops, x_of(mats[name], np.float64), F64_TOL,
                a_csr=csr_of(name, np.float64), coo=mats[name]))
            if name == "ASIC_680ks":
                asic64 = st
            del st
    with Phase("bucket kernels float32"):
        for name, rg in BKT_MATS:
            t0 = time.perf_counter()
            st = bkt.convert(mats[name], cfg.replace(
                format="bkt", bkt_row_group=rg))
            t1 = time.perf_counter()
            bkt.route_rows(st)
            routes = time.perf_counter() - t1
            st = st.to(dev)
            torch.cuda.synchronize()
            label = f"{name} {'bkt_g' if rg == 1024 else 'bkt'}"
            print(f"bkt convert {label}: host {t1 - t0:.2f} s, of which "
                  f"route_rows {routes:.3f} s; merge parts {st.parts}",
                  flush=True)
            compared.append(compare_bucket(label, st, bkt, bops,
                                           x_of(mats[name]),
                                           a_csr=csr_of(name)))
            if tuple(label.split()) in BF16_KERNEL_STATES:
                f32_states[tuple(label.split())] = st
            del st
    with Phase("scan kernels float32"):
        for name, mod in (("torso1", ss), ("webbase-1M", csr5),
                          ("thermomech_dK", css), ("raefsky3", css)):
            fmt = mod.__name__.rsplit(".", 1)[1]
            t0 = time.perf_counter()
            st = mod.convert(mats[name], cfg.replace(format=fmt)).to(dev)
            torch.cuda.synchronize()
            print(f"{fmt} convert {name}: {time.perf_counter() - t0:.1f} s")
            compared.append(compare_scan(f"{name} {fmt}", st, mod,
                                         x_of(mats[name])))
            if (name, fmt) in BF16_KERNEL_STATES:
                f32_states[(name, fmt)] = st
            del st
    with Phase("scan kernels float64"):
        for mod in (ss, css):
            fmt = mod.__name__.rsplit(".", 1)[1]
            st = mod.convert(g7, cfg64.replace(format=fmt)).to(dev)
            if st.val.dtype != torch.float64:
                raise SystemExit(f"g7jac200sc: float64 {fmt} state holds "
                                 f"{st.val.dtype}")
            compared.append(compare_scan(f"g7jac200sc {fmt}", st, mod,
                                         x_of(g7, np.float64), F64_TOL))
            del st

    slab_k, xch_k = (ops.slab_spmv_rows,), (xops.xch_fused_rows,)
    # the kernels that left the spmv path: no path may run them (the xch
    # pair runs in the profiling phases, whose launches count nowhere, and
    # xch_mul in the calibration path, which allows it)
    first_port = (xops.xch_route4, ops.slab_spmv, ops.slab_spmv_blk) + tuple(
        getattr(bops, k) for k in BUCKET_FIRST_PORT + BUCKET_PAIR) + tuple(
        getattr(xops, k) for k in XCH_PAIR)
    bkt_k = tuple(getattr(bops, k) for k in BUCKET_KERNELS + ("ellg_rows",))
    scan_k = (sops.segmented_scan_tiles, gops.block_gather_scan)
    panel_k = (ops.slab_spmm, xops.xch_mul_panel, xops.xch_route4_panel)
    all_k = slab_k + xch_k + bkt_k + scan_k + panel_k
    f32_kernels = (("slab_spmv_rows", "xch_fused_rows", "xch_mul",
                    "xch_route4_rows", "segmented_scan_tiles",
                    "block_gather_scan", "ellg_rows")
                   + BUCKET_KERNELS + PANEL_KERNELS)
    launches = {}

    def count_path(path, wrappers, need, allow=()):
        """Adds the path's launch counts; fails if a kernel in ``need`` was
        not launched, or if a kernel that left the spmv path ever was
        (nothing here calls them, so their counts stay 0 unless a path
        does), but the wrappers in ``allow``."""
        got = _counts(*wrappers)
        print(f"launches in the {path} path: {got}", flush=True)
        for k in need:
            if got[k] < 1:
                raise SystemExit(f"{path}: kernel {k} was never launched")
        off = _counts(*(w for w in first_port if w not in allow))
        if any(off.values()):
            raise SystemExit(f"{path}: a kernel off the spmv path ran: "
                             f"{off}")
        got |= off
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        return got

    # --- 2b. xch's v3 σ-plane path (ROADMAP B.15) on phase 2's stand-ins,
    #     beside their v4 states ---
    with Phase("xch v3"):
        compared.extend(run_xch_v3(
            mats, dev, card.splitlines()[0], count_path,
            {n: spmm_states[n] for n in V3_MATS}, csr_of))

    # --- 3. SpMM: the panel kernels against their plain versions, then the
    #     path through spmm_fn at B = 1, 8 and 32, auto with spmm_b and
    #     float64 SpMM ---
    rng = np.random.default_rng(0)

    def panel(coo, n_cols, dtype=np.float32):
        return torch.from_numpy(rng.uniform(
            -1.0, 1.0, (coo.n_col, n_cols)).astype(dtype)).to(dev)

    with Phase("spmm kernels float32"):
        g7_unit = spmm_states["g7jac200sc"]
        for n_cols in SLAB_PANEL_B:
            compared.append(compare_slab_spmm(
                f"g7jac200sc B{n_cols}", g7_unit, slab, ops,
                panel(g7, n_cols), csr_of("g7jac200sc")))
        for name in XCH_MATS[:-1]:
            for n_cols in XCH_PANEL_B:
                compared.append(compare_xch_panels(
                    f"{name} B{n_cols}", spmm_states[name], xch, xops,
                    panel(mats[name], n_cols), csr_of(name)))
    spmm_coo = {"unbalance-16384": generate("unbalance", 16384, None,
                                            seed=1)}
    spmm_states["unbalance-16384"] = bsr.convert(
        spmm_coo["unbalance-16384"], cfg.replace(format="bsr")).to(dev)
    with Phase("spmm path float32"):
        _zero(*all_k)
        print(f"SpMM Y = A @ X, f32, {card.splitlines()[0]} (flops = "
              "2*nnz*B); median of 3 marginal differences of chained runs "
              "(CUDA-graph replays, CUDA events) of at least "
              f"{SPMM_WINDOW_S} s; torch_csr_us: torch's A_csr @ X at the "
              "same B, timed the same way (a yardstick, on no path)")
        print(f"{'matrix':<18} {'plan':<14} {'B':>4} {'us/iter':>9} "
              f"{'GFLOPS':>8} {'vs spmv x':>9} {'torch_csr_us':>12}")
        for name, fmt in SPMM_MATS:
            coo = spmm_coo.get(name) or mats[name]
            st = spmm_states[name]
            fcfg = cfg.replace(format=fmt)
            plan = fmt + (f"/{st.mode}" if fmt == "slab" else "")
            a_csr = torch_csr(coo, dev) if name in spmm_coo else csr_of(name)
            t_spmv = None
            for n_cols in (1,) + SPMM_B:
                X = panel(coo, n_cols)
                if n_cols == 1:
                    fn, arg = spmv_fn(fcfg), X[:, 0]
                else:
                    fn, arg = spmm_fn(fcfg), X
                sec = marginal_seconds(fn, st, arg, dev, SPMM_WINDOW_S)
                err = verify_columns(f"spmm {name} B{n_cols}", coo, X,
                                     fn(st, arg).reshape(coo.n_row, n_cols),
                                     verify_result)
                lib = marginal_seconds(lambda a, b: a @ b, a_csr, X, dev,
                                       SPMM_WINDOW_S)
                SPMM_F32_US[name, n_cols] = sec * 1e6
                t_spmv = t_spmv or sec
                ratio = n_cols * t_spmv / sec if n_cols > 1 else None
                row = {"matrix": name, "plan": ("spmv:" if n_cols == 1
                                                else "spmm:") + plan,
                       "B": n_cols, "us": sec * 1e6,
                       "gflops": 2 * coo.nnz * n_cols / sec / 1e9,
                       "vs_spmv": ratio, "torch_csr_us": lib * 1e6,
                       "max_abs_err": err, "verify": "PASS"}
                print(f"{name:<18} {row['plan']:<14} {n_cols:>4} "
                      f"{row['us']:>9.1f} {row['gflops']:>8.1f} "
                      f"{'' if ratio is None else f'{ratio:.2f}':>9} "
                      f"{row['torch_csr_us']:>12.1f}", flush=True)
                print(f"spmm_row {json.dumps(row)}", flush=True)
            del a_csr, st
        count_path("spmm float32", all_k, PANEL_KERNELS)
    csrs.clear()
    del spmm_states["torso1"]    # the others are phase "spmm bfloat16"'s
    with Phase("spmm auto float32"):
        _zero(*all_k)
        acfg = Config(format="auto", spmm_b=8)
        for name in ("webbase-1M", "g7jac200sc"):
            st = auto.convert(mats[name], acfg, device=dev).to(dev)
            rep = auto.report_fields(st, acfg)
            print(f"auto spmm_b=8 {name}: " + " ".join(
                f"{k}: {rep[k]}" for k in ("ChosenFormat", "AutoEstimates(us)",
                                           "AutoTrials(us)", "AutoFailed")),
                flush=True)
            check_auto({name: rep})
            X = panel(mats[name], 8)
            err = verify_columns(f"auto spmm {name}", mats[name], X,
                                 auto.spmm(st, X), verify_result)
            print(f"auto spmm_b=8 {name}: Verify: PASS (8 columns) "
                  f"max_abs_err {err}", flush=True)
            del st
        count_path("spmm auto float32", all_k, ())
    with Phase("spmm float64"):
        coo = mats["ASIC_680ks"]
        X = panel(coo, 8, np.float64)
        _zero(*all_k)
        Y = spmm_fn(xcfg64)(asic64, X)
        got = count_path("spmm float64", all_k, ("xch_fused_rows_f64",))
        if any(got.get(k) for k in f32_kernels):
            raise SystemExit("spmm float64: a float32 kernel ran")
        verify_columns("spmm float64 ASIC_680ks", coo, X, Y, verify_result,
                       np.float64)
        Xh, Yh = X.cpu().numpy(), Y.cpu().numpy()
        want = np.stack([reference_spmv(coo, Xh[:, b]) for b in range(8)], 1)
        rel = float(np.abs(Yh - want).max() / np.abs(want).max())
        print(f"spmm float64 ASIC_680ks B8: oracle_rel_err {rel}", flush=True)
        if not rel <= F64_TOL:
            raise SystemExit(f"spmm float64: off the oracle by {rel:.3g} > "
                             f"{F64_TOL} of max|Y|")
        del asic64, Y, g7_unit
    # --- 3b. bfloat16 SpMM (ROADMAP A.10b): the path through spmm_fn and
    #     auto at bfloat16, counted, then the three panel kernels' bfloat16
    #     builds against their plain versions, on phase 2's and 3's states
    #     rounded to bfloat16 ---
    with Phase("spmm bfloat16"):
        held = {(n, f): spmm_states[n] for n, f in (
            ("g7jac200sc", "slab"), ("webbase-1M", "xch"),
            ("ASIC_680ks", "xch"), ("unbalance-16384", "bsr"))}
        compared.extend(run_spmm_bfloat16(
            mats, spmm_coo, held, dev, card.splitlines()[0], count_path,
            all_k))
        del held, spmm_states

    # --- 4. the slab main path; count the launches it makes ---
    run_cfg = Config(**CFG_KW, calibrate_seconds=0.2, n_trials=3)
    drv = DriverRuns()
    with Phase("slab path float32"):
        _zero(*slab_k)
        run_path({n: mats[n] for n in ("raefsky3", "torso1")}, run_cfg,
                 run_benchmark, ("PadFactor", "RoutePlanes"), dev,
                 driver=drv)
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
        count_path("slab float32", slab_k, ("slab_spmv_rows",))
        del state

    # --- 5. the xch main path; count the launches it makes ---
    with Phase("xch path float32"), phases_uncounted(xch, xops):
        _zero(*xch_k)
        profiled = run_path(
            {n: mats[n] for n in ("webbase-1M", "ASIC_680ks")},
            run_cfg.replace(format="xch", profiling=True), run_benchmark,
            ("PadFactor", "KBlk", "POh", "PeelOffs", "LongRows"), dev,
            driver=drv)
        count_path("xch float32", xch_k, ("xch_fused_rows",))

    # --- 6. the hyb main path: band peel plus a residual ---
    hyb_keys = ("PeelDiags", "PeelNnz", "RestFormat", "RestNnz",
                "RestPadFactor")
    with Phase("hyb path float32"):
        _zero(*all_k)
        reps = run_path({n: mats[n] for n in HYB_MATS + ("webbase-1M",)},
                        run_cfg.replace(format="hyb"), run_benchmark,
                        hyb_keys, dev,
                        rest=("SLAB", "XCH", "BKT", "BKT_G", "CSS"),
                        driver=drv)
        if reps["webbase-1M"]["RestFormat"] != "XCH":
            raise SystemExit("webbase-1M: the hyb residual left xch")
        count_path("hyb float32", all_k, ("xch_fused_rows",
                                          "slab_spmv_rows"))

    # --- 6b. where a hyb spmv's time goes, and the residual's kernels
    #     against their plain versions at the residual's shapes ---
    for name, dtype in [(n, "float32") for n in HYB_MATS] + [
            ("Chebyshev4", "float64")]:
        with Phase(f"hyb kernels {name} {dtype}"):
            st = hyb.convert(mats[name], cfg.replace(
                format="hyb", dtype=dtype)).to(dev)
            x = x_of(mats[name], np.dtype(dtype))
            rest = hyb.REST_MODULES[st.rest_fmt]
            print(f"hyb {name} {dtype}: " + json.dumps(_marked({
                "rest_fmt": st.rest_fmt,
                "spmv_ms": _cuda_ms(lambda: hyb.spmv(st, x)),
                "spmv_busy_ms": _busy_ms(lambda: hyb.spmv(st, x)),
                "dia_ms": _cuda_ms(lambda: dia.spmv(st.dia_state, x)),
                "dia_busy_ms": _busy_ms(lambda: dia.spmv(st.dia_state, x)),
                "rest_busy_ms": _busy_ms(
                    lambda: rest.spmv(st.rest_state, x))})), flush=True)
            compared.append(compare_rest(
                f"{name} hyb residual", st, slab, xch, ops, xops, x,
                F64_TOL if dtype == "float64" else TOL))
            del st

    # --- 7. the bkt path: 128-row and 1024-row buckets ---
    with Phase("bkt path float32"):
        _zero(*bkt_k)
        for name, rg in (("raefsky3", 128), ("g7jac200sc", 1024)):
            run_path({name: mats[name]}, run_cfg.replace(
                format="bkt", bkt_row_group=rg), run_benchmark,
                ("SlotDepth", "GroupWidth", "ChainK", "PadFactor"), dev)
        count_path("bkt float32", bkt_k, BUCKET_KERNELS)

    # --- 8. the scan formats: css, ss and csr5 ---
    scan_keys = {"css": ("N_BLOCK", "SEGMENT_WIDTH(byte)", "R_max"),
                 "ss": ("SEGMENT_WIDTH(byte)", "R_max", "nStep"),
                 "csr5": ("Sigma", "nFastTile", "nNormalTile", "R_max")}
    scan_reps = {}
    for fmt, names, need in (
            ("css", ("thermomech_dK", "webbase-1M"), "block_gather_scan"),
            ("ss", ("torso1",), "segmented_scan_tiles"),
            ("csr5", ("torso1", "webbase-1M"), "segmented_scan_tiles")):
        with Phase(f"{fmt} path float32"):
            _zero(*scan_k)
            # ss and css profile their phases, ss its scan steps too
            scan_reps[fmt] = run_path(
                {n: mats[n] for n in names}, run_cfg.replace(
                    format=fmt, profiling=fmt != "csr5",
                    measure_step_time=fmt == "ss"),
                run_benchmark, scan_keys[fmt], dev)
            count_path(f"{fmt} float32", scan_k, (need,))

    # --- 9. the auto path, with bkt_g among the measured candidates ---
    auto_keys = ("ChosenFormat", "AutoEstimates(us)", "AutoTrials(us)",
                 "AutoFailed", "AutoExcluded")
    auto_cfg = Config(format="auto", calibrate_seconds=0.2, n_trials=3)
    with Phase("auto path float32"), TrialWindow(AUTO_TRIAL_WINDOW_S):
        _zero(*all_k)
        reps = run_path({n: mats[n] for n in AUTO_MATS}, auto_cfg,
                        run_benchmark, auto_keys, dev, driver=drv)
        check_auto(reps)
        print_scan_estimates(reps)
        count_path("auto float32", all_k,
                   ("bucket_fused_rows", "slab_spmv_rows"))

    # --- 10. the float64 paths, held to the oracle at F64_TOL ---
    oracle = {"x": lambda coo: create_random_vector(coo.n_col),
              "spmv": reference_spmv}
    run64 = run_cfg.replace(dtype="float64")
    for fmt, name, keys, need in (
            ("slab", "torso1", ("PadFactor", "RoutePlanes"),
             ("slab_spmv_rows_f64",)),
            ("xch", "webbase-1M", ("KBlk", "POh", "PeelOffs", "LongRows"),
             ("xch_fused_rows_f64",)),
            ("hyb", "Chebyshev4", hyb_keys, ("slab_spmv_rows_f64",)),
            ("auto", "g7jac200sc", auto_keys, ("slab_spmv_rows_f64",)),
            ("css", "g7jac200sc", scan_keys["css"],
             ("block_gather_scan_f64",)),
            ("ss", "g7jac200sc", scan_keys["ss"],
             ("segmented_scan_tiles_f64",))):
        with Phase(f"{fmt} path float64"):
            _zero(*all_k)
            check_auto(run_path(
                {name: mats[name]}, run64.replace(format=fmt),
                run_benchmark, keys, dev, oracle=oracle))
            got = count_path(f"{fmt} float64", all_k, need)
            if any(got.get(k) for k in f32_kernels):
                raise SystemExit(f"{fmt} float64: a float32 kernel ran")
            if fmt in ("hyb", "auto") and not sum(got.values()):
                raise SystemExit(f"{fmt} float64: no kernel launched")

    # --- 11. the calibration path: its kernels against their plain
    #     versions, then calibrate, the microbenchmarks and the slab probe
    #     through their entry points, while circuit5M's stand-in builds ---
    from singlespmv_tpu_torch.ops import probes as pops

    cal_k = (xops.xch_route, xops.xch_mul) + pops.WRAPPERS
    with Phase("calibration kernels"):
        cal_checks = compare_calibration(dev)
    with Phase("calibration path"):
        # the eager loop's times and the kernels' busy times first: their
        # launches count in no path
        eager = eager_probe_seconds(dev)
        busy = probe_kernel_busy(dev)
        _zero(*cal_k)
        run_calibration_path(dev, eager, busy)
        count_path("calibration", cal_k, ("xch_route", "xch_mul") + tuple(
            w.__name__ for w in pops.WRAPPERS), allow=(xops.xch_mul,))
        _zero(xops.xch_mul)    # counted: off every later path

    # --- 12. driver timing: the chained Time(s) beside the eager wall and
    #     the busy time, the A/B of the chain's length, the phases and
    #     steps, the state cache and a trace ---
    from singlespmv_tpu_torch.harness import driver as hdriver

    with Phase("driver timing"):
        _zero(*all_k)
        print(f"driver timing, f32, {card.splitlines()[0]}: Time(s) the "
              "median of the driver's marginals over CUDA-graph replays of "
              f"{hdriver.CHAIN} chained calls; busy: one eager call's device "
              "events (torch.profiler); eager wall: 20 eager calls between "
              "CUDA events", flush=True)
        if sorted(drv.rows) != sorted(n for n, _ in DRIVER_RUNS):
            raise SystemExit(f"driver timing: measured {sorted(drv.rows)}")
        for name, row in drv.rows.items():
            print(f"driver_row {json.dumps(row)}", flush=True)
            if not row["graph_within_reorder_bound"]:
                raise SystemExit(
                    f"{name}: the graph's y is off the eager y past a row's "
                    "reorder bound (worst row at "
                    f"{row['graph_worst_share_of_bound']:.3g} of its bound)")
            if not row["busy_complete"]:
                print(f"{name}: no complete trace, so Time(s) is not held to "
                      "the busy time", flush=True)
            elif row["time_us"] < BUSY_SHARE * row["busy_us"]:
                raise SystemExit(
                    f"{name}: Time(s) {row['time_us']:.2f} us is under "
                    f"{BUSY_SHARE} of the busy {row['busy_us']:.2f} us: the "
                    "timed window leaves out work")
        for name in ("raefsky3", "torso1"):
            coo = mats[name]
            st = drv.load(name, run_cfg, coo, dev)
            x = torch.from_numpy(create_random_vector(
                coo.n_col, dtype=np.float32)).to(dev)
            ab = {}
            for k in CHAIN_AB:
                timed = hdriver.runner_clock(hdriver.make_chained_runner(
                    slab.spmv, st, x, name=f"{name} slab", chain=k), dev)
                loop = hdriver.calibrate_loop(
                    timed, run_cfg.calibrate_seconds, run_cfg.max_loop)
                ab[k] = {"loop": loop, "us": [
                    hdriver.median_seconds(timed, loop, run_cfg.n_trials)
                    * 1e6 for _ in range(2)]}
                del timed
            print(f"chain A/B {name} slab (us a call, two medians of "
                  f"{run_cfg.n_trials} marginals each): {json.dumps(ab)}",
                  flush=True)
            del st
        csr_rep = run_benchmark(
            mats["raefsky3"], run_cfg.replace(format="csr", profiling=True),
            name="raefsky3", device=dev, log=lambda m: None).report
        for label, rep, names in (
                ("ASIC_680ks xch", profiled["ASIC_680ks"], ("Mul", "Sum")),
                ("torso1 ss", scan_reps["ss"]["torso1"],
                 ("Mul", "Sum1", "Sum2")),
                ("thermomech_dK css", scan_reps["css"]["thermomech_dK"],
                 ("MulScan", "Sum2")),
                ("raefsky3 csr", csr_rep, ("Mul", "Sum"))):
            ph = {n: rep.get(f"PhaseTime-{n}(s)") for n in names}
            print(f"phases {label}: Time(s) {rep['Time(s)']} "
                  + " ".join(f"{n} {v}" for n, v in ph.items())
                  + f" MulPerf {rep.get('MulPerf')} SumPerf "
                  f"{rep.get('SumPerf')} peel {rep.get('PeelOffs')}",
                  flush=True)
            if not all(v and v > 0 for v in ph.values()):
                raise SystemExit(f"{label}: a phase was not timed: {ph}")
            if rep.get("PeelOffs") is None \
                    and sum(ph.values()) < PHASE_SHARE * rep["Time(s)"]:
                raise SystemExit(f"{label}: the phases sum to "
                                 f"{sum(ph.values())} s, under {PHASE_SHARE}"
                                 f" of Time(s) {rep['Time(s)']}")
        ss_rep = scan_reps["ss"]["torso1"]
        steps = {k: v for k, v in ss_rep.items() if k.startswith("StepTime-")}
        print(f"steps torso1 ss: {json.dumps(steps)}", flush=True)
        if len(steps) != ss_rep["nStep"] or min(steps.values()) <= 0:
            raise SystemExit(f"torso1 ss: {len(steps)} step times for "
                             f"{ss_rep['nStep']} steps")
        for name, rcfg in (("torso1", run_cfg), ("g7jac200sc", auto_cfg)):
            first = drv.results[name]
            npz = drv.path(name, rcfg.format) + ".npz"
            stamp = os.path.getmtime(npz)
            again = run_benchmark(mats[name], rcfg, name=name, device=dev,
                                  cache_dir=drv.dir, log=lambda m: None)
            drift = float(np.abs(again.y - first.y).max())
            scale = float(np.abs(first.y).max())
            within, worst = reorder_check(
                mats[name], drv.load(name, rcfg, mats[name], dev), rcfg,
                create_random_vector(mats[name].n_col).astype(np.float32),
                again.y, first.y)
            print(f"cache {name} {rcfg.format}: OptimizeTime(s) "
                  f"{first.report['OptimizeTime(s)']} (convert and save) -> "
                  f"{again.report['OptimizeTime(s)']} (load); ChosenFormat "
                  f"{first.report.get('ChosenFormat')} -> "
                  f"{again.report.get('ChosenFormat')}; Time(s) "
                  f"{first.seconds} -> {again.seconds}; y drift {drift:.3g} "
                  f"of max|y| {scale:.3g}, worst row at {worst:.3g} of its "
                  "reorder bound", flush=True)
            if not (again.verify_ok and first.verify_ok
                    and os.path.getmtime(npz) == stamp and within
                    and again.report.get("ChosenFormat")
                    == first.report.get("ChosenFormat")):
                raise SystemExit(f"{name}: the cached state's run differs "
                                 "or did not load")
        trace_dir = tempfile.mkdtemp(prefix="trace_")
        run_benchmark(mats["raefsky3"], run_cfg.replace(
            calibrate_seconds=0.002, n_trials=2), name="raefsky3",
            device=dev, cache_dir=drv.dir, trace_dir=trace_dir,
            log=lambda m: None)
        files = os.listdir(trace_dir)
        with open(os.path.join(trace_dir, files[0])) as f:
            events = json.load(f)["traceEvents"]
        on_card = [e for e in events if e.get("cat") in (
            "kernel", "gpu_memcpy", "gpu_memset")]
        kinds = {}
        for e in on_card:
            kinds[e["name"][:40]] = kinds.get(e["name"][:40], 0) + 1
        print(f"trace {files}: {len(events)} events, {len(on_card)} on the "
              f"card: {json.dumps(kinds)}", flush=True)
        shutil.rmtree(trace_dir)
        if len(files) != 1 or not on_card:
            raise SystemExit("trace_dir: no trace with device events")
        count_path("driver timing", all_k, ("slab_spmv_rows",))

    # --- 13. the campaign layer: ellg's passes kernel and its first
    #     port's stage A at gran 128 against their plain versions on two
    #     stand-ins, the ellg path, the other new formats through
    #     run_benchmark, the headline module, a sweep and format-logs ---
    with Phase("campaign"):
        ellg_rows_checks, ellg_checks, ellg_launches = run_campaign(
            mats, dev, card.splitlines()[0], count_path, all_k)
        compared += ellg_rows_checks

    # --- 14. the solver layer: CG and BiCGStab as replayed CUDA graphs over
    #     slab and auto, SpTRSV and SpGEMM, while circuit5M's stand-in
    #     builds ---
    with Phase("solvers"):
        run_solvers(mats, dev, card.splitlines()[0], count_path, all_k)

    # --- 14b. bfloat16 (ROADMAP A.10): each bfloat16 kernel against its
    #     plain version on phase 2's states with their values rounded, two
    #     bfloat16 spmv calls within each row's reorder bound, then the
    #     bfloat16 paths through run_benchmark (auto on the driver's six
    #     stand-ins, nine formats on raefsky3) ---
    with Phase("bfloat16"):
        bf16_compared, bf16_launches = run_bfloat16(
            mats, dev, card.splitlines()[0], count_path, all_k, f32_states)
        compared.extend(bf16_compared)

    # --- 14c. the parallel layer: DistXch, DistSpMV, HaloSpMV, the scaling
    #     harness and the dryrun on a local mesh on the card, then NCCL at
    #     world size 1 ---
    with Phase("parallel"), nccl_started() as nccl_done:
        compared.extend(run_parallel(mats, dev, card.splitlines()[0],
                                     count_path, all_k, nccl_done))

    # --- 15. the xch path on circuit5M, last because its stand-in takes
    #     longest to build: kernels vs plain versions on every call, then
    #     its spmv against the oracle ---
    with Phase("xch circuit5M float32"):
        big = mats["circuit5M"]
        with routes_timed(xch) as routes:
            t0 = time.perf_counter()
            state = xch.convert(big, xcfg)
        print(f"xch convert circuit5M: host {time.perf_counter() - t0:.1f} "
              f"s, of which route_rows {routes[0]:.2f} s")
        state = state.to(dev)
        if not (len(state.win1) > 1 and len(state.gids2) > 1
                and state.long is not None):
            raise SystemExit("circuit5M: expected several kernel calls per "
                             "pass and a nested long-row state")
        compared.append(compare_xch("circuit5M", state, xch, xops,
                                    x_of(big), a_csr=torch_csr(big, dev)))
        _zero(*xch_k)
        x_host = create_random_vector(big.n_col, dtype=np.float32)
        y = xch.spmv(state, torch.from_numpy(x_host).to(dev)).cpu().numpy()
        ok, det = verify_result(big, x_host, y, dtype=np.float32)
        print(f"xch circuit5M: Verify: {'PASS' if ok else 'FAIL'} "
              f"{json.dumps(xch.report_fields(state, xcfg))} "
              f"calls {len(state.win1)} / {len(state.gids2)} "
              f"max_abs_err {det['max_abs_err']}")
        if not (ok and y.shape == (big.n_row,) and np.isfinite(y).all()):
            raise SystemExit("circuit5M: xch spmv output is wrong")
        count_path("xch float32 circuit5M", xch_k, ("xch_fused_rows",))
        del state
    mats.close()

    # --- 16. every kernel of each path ran in that path, and the first
    #     port's route kernels in none ---
    print(f"launches in the main paths: {launches}; the first port's "
          f"kernels off the spmv path (count_path fails on any): "
          f"{_counts(*first_port)}")

    kernels = []
    slab_src = "singlespmv_tpu_torch/csrc/slab.cu"
    xch_src = "singlespmv_tpu_torch/csrc/xch.cu"
    bkt_src = "singlespmv_tpu_torch/csrc/bucket.cu"
    gather_src = "singlespmv_tpu_torch/csrc/blockgather.cu"
    scan_src = "singlespmv_tpu_torch/csrc/segscan.cu"
    checks = by_kernel(compared)
    print("kernel checks: " + json.dumps(
        {k: [r["label"] for r in rs] for k, rs in checks.items()}))
    # max_abs_err over every state checked; ms and plain_ms of one of them.
    # The slab route's three rows are one kernel: launches are its f32
    # (unit and blk alike) and f64 counts.  The rows of the first port's
    # stage B (bucket_reduce, bucket_reduce_grouped, lane_unpermute) are
    # bucket_rows, stage B alone, with the first port's own time beside it
    # ("first_port_ms").  The bucket kernels off the path (the pair and the
    # first port's stage B) report their own path launches, 0 (count_path
    # fails on any), and name bucket_fused_rows, which computes their
    # functions on the path ("on_path_as")
    launch_key = {"slab_spmv": "slab_spmv_rows",
                  "slab_spmv_blk": "slab_spmv_rows",
                  "slab_spmv_f64": "slab_spmv_rows_f64",
                  "slab_spmv_bf16": "slab_spmv_rows_bf16",
                  "slab_spmv_blk_bf16": "slab_spmv_rows_bf16"}
    on_path_as = dict.fromkeys(BUCKET_FIRST_PORT + BUCKET_PAIR,
                               "bucket_fused_rows") \
        | {k + "_bf16": "bucket_fused_rows_bf16" for k in BUCKET_PAIR} \
        | {k + sfx: "xch_fused_rows" + sfx for k in XCH_PAIR
           for sfx in SFX.values()}
    for kname, src, line, timed in (
            ("slab_spmv", slab_src, "slab.py:263", "g7jac200sc"),
            ("slab_spmv_blk", slab_src, "slab.py:310", "torso1"),
            ("xch_fused_rows", xch_src, "xch.py:48", "circuit5M"),
            ("xch_mul", xch_src, "xch.py:48", "circuit5M"),
            ("xch_route4_rows", xch_src, "xch.py:151", "circuit5M"),
            ("slab_spmv_f64", slab_src, "slab.py:463", "torso1"),
            ("xch_fused_rows_f64", xch_src, "xch.py:495", "webbase-1M"),
            ("xch_mul_f64", xch_src, "xch.py:495", "webbase-1M"),
            ("xch_route4_rows_f64", xch_src, "xch.py:594", "webbase-1M"),
            ("bucket_fused_rows", bkt_src, "bucket.py:91",
             "thermomech_dK bkt_g"),
            ("ellg_rows", bkt_src, "bucket.py:91", "g7jac200sc ellg"),
            ("block_gather_mul", bkt_src, "bucket.py:91",
             "thermomech_dK bkt_g"),
            ("bucket_rows", bkt_src, "bucket.py:264",
             "thermomech_dK bkt_g"),
            ("bucket_reduce", bkt_src, "bucket.py:198", "raefsky3 bkt"),
            ("bucket_reduce_grouped", bkt_src, "bucket.py:264",
             "thermomech_dK bkt_g"),
            ("lane_unpermute", bkt_src, "bucket.py:313",
             "thermomech_dK bkt_g"),
            ("block_gather_scan", gather_src, "blockgather.py:111",
             "thermomech_dK css"),
            ("block_gather_scan_f64", gather_src, "blockgather.py:144",
             "g7jac200sc css"),
            ("segmented_scan_tiles", scan_src, "segscan.py:51",
             "torso1 ss"),
            ("segmented_scan_tiles_f64", scan_src, "segscan.py:51",
             "g7jac200sc ss"),
            ("slab_spmm", slab_src, "slab.py:228", "g7jac200sc B32"),
            ("xch_mul_panel", xch_src, "xch.py:338", "webbase-1M B16"),
            ("xch_route4_panel", xch_src, "xch.py:424", "webbase-1M B16"),
            # the v3 σ-plane route (B.15): its path is phase "xch v3"
            ("xch_route", xch_src, "xch.py:259", "webbase-1M v3"),
            ("xch_route_bf16", xch_src, "xch.py:259", "webbase-1M v3"),
            # bfloat16 SpMM (A.10b): the panels' bfloat16 builds; their
            # launches are phase "spmm bfloat16"'s path
            ("slab_spmm_bf16", slab_src, "slab.py:228", "g7jac200sc B32"),
            ("xch_mul_panel_bf16", xch_src, "xch.py:338", "webbase-1M B16"),
            ("xch_route4_panel_bf16", xch_src, "xch.py:424",
             "webbase-1M B16"),
            # bfloat16 (A.10): the same kernels' bfloat16 builds; their
            # launches are the bfloat16 paths'
            ("slab_spmv_bf16", slab_src, "slab.py:263", "g7jac200sc"),
            ("slab_spmv_blk_bf16", slab_src, "slab.py:310", "torso1"),
            ("xch_fused_rows_bf16", xch_src, "xch.py:48", "webbase-1M"),
            ("xch_mul_bf16", xch_src, "xch.py:48", "webbase-1M"),
            ("xch_route4_rows_bf16", xch_src, "xch.py:151", "webbase-1M"),
            ("bucket_fused_rows_bf16", bkt_src, "bucket.py:91",
             "thermomech_dK bkt_g"),
            ("ellg_rows_bf16", bkt_src, "bucket.py:91", "raefsky3 ellg"),
            ("block_gather_mul_bf16", bkt_src, "bucket.py:91",
             "thermomech_dK bkt_g"),
            ("bucket_rows_bf16", bkt_src, "bucket.py:264",
             "thermomech_dK bkt_g"),
            ("block_gather_scan_bf16", gather_src, "blockgather.py:111",
             "thermomech_dK css"),
            ("segmented_scan_tiles_bf16", scan_src, "segscan.py:51",
             "webbase-1M csr5")):
        rs = checks.get("bucket_rows" if kname in BUCKET_FIRST_PORT
                        else kname, [])
        t = [r for r in rs if r["label"] == timed]
        if not t:
            raise SystemExit(f"{kname}: not checked on {timed}")
        first_port_ms = {}
        if kname in BUCKET_FIRST_PORT:
            first_port_ms = {"first_port_ms": next(
                r["ms"] for r in checks[kname] if r["label"] == timed)}
        kernels.append(_marked({
            "name": kname, "route": "cuda", "source": src,
            "replaces": f"singlespmv_tpu/ops/pallas/{line}",
            **({"replaces_also": "singlespmv_tpu/ops/pallas/" + (
                "xch.py:594" if kname.endswith("_f64") else "xch.py:151")}
               if kname.startswith("xch_fused_rows") else {}),
            "launches": launches[launch_key.get(kname, kname)],
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            "ms": t[0]["ms"], "plain_ms": t[0]["plain_ms"],
            "bound_ms": t[0]["bound_ms"], "bound_by": t[0]["bound_by"],
            "library_ms": t[0]["library_ms"]}
            | {k: t[0][k] for k in ("bound_ms_idx_layout", "library_error",
                                    "reorder_worst_share",
                                    "accuracy_worst_share", "pair_ms",
                                    "pair_bound_ms",
                                    "pair_reorder_worst_share",
                                    "first_port_ms")
               if k in t[0]}
            | first_port_ms
            | ({"on_path_as": on_path_as[kname]}
               if kname in on_path_as else {})))
    # xch_route's calibration cases beside its path row: calibrate's H
    # 16,384 at 16 and 8 planes, each timed; max_abs_err over them too
    cal_route = cal_checks.pop("xch_route")
    row = next(k for k in kernels if k["name"] == "xch_route")
    cal = {p: next(r for r in cal_route if r["label"] == f"xch_route planes "
                   f"{p}") for p in (16, 8)}
    if any(r["ms"] is None for r in cal.values()):
        raise SystemExit("xch_route's calibration cases were not timed")
    row["max_abs_err"] = max([row["max_abs_err"]]
                             + [r["max_abs_err"] for r in cal_route])
    row["calibration"] = {f"{p}_planes": {k: r[k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by")} for p, r in cal.items()}
    _marked(row)
    # block_gather_mul at ellg's gran 128, the first port of ellg's
    # passes: one entry a pass; launches are the ellg path's of
    # block_gather_mul (0), ellg_rows computing its function there
    for r in ellg_checks:
        kernels.append(_marked({
            "name": f"block_gather_mul[{r['label']} t{r['t']} m{r['m']} "
                    "gran128]",
            "route": "cuda", "source": bkt_src,
            "replaces": "singlespmv_tpu/ops/pallas/bucket.py:91",
            "launches": ellg_launches, "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "on_path_as": "ellg_rows"}))
    # the calibration path's: max_abs_err over every check, times of the
    # first (each probe at its defaults, probe_slab at T 32, S8 8, stage
    # all)
    for kname, (wname, src, replaces) in CAL_KERNELS.items():
        rs = cal_checks[kname]
        if rs[0]["ms"] is None:
            raise SystemExit(f"{kname}: its first check was not timed")
        kernels.append(_marked({
            "name": kname, "route": "cuda",
            "source": f"singlespmv_tpu_torch/{src}", "replaces": replaces,
            "launches": launches[wname],
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            "ms": rs[0]["ms"], "plain_ms": rs[0]["plain_ms"],
            "bound_ms": rs[0]["bound_ms"], "bound_by": rs[0]["bound_by"],
            "library_ms": rs[0]["library_ms"]}))
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
