"""Benchmark driver: ``singlespmv_tpu/harness/driver.py``'s ``run_benchmark``
for PyTorch on one GPU.

    load → convert (OptimizeTime, the move to the device included; with
    ``cache_dir`` a converted state is loaded instead) → first call
    (CompileTime) → verify twice against the float64 COO oracle → calibrate
    the loop count by doubling until a chained run takes
    ``calibrate_seconds`` → median of ``n_trials`` marginal trials → under
    ``cfg.profiling`` each phase, under ``cfg.measure_step_time`` each scan
    step, timed the same way → report block with the reference key schema.

How a spmv is timed (``make_chained_runner``): the reference chains its
timed calls on the device in one executable.  Here ``run_n(n)`` replays a
CUDA graph that holds a chain of ``CHAIN`` calls n // ``CHAIN`` times (and
a graph of one call for the rest), so a timed run holds no host work
between calls.  Each trial is the reference's marginal difference
(t(loop) − t(loop/2)) / (loop − loop/2), which cancels the fixed cost of a
run; t is taken with CUDA events around ``run_n`` (``device_seconds``).
``Time(s)`` is the median of the trials.  What a user of eager ``spmv``
pays per call, host dispatch included, is not ``Time(s)``: ``chip_smoke.py``
prints it beside it as the eager wall.  On the CPU ``run_n`` is a plain
host loop and a host clock stands in.  ``device`` defaults to "cuda" and a
run with no GPU raises; the CPU runs the kernels' plain versions only when
asked for by ``device="cpu"``.  The one format placed on the CPU by itself
is the host library baseline hostlib, whose ``PREFERRED_DEVICE`` the
driver honours as the reference's does; its report block says so
(``PreferredDevice``, ``Architecture`` CPU).

With ``format="auto"`` the driver retries as the reference's does
(``singlespmv_tpu/harness/driver.py:168-220``): a chosen engine that refuses
at its first calls with a guard error (``ValueError``, ``TypeError``,
``MemoryError``, a CUDA out-of-memory error) is excluded
(``cfg.auto_exclude``) and auto plans again; the exclusions are reported as
``AutoExcluded``.  A ``KernelError`` is never a reason to exclude, nor is a
``CaptureError``: either stops the run.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..config import Config
from ..core.dtypes import to_host, value_tensor
from ..core.mmio import load_matrix as _load_mtx
from ..core.oracle import verify_result
from ..core.rng import create_random_vector
from ..core.types import COOMatrix

from .. import formats
from ..formats.auto import GUARD_ERRORS
from ..formats.base import phases_fn
from .report import FORMAT_NAMES, format_block, get_basename
from .roofline import detect_chip, roofline

AUTO_ATTEMPTS = 4      # plans of format=auto, each excluding the last refusal
CHAIN = 64             # calls a CUDA graph chains (PERF.md §6: the A/B of k)
WARMUP_CALLS = 3       # eager calls on a side stream before a capture


class TraceError(RuntimeError):
    """A profiler trace that no busy time can be read from: its match is
    wrong, or it is complete and holds no device time."""


class CaptureError(RuntimeError):
    """A CUDA graph capture of chained calls that failed.  It is never one
    of auto's guard errors: like a ``KernelError`` it stops the run, and no
    timing falls back to eager calls."""


@dataclasses.dataclass
class BenchResult:
    report: Dict[str, object]      # ordered report block (reference key schema)
    gflops: float
    seconds: float                 # median per-SpMV seconds
    loop: int
    verify_ok: bool
    y: np.ndarray                  # final output vector

    @property
    def block(self) -> str:
        return format_block(self.report)


def load_matrix(path, cfg: Config) -> COOMatrix:
    return _load_mtx(path, index_bits=cfg.index_bits, sum_duplicates=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_of(device) -> torch.device:
    """``device`` as a torch.device; raises for cuda without a card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to run the "
                           "kernels' plain versions on the host")
    return device


def device_seconds(fn, device: torch.device) -> float:
    """Seconds that ``fn()`` takes: CUDA events around it on the card (the
    device's span, host gaps included), a host clock on the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def make_chained_runner(fn: Callable, state, arg: torch.Tensor, *,
                        name: str = "", chain: int = CHAIN) -> Callable:
    """``run_n(n)``: runs ``fn(state, arg)`` n times back to back and
    returns the last call's output (the reference's ``make_chained_runner``,
    its ``harness/driver.py:75-100``).

    On a CUDA device, ``fn`` first runs ``WARMUP_CALLS`` times eagerly on a
    side stream, as torch's CUDA graph documentation asks, so that every
    one-time setup of the kernels (their ``cudaFuncSetAttribute``, module
    loading) is done before the capture.  Then one ``torch.cuda.CUDAGraph``
    captures ``chain`` calls in a row and another one call; ``run_n(n)``
    replays the first n // chain times and the second n % chain times.  A
    graph captured from one stream runs its calls in order, and a replayed
    launch is never merged with another, so the port leaves out the
    reference's perturbation of x by out[0]·tiny, which only stops XLA from
    merging repeated calls: every replay runs the whole chain on the same
    ``arg``.  A capture that fails raises ``CaptureError`` naming ``name``
    (the format); nothing falls back to eager calls.

    The wrappers count a launch when they launch a kernel, so their
    counters (``launches``, and those ``busy_seconds`` reads) rise by the
    warm-up and the captured calls, never by a replay.

    On the CPU ``run_n`` is a plain host loop."""
    device = arg.device
    if device.type != "cuda":
        def run_n(n: int):
            out = None
            for _ in range(n):
                out = fn(state, arg)
            return out
        return run_n

    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(WARMUP_CALLS):
            fn(state, arg)
    torch.cuda.current_stream(device).wait_stream(side)
    torch.cuda.synchronize(device)
    graphs = {}
    for k in sorted({1, max(int(chain), 1)}):
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                for _ in range(k):
                    out = fn(state, arg)
        except Exception as e:
            raise CaptureError(
                f"{name or getattr(fn, '__name__', 'fn')}: the CUDA graph "
                f"capture of {k} chained calls failed: {type(e).__name__}: "
                f"{e}") from e
        graphs[k] = (graph, out)
    k_top = max(graphs)

    def run_n(n: int):
        out = None
        q, r = divmod(int(n), k_top)
        for k, times in ((k_top, q), (1, r)):
            graph, res = graphs[k]
            for _ in range(times):
                graph.replay()
                out = res
        return out

    return run_n


def runner_clock(run_n: Callable, device: torch.device) -> Callable:
    """``timed(n)``: seconds of ``run_n(n)`` on ``device``'s clock."""
    return lambda n: device_seconds(lambda: run_n(n), device)


def marginal(timed: Callable, loop: int, half: int) -> float:
    """Seconds per call from two timed runs, (t(loop) − t(half)) /
    (loop − half); where the margin is not positive, the average of both
    runs, (t(loop) + t(half)) / (loop + half) (reference :246-265)."""
    t_half = timed(half)
    t_full = timed(loop)
    margin = t_full - t_half
    if margin > 0:
        return margin / (loop - half)
    return (t_full + t_half) / (loop + half)


def trial_seconds(timed: Callable, loop: int) -> float:
    """One trial of the reference's run loop: the marginal of ``loop`` and
    ``loop // 2`` calls, or below 8 calls the plain average of one run."""
    if loop >= 8:
        return marginal(timed, loop, loop // 2)
    return timed(loop) / loop


def calibrate_loop(timed: Callable, window: float, max_loop: int) -> int:
    """The loop count, doubled from 1 until a run of it lasts ``window``
    seconds or reaches ``max_loop`` (reference :222-235)."""
    loop = 1
    while loop < max_loop:
        if timed(loop) >= window:
            break
        loop *= 2
    return loop


def median_seconds(timed: Callable, loop: int, n_trials: int) -> float:
    """The median of ``n_trials`` trials (reference :271): a hiccup in
    either run of one trial moves it, not the median."""
    pers = [trial_seconds(timed, loop) for _ in range(n_trials)]
    return float(np.median(pers)) if pers else float("inf")


def marginal_seconds(fn, state, x, device: torch.device, window: float,
                     name: str = "") -> float:
    """Seconds per call of ``fn(state, x)``: the median of 3 marginals of
    chained runs (``make_chained_runner``) of ``loop`` and ``loop // 2``
    calls, with ``loop`` doubled from 2 until one run lasts ``window``
    seconds (the reference's trial timing,
    ``singlespmv_tpu/formats/auto.py:345-375``)."""
    timed = runner_clock(make_chained_runner(fn, state, x, name=name), device)
    loop = 2
    while loop < (1 << 16):
        if timed(loop) >= window:
            break
        loop *= 2
    return float(np.median([marginal(timed, loop, max(loop // 2, 1))
                            for _ in range(3)]))


def best_marginal_seconds(run_n, carry, consts=(), *, target_s,
                          trials=3) -> float:
    """Seconds per iteration of ``run_n(carry, n, *consts)``: the best of
    ``trials`` marginals t(n) − t(n/2), with n doubled from 4 until one
    loop lasts ``target_s`` (the reference microbenchmarks' ``_time``,
    ``singlespmv_tpu/harness/microbench.py``)."""
    def loop(n):
        return device_seconds(lambda: run_n(carry, n, *consts), carry.device)

    loop(1)
    n = 4
    while True:
        if loop(n) >= target_s or n >= (1 << 20):
            break
        n *= 2
    return min(marginal(loop, n, n // 2) for _ in range(trials))


SPIN = "spin_kernel"        # torch.cuda._sleep's kernel
SPIN_LEAD = 256             # spin kernels that lead a trace
SPIN_MARK_CYCLES = 2_000    # ~1 µs of the card's clock


def device_trace(fn, match: str = "", reps: int = 1) -> tuple:
    """([events of each call], µs) of a torch.profiler trace (host and card
    activity) of ``reps`` calls of ``fn``: the device events (each kernel,
    memset and copy is one) whose name holds ``match``, counted call by
    call, and their device time.  A ~1 µs spin kernel (``torch.cuda.
    _sleep``, never counted) marks the start of each call and the end of
    the last, so the events of a call are those between two marks.  A trace
    drops its first device events, more of them the longer the process has
    run (``harness/trace_check.py``), so ``SPIN_LEAD`` spins lead it; a
    call whose marks were lost is missing from the list."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(SPIN_LEAD):
            torch.cuda._sleep(SPIN_MARK_CYCLES)
        for _ in range(reps):
            torch.cuda._sleep(SPIN_MARK_CYCLES)
            fn()
        torch.cuda._sleep(SPIN_MARK_CYCLES)
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    marks = [i for i, e in enumerate(events) if SPIN in e.name][-reps - 1:]
    counts, us = [], 0.0
    for a, b in zip(marks, marks[1:]):
        call = [e for e in events[a + 1:b] if match in e.name]
        counts.append(len(call))
        us += sum(e.self_device_time_total for e in call)
    return counts, us


def trace_refusal(counts: list, reps: int,
                  launched: Optional[int] = None) -> Optional[str]:
    """Why a trace of ``reps`` calls is incomplete, or None when it is
    complete.  ``counts`` holds the matched device events of each call the
    trace delimits; ``launched``, where the calls run the port's own
    kernels, is what their wrappers' launch counters rose by a call.  A
    trace counts only when it delimits all ``reps`` calls and each holds
    the same n₁ > 0 events, n₁ = ``launched`` where given: ``reps · n₁`` in
    all.  A trace that lost events would read the time low."""
    if len(counts) != reps:
        return f"{len(counts)} of {reps} calls delimited"
    if len(set(counts)) > 1:
        return f"calls hold {min(counts)} to {max(counts)} events"
    if not counts[0]:
        return "no call holds a matched event"
    if launched is not None and counts[0] != launched:
        return (f"each call matched {counts[0]} events where the wrappers "
                f"launched {launched} kernels")
    return None


def busy_seconds(fn, match: str = "", reps: int = 20, launches=None,
                 attempts: int = 3, log=print) -> Optional[float]:
    """Seconds per call that the device spends in the events ``match``
    selects (``device_trace``), from the first complete trace of ``reps``
    calls (``trace_refusal``) in ``attempts``; None when none was complete.
    ``launches``, a function of no argument, gives the launch count of the
    wrappers whose kernels ``match`` names.  Raises ``TraceError`` where
    every call of a trace holds the same events but not as many as the
    wrappers launched (the match is wrong), and where a complete trace
    holds no device time."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        before = launches() if launches is not None else None
        counts, us = device_trace(fn, match, reps)
        launched = None
        if launches is not None:
            delta = launches() - before
            launched = delta // reps if delta % reps == 0 else delta / reps
        why = trace_refusal(counts, reps, launched)
        if why is None:
            if us <= 0:
                raise TraceError(f"a complete trace of {reps} calls "
                                 f"matching {match!r} holds no device time")
            return us / reps / 1e6
        if launched is not None and len(counts) == reps \
                and len(set(counts)) == 1 and 0 < counts[0] != launched:
            raise TraceError(f"{match!r}: {why}")
        log(f"trace {attempt + 1} of {attempts} for {match!r} refused: "
            f"{why}")
    return None


@contextlib.contextmanager
def profiler_trace(trace_dir: str, device: torch.device, name: str):
    """A ``torch.profiler`` trace of the block (host activity, and the
    card's on a CUDA device), exported as a Chrome trace
    ``<name>.<pid>.<ns>.pt.trace.json`` into ``trace_dir``: the port's
    ``jax.profiler.trace(trace_dir)`` (reference :242-245)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    safe = "".join(c if c.isalnum() or c in "-_." else "_" for c in name)
    prof.export_chrome_trace(os.path.join(
        trace_dir, f"{safe}.{os.getpid()}.{time.time_ns()}.pt.trace.json"))


def run_benchmark(
    matrix,                      # path or COOMatrix
    cfg: Config = None,
    *,
    x: Optional[np.ndarray] = None,
    name: Optional[str] = None,
    quick: bool = False,         # skip calibration (tests): 1 trial × 3 calls
    trace_dir: Optional[str] = None,   # torch.profiler trace of the trials
    cache_dir: Optional[str] = None,   # converted-state cache
    #                                    (formats/cache.py): OptimizeTime then
    #                                    measures the cache load
    device="cuda",
    log=lambda msg: print(msg, file=sys.stderr),
) -> BenchResult:
    cfg = cfg or Config()
    # a host library baseline (hostlib) declares the CPU: its state and x
    # go there and the chained runner is a host loop, whatever ``device``
    # says, as the reference's driver places it (its :155-164)
    preferred = getattr(formats.get_format(cfg.format), "PREFERRED_DEVICE",
                        None)
    device = device_of(device) if preferred is None \
        else torch.device(preferred)
    if isinstance(matrix, COOMatrix):
        coo, mat_name = matrix, (name or "in-memory")
    else:
        mat_name = name or get_basename(matrix)
        log(f"Loading matrix {matrix} ...")
        coo = load_matrix(matrix, cfg)

    if x is None:
        x = create_random_vector(coo.n_col)     # deterministic, seed 3
    xd = value_tensor(x, cfg.dtype).to(device)   # bfloat16: x rounded

    # --- OptimizeProblem: host convert (or the cache's load) plus the move
    # to the device; under format=auto an engine that refuses at its first
    # calls is excluded and auto plans again ---
    spmv = formats.spmv_fn(cfg)
    excluded = []
    for attempt in range(AUTO_ATTEMPTS):
        log(f"{mat_name}: convert (format={cfg.format}) ...")
        t0 = time.perf_counter()
        if cache_dir:
            from ..formats.cache import convert_cached

            state = convert_cached(coo, cfg, cache_dir, mat_name,
                                   device=device, log=log)
        elif cfg.format == "auto":
            state = formats.get_format("auto").convert(
                coo, cfg, device=device, log=log).to(device)
        else:
            state = formats.convert(coo, cfg).to(device)
        _sync(device)
        optimize_s = time.perf_counter() - t0
        try:
            t0 = time.perf_counter()
            y = spmv(state, xd)
            _sync(device)
            compile_s = time.perf_counter() - t0   # first call: build/load
            log(f"{mat_name}: converted in {optimize_s:.1f}s, "
                f"first call {compile_s:.1f}s")

            # --- verify twice (catches operand corruption) ---
            verify_ok, vdetails = True, {}
            if cfg.verify:
                for trial in range(2):
                    y = spmv(state, xd)
                    ok, vdetails = verify_result(coo, x, to_host(y),
                                                 dtype=cfg.dtype)
                    verify_ok = verify_ok and ok
                    if not ok:
                        log(f"VERIFY FAILED (pass {trial}): {vdetails}")
            break
        except GUARD_ERRORS as e:
            chosen = getattr(state, "chosen", None)
            if cfg.format != "auto" or attempt == AUTO_ATTEMPTS - 1:
                raise
            first = str(e).strip().splitlines()[0][:300] if str(e) else ""
            log(f"{mat_name}: {chosen} died at first run "
                f"({type(e).__name__}: {first}); excluding and re-planning")
            excluded.append(f"{chosen}: {type(e).__name__}: "
                            + first.replace(";", ","))
            cfg = cfg.replace(auto_exclude=cfg.auto_exclude + (chosen,))
            del state

    label = cfg.format + (f"/{state.chosen}" if cfg.format == "auto" else "")

    def clock(fn, arg, what):
        return runner_clock(make_chained_runner(
            fn, state, arg, name=f"{mat_name} {label}{what}"), device)

    # --- calibration: double the loop until a chained run takes
    # calibrate_seconds (the runner's capture is not timed) ---
    timed = clock(spmv, xd, "")
    if quick:
        loop, n_trials = 3, 1
    else:
        loop = calibrate_loop(timed, cfg.calibrate_seconds, cfg.max_loop)
        n_trials = cfg.n_trials

    # --- median of n_trials marginal trials ---
    tracer = (profiler_trace(trace_dir, device, f"{mat_name}-{cfg.format}")
              if trace_dir else contextlib.nullcontext())
    with tracer:
        best = median_seconds(timed, loop, n_trials)
    del timed
    flops = 2.0 * coo.nnz
    gflops = flops / best / 1e9 if best > 0 else 0.0

    # --- per-phase profile: each phase's input is the previous phase's
    # output, and each phase has a chained runner of its own ---
    phase_perf: Dict[str, float] = {}
    phases = phases_fn(cfg)
    ph = phases(state) if (cfg.profiling and phases) else None
    if ph:
        inputs, cur = {}, xd
        for pname, fn in ph.items():
            inputs[pname] = cur
            cur = fn(state, cur)
        for pname, fn in ph.items():
            phase_perf[pname] = trial_seconds(
                clock(fn, inputs[pname], f" phase {pname}"), loop)
        del inputs, cur

    # --- per-step timing of the scan tree (reference :304-325) ---
    step_perf = {}
    if cfg.measure_step_time:
        mod = formats.get_format(cfg.format)
        sfns = getattr(mod, "step_fns", None)
        sinit = getattr(mod, "step_init", None)
        if sfns and sinit:
            vf = sinit(state, xd)
            step_loop = max(loop, 8)
            for sname, fn in sfns(state):
                step_perf[sname] = trial_seconds(
                    clock(fn, vf, f" step {sname}"), step_loop)
                vf = fn(state, vf)
            del vf

    chip = detect_chip(device)
    traffic = formats.traffic_bytes(state, cfg)
    roof = roofline(traffic, coo.nnz, best, chip)
    # the format's own cost model at the converted plan, as in the reference;
    # slab's prices with chipconst, which holds no H100 constants yet
    att_fn = getattr(formats.get_format(cfg.format), "attainable_seconds",
                     None)
    att_s = (att_fn(state, cfg) if att_fn else None) or roof["SolTime(s)"]
    roof["AttainableTime(s)"] = att_s
    roof["AttainablePct"] = 100.0 * att_s / best if att_s and best > 0 \
        else None

    report: Dict[str, object] = {
        "Matrix": mat_name,
        "Architecture": "GPU" if device.type == "cuda" else "CPU",
        "MatrixFormat": FORMAT_NAMES.get(cfg.format, cfg.format.upper()),
        "Variant": cfg.variant.upper(),
        "Dtype": cfg.dtype,
    }
    report.update(formats.report_fields(state, cfg))
    if preferred is not None:
        report["PreferredDevice"] = preferred
    if cfg.format == "auto":
        report["AutoExcluded"] = "; ".join(excluded) or "none"
    report.update({
        "nRow": coo.n_row,
        "nCol": coo.n_col,
        "nNnz": coo.nnz,
        "LoopCount": loop,
        "Time(s)": best,
        "Performance(GFLOPS)": gflops,
    })
    if phase_perf:
        # MulPerf/SumPerf: Sum is every phase but Mul, one flop a phase
        mul_s = phase_perf.get("Mul", 0.0)
        sum_s = sum(v for k, v in phase_perf.items() if k != "Mul")
        if mul_s > 0:
            report["MulPerf"] = flops / mul_s / 1e9 / 2
        if sum_s > 0:
            report["SumPerf"] = flops / sum_s / 1e9 / 2
        for pname, sec in phase_perf.items():
            report[f"PhaseTime-{pname}(s)"] = sec
    for sname, sec in step_perf.items():
        report[f"StepTime-{sname}"] = sec
    report.update(roof)
    report.update({
        "OptimizeTime(s)": optimize_s,
        "CompileTime(s)": compile_s,
        "nDevice": torch.cuda.device_count() if device.type == "cuda" else 1,
        "Verify": "PASS" if (cfg.verify and verify_ok) else
                  ("FAIL" if cfg.verify else "SKIPPED"),
    })
    if cfg.verify and vdetails:
        report["MaxAbsErr"] = vdetails["max_abs_err"]
        report["MaxRelErr"] = vdetails["max_rel_err"]

    return BenchResult(report=report, gflops=gflops, seconds=best, loop=loop,
                       verify_ok=verify_ok, y=to_host(y))
