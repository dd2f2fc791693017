"""Benchmark driver: ``singlespmv_tpu/harness/driver.py``'s ``run_benchmark``
for PyTorch on one GPU.

    load → convert (OptimizeTime, the move to the device included) → first
    call (CompileTime) → verify twice against the float64 COO oracle →
    calibrate the loop count by doubling until a loop takes
    ``calibrate_seconds`` → median of ``n_trials`` timed loops → report block
    with the reference key schema.

A timed loop is ``loop`` back-to-back spmv calls between two CUDA events, so
it measures the device's time for the whole call, glue included; on the CPU a
host clock stands in.  ``device`` defaults to "cuda" and a run with no GPU
raises; the CPU runs the kernels' plain versions only when asked for by
``device="cpu"``.

With ``format="auto"`` the driver retries as the reference's does
(``singlespmv_tpu/harness/driver.py:168-220``): a chosen engine that refuses
at its first calls with a guard error (``ValueError``, ``TypeError``,
``MemoryError``, a CUDA out-of-memory error) is excluded
(``cfg.auto_exclude``) and auto plans again; the exclusions are reported as
``AutoExcluded``.  A ``KernelError`` is never a reason to exclude: it stops
the run.

Not ported yet (ROADMAP A.2): profiling phases, step timing and the state
cache.
"""
from __future__ import annotations

import dataclasses
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..config import Config
from ..core.mmio import load_matrix as _load_mtx
from ..core.oracle import verify_result
from ..core.rng import create_random_vector
from ..core.types import COOMatrix

from .. import formats
from ..formats.auto import GUARD_ERRORS
from .report import FORMAT_NAMES, format_block, get_basename
from .roofline import detect_chip, roofline

AUTO_ATTEMPTS = 4      # plans of format=auto, each excluding the last refusal


class TraceError(RuntimeError):
    """A profiler trace that no busy time can be read from: its match is
    wrong, or it is complete and holds no device time."""


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


def _time_loop(spmv, state, x, loop: int, device: torch.device) -> float:
    """Seconds for ``loop`` back-to-back calls."""
    def calls():
        for _ in range(loop):
            spmv(state, x)

    return device_seconds(calls, device)


def marginal_seconds(fn, state, x, device: torch.device,
                     window: float) -> float:
    """Seconds per call of ``fn(state, x)``: the median of 3 marginals, each
    the difference of two timed loops (``loop`` and ``loop // 2`` calls),
    with ``loop`` doubled until one loop lasts ``window`` seconds (the
    reference's trial timing, ``singlespmv_tpu/formats/auto.py:345``)."""
    fn(state, x)
    loop = 2
    while loop < (1 << 16):
        if _time_loop(fn, state, x, loop, device) >= window:
            break
        loop *= 2
    pers = []
    for _ in range(3):
        half = max(loop // 2, 1)
        t_half = _time_loop(fn, state, x, half, device)
        t_full = _time_loop(fn, state, x, loop, device)
        margin = t_full - t_half
        pers.append(margin / (loop - half) if margin > 0
                    else (t_full + t_half) / (loop + half))
    return float(np.median(pers))


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
    best = float("inf")
    for _ in range(trials):
        t_half = loop(n // 2)
        t_full = loop(n)
        margin = t_full - t_half
        per = margin / (n - n // 2) if margin > 0 \
            else (t_full + t_half) / (n + n // 2)
        best = min(best, per)
    return best


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


def run_benchmark(
    matrix,                      # path or COOMatrix
    cfg: Config = None,
    *,
    x: Optional[np.ndarray] = None,
    name: Optional[str] = None,
    quick: bool = False,         # skip calibration (tests): 1 trial × 3 calls
    device="cuda",
    log=lambda msg: print(msg, file=sys.stderr),
) -> BenchResult:
    cfg = cfg or Config()
    device = device_of(device)
    if isinstance(matrix, COOMatrix):
        coo, mat_name = matrix, (name or "in-memory")
    else:
        mat_name = name or get_basename(matrix)
        log(f"Loading matrix {matrix} ...")
        coo = load_matrix(matrix, cfg)

    if x is None:
        x = create_random_vector(coo.n_col)     # deterministic, seed 3
    x_host = np.asarray(x, dtype=cfg.np_dtype)
    xd = torch.from_numpy(x_host).to(device)

    # --- OptimizeProblem: host convert plus the move to the device; under
    # format=auto an engine that refuses at its first calls is excluded and
    # auto plans again ---
    spmv = formats.spmv_fn(cfg)
    excluded = []
    for attempt in range(AUTO_ATTEMPTS):
        log(f"{mat_name}: convert (format={cfg.format}) ...")
        t0 = time.perf_counter()
        if cfg.format == "auto":
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
                    ok, vdetails = verify_result(coo, x, y.cpu().numpy(),
                                                 dtype=cfg.np_dtype)
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

    # --- calibration: double the loop until one takes calibrate_seconds ---
    if quick:
        loop, n_trials = 3, 1
    else:
        loop, n_trials = 1, cfg.n_trials
        while loop < cfg.max_loop:
            if _time_loop(spmv, state, xd, loop, device) \
                    >= cfg.calibrate_seconds:
                break
            loop *= 2

    # --- median of n_trials timed loops ---
    pers = [_time_loop(spmv, state, xd, loop, device) / loop
            for _ in range(n_trials)]
    best = float(np.median(pers))
    flops = 2.0 * coo.nnz
    gflops = flops / best / 1e9 if best > 0 else 0.0

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
                       verify_ok=verify_ok, y=y.cpu().numpy())
