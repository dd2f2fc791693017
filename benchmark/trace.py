"""Reading a torch.profiler trace of the window: the spin marks of the
port's ``harness/driver.py`` (``device_trace``, ``trace_refusal``), copied
here so that no change to the program moves them, and what the metrics
take from a complete trace.

A trace drops its first device events, more of them the longer the
process has run, so ``SPIN_LEAD`` ~1 µs spin kernels lead it.  Each
request is cut into segments by one more spin at each segment's start
(``mark``) and one after the last request: the device events between two
marks are that segment's.  A trace counts only when it delimits every
segment and each segment of a kind holds the same number of events, more
than none for the kind ``product``."""
from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from benchmark.yardstick import kernel_of, op_name

SPIN = "spin_kernel"        # torch.cuda._sleep's kernel
SPIN_LEAD = 256             # spin kernels that lead a trace
SPIN_MARK_CYCLES = 2_000    # ~1 µs of the card's clock
SHORT_GAP_US = 10.0         # idle gaps shorter than this are pooled


def mark():
    torch.cuda._sleep(SPIN_MARK_CYCLES)


@contextlib.contextmanager
def profiled():
    """A profiler over host and card activity, led by ``SPIN_LEAD``
    spins; yields the profile, whose events are read after the block."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(SPIN_LEAD):
            mark()
        yield prof
        mark()
        torch.cuda.synchronize()


def refusal(kinds: list, counts: list) -> Optional[str]:
    """Why segments of ``kinds`` holding ``counts`` events are no complete
    trace, or None (``harness/driver.py:trace_refusal``)."""
    if len(counts) != len(kinds):
        return f"{len(counts)} of {len(kinds)} segments delimited"
    for kind in sorted(set(kinds)):
        got = {c for k, c in zip(kinds, counts) if k == kind}
        if len(got) > 1:
            return f"{kind} segments hold {min(got)} to {max(got)} events"
        if kind == "product" and not got.pop():
            return "no product segment holds a device event"
    return None


def _union_us(spans) -> float:
    """Length of the union of (start, end) intervals, µs."""
    total, end = 0.0, -np.inf
    for a, b in sorted(spans):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def read(prof, kinds: list, port_kernels: frozenset) -> dict:
    """What the metrics take from a trace of segments of ``kinds``: the
    window (from the first request's host span to the last's end), the
    device's busy time in it, each kind's busy time and the share of it in
    the port's own kernels, the device operations that took most time and
    the idle gaps by what the host was doing.  ``refused`` says why the
    trace is incomplete, where it is."""
    from torch.autograd import DeviceType

    events = prof.events()
    # the device's operations; the profiler also puts each host span on
    # the device's timeline as an annotation, which is no operation
    dev = sorted((e for e in events if e.device_type == DeviceType.CUDA
                  and not e.name.startswith("bench.")),
                 key=lambda e: e.time_range.start)
    host = [e for e in events if e.device_type == DeviceType.CPU]
    marks = [i for i, e in enumerate(dev) if SPIN in e.name]
    marks = marks[-len(kinds) - 1:]
    counts, by_kind = [], {}
    for kind, a, b in zip(kinds, marks, marks[1:]):
        seg = dev[a + 1:b]
        counts.append(len(seg))
        by_kind.setdefault(kind, []).extend(seg)
    out = {"refused": refusal(kinds, counts)}
    if out["refused"]:
        return out
    reqs = [e for e in host if e.name == "bench.request"]
    out["requests"] = len(reqs)
    t0 = min(e.time_range.start for e in reqs)
    t1 = max(e.time_range.end for e in reqs)
    work = [e for e in dev if SPIN not in e.name
            and e.time_range.start < t1 and e.time_range.end > t0]
    spans = [(max(e.time_range.start, t0), min(e.time_range.end, t1))
             for e in work]
    out["window_s"] = (t1 - t0) / 1e6
    out["busy_s"] = _union_us(spans) / 1e6
    for kind, seg in by_kind.items():
        own = [e for e in seg if kernel_of(e.name) in port_kernels]
        out[f"{kind}_busy_s"] = _union_us(
            (e.time_range.start, e.time_range.end) for e in seg) / 1e6
        out[f"{kind}_port_s"] = _union_us(
            (e.time_range.start, e.time_range.end) for e in own) / 1e6
        out[f"{kind}_segments"] = kinds.count(kind)
    ops = {}
    for e in work:
        name = op_name(e.name)[:160]
        ops[name] = ops.get(name, 0.0) + (e.time_range.end
                                          - e.time_range.start) / 1e6
    out["device_ops"] = sorted(([k, v] for k, v in ops.items()),
                               key=lambda kv: -kv[1])[:10]
    out["idle_gaps"] = _gaps(spans, host, t0, t1)
    return out


def _gaps(spans, host, t0, t1) -> list:
    """Idle time of the device in [t0, t1] by what the host was doing at
    each gap's middle: the benchmark's innermost ``bench.*`` span, and
    within it the innermost host event (an operator or a runtime call).
    Gaps under ``SHORT_GAP_US`` are pooled under one name."""
    gaps, end = [], t0
    for a, b in sorted(spans):
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if t1 > end:
        gaps.append((end, t1))
    if not gaps:
        return []
    hs = np.array([e.time_range.start for e in host], dtype=np.float64)
    he = np.array([e.time_range.end for e in host], dtype=np.float64)
    bench = np.array([e.name.startswith("bench.") for e in host])
    names = [e.name for e in host]
    out = {}
    for a, b in gaps:
        if b - a < SHORT_GAP_US:
            label = f"gaps under {SHORT_GAP_US:g} us"
        else:
            mid = (a + b) / 2
            cover = (hs <= mid) & (he >= mid)
            label = "outside any host span"
            for sel in (cover & bench, cover & ~bench):
                if sel.any():
                    i = int(np.flatnonzero(sel)[np.argmax(hs[sel])])
                    label = (names[i] if label.startswith("outside")
                             else f"{label} / {names[i]}")
        out[label] = out.get(label, 0.0) + (b - a) / 1e6
    return sorted(([k, v] for k, v in out.items()),
                  key=lambda kv: -kv[1])[:10]
