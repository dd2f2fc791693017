"""How often a torch.profiler trace loses device events on the card as a
process ages: plain traces of one call and of 20, and the traces that
``driver.busy_seconds`` reads (``driver.device_trace``).

    python -m singlespmv_tpu_torch.harness.trace_check [seconds]   # a GPU

For ``seconds`` (default 150) it takes rounds, 5 s apart, of a small kernel
(``x.mul_(1.0)`` over 1 M floats, one device event a call): 10 plain traces
(host and card activity) of one call, 10 of 20 calls, and 10
``device_trace`` traces of 20 calls.  Per round it prints how many of each
came back incomplete (plain: fewer events than calls; ``device_trace``:
refused by ``driver.trace_refusal``), and at the end the totals, with the
card's name and power limit.
"""
from __future__ import annotations

import subprocess
import sys
import time

import torch

from .driver import device_trace, trace_refusal

TRACES, REPS, PAUSE_S = 10, 20, 5.0


def plain_events(fn, reps: int) -> int:
    """Device events in a plain trace of ``reps`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_type == DeviceType.CUDA for e in prof.events())


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    seconds = float(args[0]) if args else 150.0
    if not torch.cuda.is_available():
        raise SystemExit("trace_check needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    x = torch.ones(1 << 20, device="cuda")
    fn = lambda: x.mul_(1.0)
    fn()
    torch.cuda.synchronize()
    kinds = ("plain, 1 call", f"plain, {REPS} calls", f"device_trace, "
             f"{REPS} calls")
    total = dict.fromkeys(kinds, 0)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        short = dict.fromkeys(kinds, 0)
        for _ in range(TRACES):
            short[kinds[0]] += plain_events(fn, 1) != 1
            short[kinds[1]] += plain_events(fn, REPS) != REPS
            counts, _ = device_trace(fn, "", REPS)
            short[kinds[2]] += trace_refusal(counts, REPS, 1) is not None
        for k in kinds:
            total[k] += short[k]
        print(f"t {time.perf_counter() - t0:6.1f} s | incomplete of "
              f"{TRACES}: " + ", ".join(f"{k} {v}" for k, v in short.items()),
              flush=True)
        time.sleep(PAUSE_S)
    print("incomplete in all: " + ", ".join(f"{k} {v}"
                                            for k, v in total.items()),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
