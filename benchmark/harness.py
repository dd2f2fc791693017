"""One run of one cell: set-up, the measured window, the check.

Everything a cell is made of is found by name: the workload's entry in
``BENCHMARK.json`` names a configuration (``configs/<name>.json``, whose
``structure`` names a generator in ``structures/``) and a traffic mix
(``traffic/<name>.json``, whose ``kind`` names a driver in ``kinds/``);
its limits are ``checks/<workload>.json``; each metric is a reader
``metrics/<name>.py``, or, where there is none, ``metrics/<stem>.py``, the
name up to its first dot (``idle_pct.solve`` reads as ``idle_pct``, under
its own entry).  A cell is added by adding files and an entry, never
by editing one.

A run:

1. set-up (``setup_s``, counted from the process's start, less the
   seconds the plain reference spends making inputs): the matrix from the
   configuration and the seed, the program's convert and its move to the
   device (``convert_s``), the traffic's inputs, its warm-up (a CUDA graph
   captured, one request run);
2. the window: requests back to back, one client, each ending in a
   synchronisation, until ``seconds`` have passed.  With ``trace`` it
   yields the per-layer metrics instead of the end-to-end ones: the whole
   window as it is, for the host clock's metrics, then at most
   ``TRACE_SECONDS`` more under the profiler, each request cut into
   spin-marked segments (``trace.py``), for the device's;
3. the peak of device memory read, the program's state freed, then the
   kept answers (a reservoir sample, drawn from the seed, of every request
   in the window) judged against the plain reference, each number beside
   its limit.
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import random
import sys
import time

import torch

from benchmark import reference, trace, yardstick

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
TRACE_SECONDS = 0.5     # the longest traced window
TRACE_ATTEMPTS = 3      # traced windows tried for a complete trace
FORBIDDEN = ("jax", "jaxlib", "flax", "singlespmv_tpu")


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(workload: str, bench_dir: str = BENCH_DIR,
         spec_path: str = None) -> dict:
    """The workload's entry, its configuration and traffic files, its
    limits and the metrics it reports, all found by name."""
    spec = _json(spec_path or os.path.join(os.path.dirname(bench_dir),
                                           "BENCHMARK.json"))
    entry = {w["name"]: w for w in spec["workloads"]}[workload]
    ends = [m["name"] for m in spec["end_to_end"]
            if workload in m.get("workloads", [workload])]
    layers = [m["name"] for m in spec["per_layer"]
              if (workload in m["workloads"] if "workloads" in m
                  else m["moves"] in ends)]
    return {
        "workload": workload,
        "config": _json(os.path.join(bench_dir, "configs",
                                     entry["config"] + ".json")),
        "traffic": _json(os.path.join(bench_dir, "traffic",
                                      entry["traffic"] + ".json")),
        "limits": _json(os.path.join(bench_dir, "checks",
                                     workload + ".json")),
        "chips": int(entry["chips"]),
        "end_to_end": ends,
        "per_layer": layers,
        "units": {m["name"]: m["unit"]
                  for m in spec["end_to_end"] + spec["per_layer"]},
        "bench_dir": bench_dir,
    }


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``,
    compared whole."""
    return sorted({m.split(".", 1)[0] for m in sys.modules}
                  & set(FORBIDDEN))


class Run:
    """The state of one run, which the traffic kinds act through."""

    def __init__(self, c: dict, seed: int, device, port, dtype=None,
                 t_start=None):
        self.c, self.device, self.port = c, torch.device(device), port
        self.t_start = time.perf_counter() if t_start is None else t_start
        self.conf, self.spec = c["config"], c["traffic"]
        self.dtype = dtype or self.conf["dtype"]
        self.seed = int(seed) % (1 << 63)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(self.seed)
        self.tracing = False
        self.kinds = []
        self.reference_s = 0.0

    def synchronize(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def span(self, name: str):
        """A host span of the benchmark's own, seen in a trace."""
        if self.tracing:
            with torch.profiler.record_function(name):
                yield
        else:
            yield

    @contextlib.contextmanager
    def segment(self, kind: str, name: str):
        """A host span whose device work a spin mark delimits in a
        trace."""
        if self.tracing:
            self.kinds.append(kind)
            trace.mark()
        with self.span(name):
            yield

    @contextlib.contextmanager
    def reference_work(self):
        """The plain reference's work in set-up, whose seconds
        ``setup_s`` leaves out."""
        t0 = time.perf_counter()
        yield
        self.synchronize()
        self.reference_s += time.perf_counter() - t0

    def setup(self, traced: bool = False):
        bench = self.c["bench_dir"]
        build = _load(os.path.join(bench, "structures",
                                   self.conf["structure"] + ".py"),
                      "structure_" + self.conf["structure"])
        self.matrix = build.build(self.conf, self.seed, self.device)
        kind = _load(os.path.join(bench, "kinds", self.spec["kind"] + ".py"),
                     "kind_" + self.spec["kind"])
        columns = int(self.spec.get("columns", 1))
        t0 = time.perf_counter()
        self.cfg, self.state = self.port.convert(
            self.matrix, fmt=self.conf["format"], dtype=self.dtype,
            spmm_b=columns if columns > 1 else 0, device=self.device)
        self.synchronize()
        self.convert_s = time.perf_counter() - t0
        self.engine = self.port.engine(self.cfg, self.state)
        self.traffic = kind.Traffic(self, self.spec)
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        self.traffic.warm(traced)
        self.synchronize()
        self.setup_s = (time.perf_counter() - self.t_start
                        - self.reference_s)

    def window(self, seconds: float, picks: random.Random, done: list):
        """Requests until ``seconds`` have passed; (seconds, requests
        completed, failures)."""
        t0 = time.perf_counter()
        t_end, n, failed = t0, 0, 0
        while time.perf_counter() - t0 < seconds:
            i = len(done)
            slot = i if i < self.traffic.sample else picks.randrange(i + 1)
            slot = slot if slot < self.traffic.sample else None
            try:
                with self.span("bench.request"):
                    info = self.traffic.request(i, slot)
            except Exception as e:      # a request that never comes
                print(f"request {i} failed: {type(e).__name__}: {e}",
                      file=sys.stderr)
                failed += 1
                break
            t_end = time.perf_counter()
            done.append(info)
            n += 1
        return t_end - t0, n, failed


def run(workload: str, seed: int, seconds: float, traced: bool, *,
        device="cuda", port=None, dtype=None, bench_dir=BENCH_DIR,
        spec_path=None, t_start=None) -> dict:
    """One run of ``workload``: the result line's object, and the numbers
    compared with their limits last (``check``)."""
    from benchmark.program import CSRC, Port

    c = cell(workload, bench_dir, spec_path)
    r = Run(c, seed, device, port or Port(), dtype, t_start)
    r.setup(traced and r.device.type == "cuda")
    picks = random.Random(r.seed)
    done = []
    tr = None
    span_s, n, failed = r.window(seconds, picks, done)
    untraced = list(done)
    if traced and not failed and r.device.type == "cuda":
        for attempt in range(TRACE_ATTEMPTS):
            r.kinds, r.tracing = [], True
            with trace.profiled() as prof:
                _, _, failed = r.window(min(seconds, TRACE_SECONDS), picks,
                                        done)
            r.tracing = False
            tr = trace.read(prof, r.kinds, yardstick.kernel_names(CSRC))
            del prof
            if not tr["refused"] or failed:
                break
            print(f"trace {attempt + 1} of {TRACE_ATTEMPTS} refused: "
                  f"{tr['refused']}", file=sys.stderr)
    peak = (torch.cuda.max_memory_allocated(r.device)
            if r.device.type == "cuda" else 0)
    # the program's state freed before the reference runs
    r.traffic.free()
    r.state = None
    gc.collect()
    if r.device.type == "cuda":
        torch.cuda.empty_cache()

    op = reference.Operator(r.matrix, r.device)
    numbers = r.traffic.check(op)
    del op
    check = {k: {"value": v, "limit": c["limits"][k]}
             for k, v in numbers.items()}
    attempted = len(done) + failed
    correct = (failed == 0 and attempted > 0
               and all(v["value"] <= v["limit"] for v in check.values()))

    m = r.matrix
    products = n * r.traffic.products_per_request
    ctx = {
        "run": r, "requests": untraced, "products": products,
        "window_s": span_s, "trace": tr, "peaks": None,
        "csr_min_bytes": yardstick.csr_min_bytes(
            m.n_row, m.n_col, m.nnz, r.dtype, r.traffic.columns),
    }
    if r.device.type == "cuda":
        ctx["peaks"] = yardstick.peaks(torch.cuda.get_device_name(r.device))
    metrics = {}
    for name in c["per_layer"] if traced else c["end_to_end"]:
        v = reader(bench_dir, name).read(ctx)
        if v is not None:
            metrics[name] = {"value": v, "unit": c["units"][name]}
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics,
           "device": device_info(r.device, peak, tr if traced else None)}
    if traced and tr and not tr["refused"]:
        out["breakdown"] = {"device_ops": tr["device_ops"],
                            "idle_gaps": tr["idle_gaps"]}
    out["engine"] = r.engine
    out["check"] = check
    return out


def reader(bench_dir: str, name: str):
    """The reader of metric ``name``: ``metrics/<name>.py``, else
    ``metrics/<stem>.py`` with the stem the name up to its first dot."""
    for stem in (name, name.split(".", 1)[0]):
        path = os.path.join(bench_dir, "metrics", stem + ".py")
        if os.path.exists(path):
            return _load(path, "metric_" + stem.replace(".", "_"))
    raise FileNotFoundError(f"no reader for metric {name}")


def device_info(device, peak: int, tr) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": 1, "memory_peak_bytes": int(peak)}
    if tr and not tr["refused"]:
        out["busy_s"] = tr["busy_s"]
        out["window_s"] = tr["window_s"]
    return out
