"""Whole runs of every cell on the CPU at a tiny size (``tiny.py``): what
they load, what they find by name, and that a run whose timed path is
broken underneath, or replaced by the reference in a lower precision,
comes out not correct."""
import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import harness, reference
from benchmark.program import Port

from .tiny import ROOT, bench_copy, workloads

WORKLOADS = workloads()
# at float64 the tiny runs are sound under every cell's limit
F64 = {"graph500-s20.csr5.f32": "float64",
       "graph500-s20.slab.f32": "float64"}


def _run(bench, spec, workload, port=None, seconds=0.3, traced=False):
    return harness.run(workload, 2**31 + 11, seconds, traced, device="cpu",
                       port=port, bench_dir=bench, spec_path=spec)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return bench_copy(tmp_path_factory.mktemp("tiny"), F64)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_sound_run_is_correct(tiny, workload):
    out = _run(*tiny, workload)
    assert out["correct"], out["check"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "check"
    spec = json.load(open(tiny[1]))
    ends = {m["name"] for m in spec["end_to_end"]
            if workload in m.get("workloads", [workload])}
    assert set(out["metrics"]) == ends
    assert "setup_s" in ends and len(ends) >= 2
    assert all(v["value"] > 0 for v in out["metrics"].values())


@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_traced_run_on_the_cpu_reports_its_host_clock_metrics(tiny,
                                                                workload):
    out = _run(*tiny, workload, traced=True)
    assert out["correct"]
    assert "convert_s" in out["metrics"]
    if workload.endswith("cg50"):
        assert "capture_ms" not in out["metrics"]    # no capture off the card
    # the device's metrics need a trace of the card
    assert not {"glue_pct", "product_roofline", "idle_pct",
                "idle_pct.solve"} & set(out["metrics"])


@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path, workload):
    """In a fresh interpreter, a whole run leaves no module whose
    top-level name is jax, jaxlib, flax or singlespmv_tpu (compared whole:
    singlespmv_tpu_torch is the program); the reference and the generators
    load nothing of the program."""
    bench, spec = bench_copy(tmp_path, F64)
    code = f"""
import json, sys
sys.path.insert(0, {ROOT!r})
import benchmark.reference, benchmark.yardstick, benchmark.trace
import benchmark.structures.kronecker, benchmark.structures.stencil27
bare = sorted(m for m in sys.modules
              if m.split('.')[0] == 'singlespmv_tpu_torch')
from benchmark import harness
out = harness.run({workload!r}, 3, 0.2, False, device='cpu',
                  bench_dir={bench!r}, spec_path={spec!r})
print(json.dumps([bare, sorted({{m.split('.')[0] for m in sys.modules}}),
                  harness.forbidden_modules(), out['correct']]))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr[-2000:]
    bare, tops, found, correct = json.loads(res.stdout.splitlines()[-1])
    assert bare == []
    assert "singlespmv_tpu_torch" in tops and correct
    assert found == [] and not {"jax", "jaxlib", "flax",
                                "singlespmv_tpu"} & set(tops)


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "singlespmv_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_x", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax"]


def test_new_files_are_found_without_an_edit(tmp_path):
    """A configuration, a traffic mix, a per-layer metric and their cell's
    limits, each a new file, with an entry in the specification: a run
    finds and reports them."""
    bench, spec_path = bench_copy(tmp_path, F64)
    with open(os.path.join(bench, "configs", "kron-small.f64.json"),
              "w") as f:
        json.dump({"name": "kron-small.f64", "structure": "kronecker",
                   "scale": 9, "edgefactor": 8,
                   "initiator": [0.45, 0.15, 0.15], "structure_seed": 1,
                   "dtype": "float64", "format": "csr", "reduced": []}, f)
    with open(os.path.join(bench, "traffic", "spmm3.json"), "w") as f:
        json.dump({"kind": "chained", "chain": 4, "pool": 2, "columns": 3,
                   "sample": 2, "chains": 1}, f)
    with open(os.path.join(bench, "metrics", "requests_done.py"), "w") as f:
        f.write("def read(ctx):\n    return len(ctx['requests'])\n")
    with open(os.path.join(bench, "checks", "kron-small.spmm3.json"),
              "w") as f:
        json.dump({"y_err": 1e-12, "chain_err": 1e-12}, f)
    with open(spec_path) as f:
        spec = json.load(f)
    spec["configs"].append({"name": "kron-small.f64", "source": "test",
                            "file": "benchmark/configs/kron-small.f64.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "kron-small.spmm3",
                              "config": "kron-small.f64", "traffic": "spmm3",
                              "chips": 1, "why": "test"})
    next(m for m in spec["end_to_end"]
         if m["name"] == "gflops")["workloads"].append("kron-small.spmm3")
    # a reader of its own, and a second metric read by the same reader
    # through the stem of its name
    for name in ("requests_done", "requests_done.again"):
        spec["per_layer"].append({"name": name, "unit": "requests",
                                  "better": "higher", "source": "host_clock",
                                  "layer": "driver", "moves": "gflops",
                                  "workloads": ["kron-small.spmm3"]})
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    out = _run(bench, spec_path, "kron-small.spmm3", traced=True)
    assert out["correct"] and out["engine"] == "csr"
    assert out["metrics"]["requests_done"]["value"] >= 1
    assert out["metrics"]["requests_done.again"] == \
        out["metrics"]["requests_done"]
    out = _run(bench, spec_path, "kron-small.spmm3")
    assert set(out["metrics"]) == {"gflops", "setup_s"}


class _Broken(Port):
    """The port with one fault underneath the timed path."""

    def __init__(self, fault):
        super().__init__()
        self.fault = fault

    def product(self, cfg, columns):
        fn = super().product(cfg, columns)
        if self.fault == "unchanged":       # the step returns its input
            return lambda state, x: x.clone()
        if self.fault == "skipped":         # every 7th product skipped
            calls = [0]

            def skipped(state, x):
                calls[0] += 1
                return x.clone() if calls[0] % 7 == 0 else fn(state, x)
            return skipped
        if self.fault == "altered":         # one answer altered
            def altered(state, x):
                y = fn(state, x)
                y.view(-1)[7] += 0.01 * (1 + y.view(-1)[7].abs())
                return y
            return altered
        if self.fault == "half":            # half of the columns left out
            def half(state, x):
                y = fn(state, x)
                y[:, y.shape[1] // 2:] = 0
                return y
            return half
        return fn

    def cg_loop(self, cfg, state, b, *, tol, maxiter):
        loop = super().cg_loop(cfg, state, b, tol=tol, maxiter=maxiter)
        if self.fault == "unchanged":       # a step that changes nothing
            loop.body = lambda carry: {"it": carry["it"] + 1}
        return loop

    def solve(self, cfg, state, loop):
        x, it, info = super().solve(cfg, state, loop)
        if self.fault == "altered":
            x = x.clone()
            x[3] += 0.01 * (1 + x[3].abs())
        return x, it, info


FAULTS = [(w, f) for w in WORKLOADS for f in ("unchanged", "altered")] + [
    (w, "skipped") for w in WORKLOADS if not w.endswith("cg50")] + [
    (w, "half") for w in WORKLOADS if w.endswith("spmm8")]


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_a_fault_underneath_makes_the_run_not_correct(tiny, workload,
                                                      fault):
    out = _run(*tiny, workload, port=_Broken(fault))
    assert not out["correct"], (fault, out["check"])


class _Lowered(Port):
    """The reference in the next lower value type put in the program's
    place: bfloat16 for float32, float32 for float64 (its CG runs the
    reference's CG in that type)."""

    LOWER = {"float32": torch.bfloat16, "float64": torch.float32}

    def convert(self, m, *, fmt, dtype, spmm_b, device):
        cfg, _ = super().convert(m, fmt="csr", dtype=dtype, spmm_b=0,
                                 device=device)
        return cfg, reference.Operator(m, device, self.LOWER[dtype])

    def engine(self, cfg, state):
        return "reference"

    def product(self, cfg, columns):
        return lambda op, x: op.matvec(x).to(x.dtype)

    def cg_loop(self, cfg, state, b, *, tol, maxiter):
        return b, maxiter

    def solve(self, cfg, state, loop):
        b, maxiter = loop
        x = reference.cg(state, b, maxiter).to(b.dtype)
        return x, torch.tensor(maxiter), {}


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_lower_precision_control_is_not_correct(tmp_path, workload):
    """At the configurations' own value types, the control fails the
    cell's limits."""
    bench, spec = bench_copy(tmp_path)
    out = _run(bench, spec, workload, port=_Lowered())
    assert not out["correct"], out["check"]


def test_run_py_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", WORKLOADS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert res.returncode != 0 and res.stdout == ""
    assert "CUDA device" in res.stderr
