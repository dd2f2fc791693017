"""The port driver's run loop on the CPU: the chained runner, the
reference's marginal timing on an injected clock, ``quick``, the profiling
and step-timing keys against the JAX driver's, and ``trace_dir``.

Timing helpers take ``timed(n)``, the seconds of a chained run of n calls,
so that a scripted clock checks them exactly.  The report keys of a run
with ``profiling`` and ``measure_step_time`` (``MulPerf``, ``SumPerf``,
``PhaseTime-*``, ``StepTime-*``) must be the JAX driver's keys in the same
order, for csr, ss, css and an xch state with no peel.
"""
import glob
import json
import os

import numpy as np
import pytest

from singlespmv_tpu.config import Config
from singlespmv_tpu.core.types import COOMatrix
from singlespmv_tpu.data.generators import powerlaw
from singlespmv_tpu.harness.driver import run_benchmark as ref_run_benchmark
from singlespmv_tpu_torch.harness import driver, run_benchmark
from torch_parity import port_cfg, port_coo

PROFILE_KEYS = ("MulPerf", "SumPerf", "PhaseTime-", "StepTime-")


def _quiet(msg):
    pass


def _scattered(n, nnz, seed):
    """Uniformly scattered entries: an xch state with no peel and no
    long-row state, so that it has phases."""
    rng = np.random.default_rng(seed)
    return COOMatrix.from_triplets(
        n, n, rng.integers(0, n, nnz), rng.integers(0, n, nnz),
        rng.uniform(0.1, 1.0, nnz), sort=True, sum_duplicates=True)


def _linear(fixed, per):
    """A clock on which a run of n calls lasts fixed + per·n."""
    return lambda n: fixed + per * n


@pytest.mark.parametrize("n", [0, 1, 7, 64])
def test_run_n_calls_fn_exactly_n_times(n):
    import torch

    calls = []

    def fn(state, a):
        calls.append(state)
        return a + len(calls)

    run_n = driver.make_chained_runner(fn, "st", torch.zeros(3), chain=4)
    out = run_n(n)
    assert calls == ["st"] * n
    assert (out is None) if n == 0 else out.tolist() == [float(n)] * 3


def test_marginal_cancels_the_fixed_cost():
    assert driver.trial_seconds(_linear(5e-3, 2e-6), 64) == pytest.approx(
        2e-6, rel=1e-9)


def test_marginal_falls_back_to_the_average_when_not_positive():
    times = {32: 3e-3, 64: 2e-3}          # a hiccup in the half run
    got = driver.trial_seconds(times.__getitem__, 64)
    assert got == pytest.approx((3e-3 + 2e-3) / (64 + 32))


def test_below_eight_calls_a_trial_is_the_plain_average():
    seen = []

    def timed(n):
        seen.append(n)
        return 1e-3 + 1e-4 * n

    assert driver.trial_seconds(timed, 4) == pytest.approx(1.4e-3 / 4)
    assert seen == [4]


def test_median_of_the_trials():
    per = iter([5e-6, 1e-6, 9e-6, 2e-6, 3e-6])
    state = {}

    def timed(n):                       # each trial: half run, then full
        if n == 32:
            state["per"] = next(per)
        return 1e-3 + state["per"] * n

    assert driver.median_seconds(timed, 64, 5) == pytest.approx(3e-6)


def test_calibration_doubles_until_the_window():
    seen = []

    def timed(n):
        seen.append(n)
        return 1e-4 * n

    assert driver.calibrate_loop(timed, 0.05, 1 << 20) == 512
    assert seen == [1 << i for i in range(10)]
    assert driver.calibrate_loop(timed, 10.0, 64) == 64


def test_time_is_the_median_marginal_of_the_runner(monkeypatch):
    """Time(s) of a calibrated run is the marginal on the driver's clock,
    whatever the fixed cost of a run."""
    monkeypatch.setattr(driver, "runner_clock",
                        lambda run_n, device: _linear(7e-3, 3e-6))
    cfg = Config(format="csr", calibrate_seconds=0.01, n_trials=4)
    res = run_benchmark(port_coo(powerlaw(500, 3000, seed=1)),
                        port_cfg(cfg), device="cpu", log=_quiet)
    assert res.loop == 1024                # 7e-3 + 3e-6·n ≥ 0.01 from 1000
    assert res.seconds == pytest.approx(3e-6, rel=1e-6)
    assert res.report["Time(s)"] == res.seconds
    assert res.report["LoopCount"] == res.loop


def test_quick_is_one_trial_of_three_calls(monkeypatch):
    runs = []
    real = driver.make_chained_runner

    def counting(fn, state, arg, **kw):
        run_n = real(fn, state, arg, **kw)

        def wrapped(n):
            runs.append(n)
            return run_n(n)
        return wrapped

    monkeypatch.setattr(driver, "make_chained_runner", counting)
    res = run_benchmark(port_coo(powerlaw(400, 2000, seed=2)),
                        port_cfg(Config(format="csr")), quick=True,
                        device="cpu", log=_quiet)
    assert runs == [3] and res.loop == 3 and res.seconds > 0


CASES = {
    "csr": (Config(format="csr"), lambda: powerlaw(2000, 12000, seed=3)),
    "ss": (Config(format="ss", segment_width=256),
           lambda: powerlaw(2000, 12000, seed=3)),
    "css": (Config(format="css", segment_width=256),
            lambda: powerlaw(2000, 12000, seed=3)),
    "xch": (Config(format="xch"), lambda: _scattered(4000, 16000, 1)),
}


@pytest.mark.parametrize("fmt", sorted(CASES))
def test_profile_keys_match_the_jax_driver(fmt):
    cfg, make = CASES[fmt]
    cfg = cfg.replace(profiling=True, measure_step_time=True)
    coo = make()
    got = run_benchmark(port_coo(coo), port_cfg(cfg), quick=True,
                        device="cpu", log=_quiet).report
    want = ref_run_benchmark(coo, cfg, quick=True, log=_quiet).report

    def keys(rep):
        return [k for k in rep if k.startswith(PROFILE_KEYS)]

    assert keys(got) == keys(want)
    assert len(keys(got)) >= 3
    assert all(got[k] > 0 for k in keys(got))
    # the profile keys sit where the reference puts them
    shared = [k for k in want if k in got]
    assert shared == [k for k in got if k in want]
    assert got["Verify"] == "PASS"


def test_trace_dir_writes_a_trace_on_the_cpu(tmp_path):
    res = run_benchmark(port_coo(powerlaw(400, 2000, seed=4)),
                        port_cfg(Config(format="csr")), quick=True,
                        trace_dir=str(tmp_path), name="pl400", device="cpu",
                        log=_quiet)
    assert res.verify_ok
    files = glob.glob(os.path.join(str(tmp_path), "pl400-csr.*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("index_add_" in e.get("name", "") for e in events)
