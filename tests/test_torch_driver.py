"""Port driver: ``singlespmv_tpu_torch.harness.run_benchmark`` on the CPU
(the kernels' plain versions) against the JAX driver, the report block, and
the roofline table.

The two drivers' y agree to rtol 1e-5 with atol 1e-5·max|y|: the port sums
row prefixes and the diagonal shift-add in another order.
"""
import numpy as np
import pytest
import torch

from singlespmv_tpu.config import Config
from singlespmv_tpu.core.mmio import write_matrix_market
from singlespmv_tpu.data.generators import powerlaw
from singlespmv_tpu.harness.driver import run_benchmark as ref_run_benchmark
from singlespmv_tpu_torch.harness import run_benchmark
from singlespmv_tpu_torch.harness.report import format_block
from singlespmv_tpu_torch.harness.roofline import CHIPS, detect_chip, roofline
from torch_parity import port_cfg, port_coo

CFG = Config(format="slab", dtype="float32")
RTOL = 1e-5


def _quiet(msg):
    pass


@pytest.mark.parametrize("n,nnz,seed", [(3000, 30000, 2), (2000, 12000, 4)])
def test_slice_matches_jax_driver(n, nnz, seed):
    coo = powerlaw(n, nnz, seed=seed)
    got = run_benchmark(port_coo(coo), port_cfg(CFG), quick=True, device="cpu",
                        log=_quiet)
    want = ref_run_benchmark(coo, CFG, quick=True, log=_quiet)
    assert got.verify_ok and got.report["Verify"] == "PASS"
    assert got.y.shape == (coo.n_row,) and np.isfinite(got.y).all()
    np.testing.assert_allclose(got.y, want.y, rtol=RTOL,
                               atol=RTOL * np.abs(want.y).max())
    for key in ("Matrix", "MatrixFormat", "Variant", "Dtype", "WindowBlocks",
                "StepRows", "RoutePlanes", "PadFactor", "nRow", "nCol",
                "nNnz"):
        assert got.report[key] == want.report[key], key
    assert got.report["Architecture"] == "CPU"
    assert got.loop == 3 and got.seconds > 0 and got.gflops > 0
    # the keys both reports carry come in the same order
    shared = [k for k in want.report if k in got.report]
    assert shared == [k for k in got.report if k in want.report]
    assert len(shared) >= 20
    block = got.block.splitlines()
    assert block[0] == "+" * 40 and block[-1] == "-" * 40
    assert block[1] == f"{'Matrix':>25}\tin-memory"


def test_calibrated_run_from_a_file(tmp_path):
    coo = powerlaw(1500, 9000, seed=6)
    path = tmp_path / "pl1500.mtx"
    write_matrix_market(str(path), coo)
    cfg = CFG.replace(calibrate_seconds=0.01, n_trials=3)
    res = run_benchmark(str(path), port_cfg(cfg), device="cpu", log=_quiet)
    assert res.report["Matrix"] == "pl1500"
    assert res.verify_ok and res.loop >= 1
    assert res.report["Time(s)"] == res.seconds
    assert res.report["Performance(GFLOPS)"] == pytest.approx(
        2.0 * coo.nnz / res.seconds / 1e9)


def test_default_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_benchmark(port_coo(powerlaw(300, 2000, seed=1)), port_cfg(CFG),
                      quick=True, log=_quiet)


def test_roofline_table():
    h100 = CHIPS["H100 80GB HBM3"]
    assert h100.hbm_gbps == 3350.0
    r = roofline(3_350_000_000, 1000, 1.0, h100)
    assert r["Bandwidth(GB/s)"] == pytest.approx(3.35)
    assert r["RooflinePct"] == pytest.approx(0.1)
    assert r["SolTime(s)"] == pytest.approx(1e-3)
    host = detect_chip("cpu")
    assert host.hbm_gbps is None
    r = roofline(1000, 10, 1e-3, host)
    assert r["RooflinePct"] is None and r["Chip"] == "host cpu"
    assert "RooflinePct\tNone" in format_block(r)


@pytest.mark.parametrize("counts,launched,taken", [
    ([3] * 20, 3, True),          # complete: 20 calls of 3 events
    ([3] * 20, None, True),       # complete, no launch counter (a library)
    ([3] * 19, 3, False),         # short: the marks of a call were lost
    ([3] * 19 + [2], 3, False),   # short: a call lost an event
    ([0] * 20, None, False),      # empty
    ([], None, False),            # no call delimited
    ([2] * 20, 3, False),         # the match misses a kernel launched
    ([4] * 20, 3, False),         # the match takes an event not launched
])
def test_busy_reader_takes_only_complete_traces(counts, launched, taken):
    from singlespmv_tpu_torch.harness.driver import trace_refusal

    why = trace_refusal(counts, 20, launched)
    assert (why is None) == taken
    if not taken:
        assert isinstance(why, str) and why


@pytest.mark.parametrize("traces,launches,want", [
    ([([1] * 20, 100.0)], 1, 5e-6),                       # taken at once
    ([([1] * 19, 95.0)] * 2 + [([1] * 20, 100.0)], 1, 5e-6),
    ([([1] * 19, 95.0)] * 3, 1, None),                    # three short traces
    ([([1] * 10 + [0] * 10, 50.0)] * 3, 1, None),         # calls lost events
    ([([2] * 20, 100.0)], 1, "TraceError"),               # the match is wrong
    ([([1] * 20, 0.0)], None, "TraceError"),              # complete, no time
])
def test_busy_reader_retries_and_refuses(monkeypatch, traces, launches,
                                         want):
    """``busy_seconds`` over scripted traces of 20 calls: (events of each
    call, µs), attempt by attempt; the wrappers launch one kernel a call."""
    from singlespmv_tpu_torch.harness import driver

    script = iter(traces)
    count = [0]

    def calls(fn, match="", reps=1):
        for _ in range(reps):
            fn()
        return next(script)

    def call():
        count[0] += 1

    monkeypatch.setattr(driver, "device_trace", calls)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    counter = None if launches is None else (lambda: count[0])
    if want == "TraceError":
        with pytest.raises(driver.TraceError):
            driver.busy_seconds(call, "k", 20, counter, log=_quiet)
        return
    got = driver.busy_seconds(call, "k", 20, counter, log=_quiet)
    assert got == pytest.approx(want) if want is not None else got is None
