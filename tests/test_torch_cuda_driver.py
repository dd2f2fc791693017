"""The driver's chained runner on the card: CUDA graphs of chained spmv
calls (``harness/driver.py:make_chained_runner``).

The graph's y must pass the oracle, and on the states of
``test_torch_cuda_drift.py`` equal the eager y within each row's reorder
bound (``core/oracle.py:reorder_bound``: the routes add run totals in warp
order); a replay launches no
wrapper, so the launch counters rise only at the warm-up and the capture; a
capture that fails raises ``CaptureError`` naming the format, in the runner
and in ``run_benchmark``, and never falls back to eager calls; phases, step
timing and ``cache_dir`` run on the card.

Needs an NVIDIA GPU and skips without one.  This file imports no jax:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_driver.py
"""
import numpy as np
import pytest
import torch

from singlespmv_tpu_torch import Config
from singlespmv_tpu_torch.core import verify_result
from singlespmv_tpu_torch.core.types import COOMatrix
from singlespmv_tpu_torch.data import powerlaw
from singlespmv_tpu_torch.formats import csr, get_format
from singlespmv_tpu_torch.harness import driver, run_benchmark
from singlespmv_tpu_torch.ops import slab as slab_ops

from test_torch_cuda_drift import _case as drift_case
from test_torch_cuda_drift import within_reorder_bound

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _scattered(n, nnz, seed):
    """Uniformly scattered entries: an xch state with no peel and no
    long-row state."""
    rng = np.random.default_rng(seed)
    return COOMatrix.from_triplets(
        n, n, rng.integers(0, n, nnz), rng.integers(0, n, nnz),
        rng.uniform(0.1, 1.0, nnz), sort=True, sum_duplicates=True)


def _quiet(msg):
    pass


def _x(coo, dtype, dev):
    return torch.from_numpy(np.random.default_rng(1).uniform(
        -1, 1, coo.n_col)).to(dev, getattr(torch, dtype))


CASES = [("slab", "float32"), ("slab", "float64"), ("xch", "float32"),
         ("xch", "float64"), ("hyb", "float32"), ("bkt", "float32"),
         ("css", "float32"), ("ss", "float32"), ("ss", "float64"),
         ("csr5", "float32"), ("csr", "float32"), ("dia", "float32")]


@pytest.mark.parametrize("fmt,dtype", CASES)
@pytest.mark.parametrize("n", [1, 67])
def test_graph_y_passes_the_oracle(cuda, fmt, dtype, n):
    # bkt refuses a power-law matrix (its padding guard): 128-row buckets
    # of a deep scatter, as test_torch_cuda_bkt.py's
    coo = (_scattered(2000, 60000, 9) if fmt == "bkt"
           else powerlaw(20000, 120000, seed=2))
    mod = get_format(fmt)
    st = mod.convert(coo, Config(format=fmt, dtype=dtype)).to(cuda)
    x = _x(coo, dtype, cuda)
    run_n = driver.make_chained_runner(mod.spmv, st, x, name=fmt, chain=8)
    y = run_n(n)
    eager = mod.spmv(st, x)
    assert y.shape == eager.shape and y.dtype == eager.dtype
    ok, det = verify_result(coo, x.cpu().numpy(), y.cpu().numpy(),
                            dtype=np.dtype(dtype))
    assert ok, (fmt, det)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("kind", ["slab merged", "slab direct", "xch"])
def test_graph_y_within_the_drift_bound_of_eager_y(cuda, kind, dtype):
    """On the states of ``test_torch_cuda_drift.py``, whose two eager calls
    meet the reorder bound, the graph's y meets it against the eager
    y."""
    coo, st, spmv = drift_case(kind, dtype)
    st = st.to(cuda)
    x = _x(coo, dtype, cuda)
    eager = spmv(st, x)
    y = driver.make_chained_runner(spmv, st, x, name=kind, chain=8)(9)
    torch.cuda.synchronize()
    within_reorder_bound(coo, st, spmv, x, y, eager,
                         f"{kind} {dtype}: graph vs eager")


def test_replays_launch_no_wrapper(cuda):
    coo = powerlaw(20000, 120000, seed=3)
    mod = get_format("slab")
    st = mod.convert(coo, Config(format="slab")).to(cuda)
    x = _x(coo, "float32", cuda)
    slab_ops.slab_spmv_rows.launches = 0
    mod.spmv(st, x)
    per_call = slab_ops.slab_spmv_rows.launches
    slab_ops.slab_spmv_rows.launches = 0
    run_n = driver.make_chained_runner(mod.spmv, st, x, chain=4)
    built = slab_ops.slab_spmv_rows.launches
    assert built == per_call * (driver.WARMUP_CALLS + 4 + 1)
    run_n(1000)
    torch.cuda.synchronize()
    assert slab_ops.slab_spmv_rows.launches == built


def test_capture_failure_raises_and_names_the_format(cuda):
    x = torch.ones(1000, device=cuda)

    def syncing(state, a):
        return a * float(a.sum().item())

    with pytest.raises(driver.CaptureError, match="myformat"):
        driver.make_chained_runner(syncing, None, x, name="myformat")


def test_run_benchmark_does_not_fall_back_to_eager(cuda, monkeypatch):
    def syncing_spmv(state, a):
        torch.cuda.synchronize()
        return csr.reduce(state, csr.mul(state, a))

    monkeypatch.setattr(csr, "spmv", syncing_spmv)
    with pytest.raises(driver.CaptureError, match="csr"):
        run_benchmark(powerlaw(3000, 20000, seed=4), Config(format="csr"),
                      quick=True, device=cuda, log=_quiet)


def test_marginal_time_of_a_chained_run(cuda):
    res = run_benchmark(powerlaw(20000, 120000, seed=5),
                        Config(format="slab", calibrate_seconds=0.05,
                               n_trials=3), device=cuda, log=_quiet)
    assert res.verify_ok and res.loop >= 8 and 0 < res.seconds < 1e-2


@pytest.mark.parametrize("fmt,coo_of,steps", [
    ("csr", lambda: powerlaw(20000, 120000, seed=6), False),
    ("ss", lambda: powerlaw(20000, 120000, seed=6), True),
    ("css", lambda: powerlaw(20000, 120000, seed=6), True),
    ("xch", lambda: _scattered(40000, 160000, 7), False)])
def test_phases_and_steps_on_the_card(cuda, fmt, coo_of, steps):
    cfg = Config(format=fmt, profiling=True, measure_step_time=steps)
    res = run_benchmark(coo_of(), cfg, quick=True, device=cuda, log=_quiet)
    rep = res.report
    phases = [k for k in rep if k.startswith("PhaseTime-")]
    assert res.verify_ok and len(phases) >= 2
    assert all(rep[k] > 0 for k in phases)
    assert "SumPerf" in rep
    step_keys = [k for k in rep if k.startswith("StepTime-")]
    assert len(step_keys) == (rep["nStep"] if steps else 0)
    assert all(rep[k] > 0 for k in step_keys)


@pytest.mark.parametrize("fmt", ["slab", "xch", "auto"])
def test_cache_dir_on_the_card(cuda, tmp_path, fmt):
    coo = _scattered(40000, 160000, 8)
    cfg = Config(format=fmt)
    first = run_benchmark(coo, cfg, quick=True, cache_dir=str(tmp_path),
                          device=cuda, log=_quiet)
    again = run_benchmark(coo, cfg.replace(n_trials=3), quick=True,
                          cache_dir=str(tmp_path), device=cuda, log=_quiet)
    assert first.verify_ok and again.verify_ok
    assert again.report.get("ChosenFormat") == first.report.get(
        "ChosenFormat")
    scale = np.abs(first.y).max()
    assert np.abs(first.y - again.y).max() <= 1e-6 * scale
