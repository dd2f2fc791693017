"""Port auto planner, driver retry and host layer against the reference's.

``auto.estimate_costs`` is the reference's model over the engines the port
has, so every key both packages price agrees to 1e-12 relative (bkt and
bkt_g only at float32, the port's rule; css and ss included), and
``choose`` picks the reference's engine wherever that engine is ported.  On the CPU auto ranks by
the model alone.  A kernel that fails to launch (``KernelError``) stops
``auto`` and the driver; a guard error excludes the candidate.  The port
runs with the reference package absent, and its copies of the reference's
host layer give the same matrices and sorts.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from singlespmv_tpu.config import Config
from singlespmv_tpu.core.types import COOMatrix
from singlespmv_tpu.data.generators import generate, powerlaw
from singlespmv_tpu.data.structgen import synthesize_structured as ref_synth
from singlespmv_tpu.formats import auto as ref_auto
from singlespmv_tpu_torch.core import hostmem, native
from singlespmv_tpu_torch.data import synthesize_structured
from singlespmv_tpu_torch.formats import auto, bkt
from singlespmv_tpu_torch.harness import run_benchmark
from singlespmv_tpu_torch.ops._build import KernelError
from test_torch_bkt_ops import _scattered
from test_torch_dia_hyb import _mixed
from torch_parity import port_cfg, port_coo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MATS = [
    ("powerlaw", lambda: powerlaw(3000, 30000, seed=2)),
    ("band", lambda: generate("band", 2000, 8, seed=1)),
    ("band+scatter", lambda: _mixed(3000, 7, 6, 3)),
    ("thin-scatter", lambda: _scattered(9000, 18000, 5)),
    ("dense-ish", lambda: generate("random", 400, 40000, seed=4)),
]
IDS = [m[0] for m in MATS]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("label,make", MATS, ids=IDS)
def test_estimate_costs_match_reference(label, make, dtype):
    coo = make()
    cfg = Config(format="auto", dtype=dtype)
    want = ref_auto.estimate_costs(coo, cfg)
    got = auto.estimate_costs(port_coo(coo), port_cfg(cfg))
    left_out = {"bkt", "bkt_g"} if dtype == "float64" else set()
    assert set(got) == set(want) - left_out   # bkt: float32 only here
    assert {"css", "ss"} <= set(got)
    for k, v in got.items():
        assert v == pytest.approx(want[k], rel=1e-12, abs=0), k
    assert {"bkt", "bkt_g"} <= set(got) or dtype == "float64" \
        or label == "thin-scatter"
    ref_pick = min(want, key=want.get)
    if ref_pick in got:
        assert auto.choose(port_coo(coo), port_cfg(cfg)) == ref_pick


def test_supports_rule():
    assert auto.supports("bkt_g", "float32") and \
        not auto.supports("bkt_g", "float64")
    for fmt in ("slab", "xch", "csr", "bsr", "dense", "dia", "hyb", "css",
                "ss"):
        assert auto.supports(fmt, "float64")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_run_benchmark_auto_on_cpu(dtype):
    coo = powerlaw(3000, 30000, seed=2)
    cfg = Config(format="auto", dtype=dtype)
    res = run_benchmark(port_coo(coo), port_cfg(cfg), quick=True,
                        device="cpu", log=lambda m: None)
    rep = res.report
    assert res.verify_ok and rep["Verify"] == "PASS"
    assert rep["MatrixFormat"] == "AUTO" and rep["Dtype"] == dtype
    want = ref_auto.estimate_costs(coo, cfg)
    if dtype == "float64":
        want = {k: v for k, v in want.items() if k not in ("bkt", "bkt_g")}
    assert rep["ChosenFormat"] == min(want, key=want.get).upper()
    assert rep["AutoTrials(us)"] == "none"           # no trials on the CPU
    assert rep["AutoFailed"] == "none" and rep["AutoExcluded"] == "none"
    assert res.y.dtype == np.dtype(dtype)


def _only(*keep):
    """An auto config that excludes every engine but ``keep``."""
    return Config(format="auto", auto_exclude=tuple(
        k for k in auto._MODULES if k not in keep))


def _raises(exc):
    def fn(*a, **k):
        raise exc
    return fn


def _raises_on_grouped(exc):
    """A bucket kernel (``bucket_fused_rows``, stage A and B) that raises
    ``exc`` on bkt_g's stream (int16 dests) and runs bkt's."""
    real = bkt.bucket_fused_rows

    def fn(*a, **k):
        if a[7].dtype == torch.int16:               # dest
            raise exc
        return real(*a, **k)
    return fn


def test_driver_retry_excludes_guard_errors_only(monkeypatch):
    coo = port_coo(powerlaw(3000, 30000, seed=2))
    cfg = port_cfg(_only("bkt_g", "csr"))
    st = auto.convert(coo, cfg)
    assert st.chosen == "bkt_g" and st.inner.row_group == 1024
    monkeypatch.setattr(bkt, "bucket_fused_rows", _raises(
        ValueError("stage A refused")))
    res = run_benchmark(coo, cfg, quick=True, device="cpu",
                        log=lambda m: None)
    assert res.report["ChosenFormat"] == "CSR" and res.verify_ok
    assert res.report["AutoExcluded"].startswith("bkt_g: ValueError")
    monkeypatch.setattr(bkt, "bucket_fused_rows", _raises(
        KernelError("bucket_fused_rows: CUDA kernel launch failed")))
    with pytest.raises(KernelError):
        run_benchmark(coo, cfg, quick=True, device="cpu", log=lambda m: None)


def test_auto_trials_skip_guard_errors_only(monkeypatch):
    """The measured trials, forced on the CPU: a candidate whose spmv
    refuses is recorded and skipped, a kernel error stops convert."""
    coo = port_coo(powerlaw(3000, 30000, seed=2))
    cfg = port_cfg(_only("bkt", "bkt_g", "slab"))
    measured = []

    def quick(mod, state, n_col, dtype, device):
        mod.spmv(state, torch.zeros(n_col, dtype=torch.float32))
        measured.append(state)
        return 1e-3 * len(measured)

    monkeypatch.setattr(auto, "_measures", lambda device: True)
    monkeypatch.setattr(auto, "_quick_bench", quick)
    st = auto.convert(coo, cfg, device="cpu")
    assert len(st.trials) == 3 and st.chosen == st.trials[0][0]
    assert not st.failed
    monkeypatch.setattr(bkt, "bucket_fused_rows", _raises_on_grouped(
        TypeError("stage B refused")))
    st = auto.convert(coo, cfg, device="cpu")
    assert [f for f, _ in st.failed] == ["bkt_g"]
    assert "bkt_g" not in dict(st.trials) and len(st.trials) == 2
    assert "bkt_g: TypeError" in auto.report_fields(st, cfg)["AutoFailed"]
    monkeypatch.setattr(bkt, "bucket_fused_rows", _raises_on_grouped(
        KernelError("bucket_fused_rows: CUDA kernel launch failed")))
    with pytest.raises(KernelError):
        auto.convert(coo, cfg, device="cpu")


def test_auto_trial_conversions_side_by_side(monkeypatch):
    """The trial candidates convert in threads: each state is the one its
    own convert builds, a conversion that refuses with a guard error is
    recorded and skipped, and any other error stops convert."""
    coo = port_coo(powerlaw(3000, 30000, seed=2))
    cfg = port_cfg(_only("bkt", "bkt_g", "slab"))
    monkeypatch.setattr(auto, "_measures", lambda device: True)
    monkeypatch.setattr(auto, "_quick_bench",
                        lambda mod, state, *a: 1e-3 * (mod is not bkt))
    x = torch.linspace(-1.0, 1.0, coo.n_col)
    st = auto.convert(coo, cfg, device="cpu")
    alone = bkt.convert(coo, cfg.replace(
        bkt_row_group=1024 if st.chosen == "bkt_g" else 128))
    assert st.chosen in ("bkt", "bkt_g") and len(st.trials) == 3
    assert torch.equal(auto.spmv(st, x), bkt.spmv(alone, x))
    real = bkt.convert

    def refuse(exc):
        def fn(coo, cfg, **kw):
            if cfg.bkt_row_group == 1024:
                raise exc
            return real(coo, cfg, **kw)
        return fn

    monkeypatch.setattr(bkt, "convert", refuse(MemoryError("too big")))
    st = auto.convert(coo, cfg, device="cpu")
    assert [f for f, _ in st.failed] == ["bkt_g"] and len(st.trials) == 2
    monkeypatch.setattr(bkt, "convert", refuse(RuntimeError("a fault")))
    with pytest.raises(RuntimeError, match="a fault"):
        auto.convert(coo, cfg, device="cpu")


def test_port_runs_without_the_reference_package():
    """A fresh process where ``singlespmv_tpu`` cannot be imported: the
    port imports, converts and multiplies (a local-mesh DistXch among
    them), and neither jax nor the reference package is loaded."""
    code = (
        "import sys\n"
        "sys.modules['singlespmv_tpu'] = None\n"
        "import numpy as np, torch\n"
        "import singlespmv_tpu_torch.formats, "
        "singlespmv_tpu_torch.harness.driver\n"
        "import singlespmv_tpu_torch.harness.calibrate, "
        "singlespmv_tpu_torch.harness.microbench, "
        "singlespmv_tpu_torch.harness.probe_slab, "
        "singlespmv_tpu_torch.ops.probes\n"
        "from singlespmv_tpu_torch import Config\n"
        "from singlespmv_tpu_torch.core import verify_result\n"
        "from singlespmv_tpu_torch.data import powerlaw\n"
        "from singlespmv_tpu_torch.formats import auto, bkt\n"
        "coo = powerlaw(2000, 16000, seed=1)\n"
        "x = np.random.default_rng(0).uniform(size=2000).astype(np.float32)\n"
        "for cfg in (Config(format='auto'), Config(bkt_row_group=1024)):\n"
        "    mod = auto if cfg.format == 'auto' else bkt\n"
        "    y = mod.spmv(mod.convert(coo, cfg), torch.from_numpy(x))\n"
        "    ok, det = verify_result(coo, x, y.numpy())\n"
        "    assert ok, det\n"
        "from singlespmv_tpu_torch.parallel import DistXch, make_mesh\n"
        "op = DistXch.convert(coo, Config(format='xch'), "
        "make_mesh((('row', 2),), device='cpu'))\n"
        "ok, det = verify_result(coo, x, op(x).numpy())\n"
        "assert ok, det\n"
        "bad = sorted(m for m in sys.modules if m.startswith("
        "('jax', 'singlespmv_tpu.')) or m == 'jaxlib')\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


@pytest.mark.parametrize("name", ["g7jac200sc", "lhr34"])
def test_synthesize_structured_matches_reference(name):
    want, got = ref_synth(name), synthesize_structured(name)
    assert (got.n_row, got.n_col) == (want.n_row, want.n_col)
    for k in ("row", "col", "val"):
        a, b = getattr(want, k), getattr(got, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(b, a, err_msg=k)


def test_native_host_helpers_match_numpy():
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 1 << 40, 200_000)
    keys[::7] = keys[0]                           # ties: the sort is stable
    np.testing.assert_array_equal(hostmem.argsort_keys(keys),
                                  np.argsort(keys, kind="stable"))
    grid = np.zeros((500, 128), np.float32)
    rows = rng.permutation(500 * 128)[:20_000]
    vals = rng.uniform(size=20_000).astype(np.float32)
    hostmem.scatter2d(grid, rows // 128, rows % 128, vals)
    want = np.zeros_like(grid)
    want[rows // 128, rows % 128] = vals
    np.testing.assert_array_equal(grid, want)
    if native.radix_argsort(keys) is None:
        pytest.skip("no host C++ compiler: numpy paths only")


def test_chip_constants_are_the_ports_own(monkeypatch, tmp_path):
    from singlespmv_tpu_torch.core import chipconst

    assert "singlespmv_tpu_torch" in chipconst._path()
    assert not chipconst._path().endswith(
        os.path.join("results", "chip_constants.json"))
    monkeypatch.setenv("SPMV_TORCH_CHIP_CONSTANTS", "")
    monkeypatch.setattr(chipconst, "_cache", None)
    assert chipconst.load() == chipconst.DEFAULTS
    monkeypatch.setattr(chipconst, "_cache", None)


def test_port_config_and_matrix_are_its_own():
    from singlespmv_tpu_torch import Config as PortConfig
    from singlespmv_tpu_torch.core import COOMatrix as PortCOO

    assert PortConfig is not Config and PortCOO is not COOMatrix
    coo = powerlaw(300, 2000, seed=1)
    with pytest.raises(TypeError):             # not a path, not the port's
        run_benchmark(coo, port_cfg(Config()), quick=True, device="cpu",
                      log=lambda m: None)
