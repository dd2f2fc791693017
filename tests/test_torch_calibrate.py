"""Port calibration, plain path: ``singlespmv_tpu_torch.ops.xch.xch_route``
on CPU tensors against the reference's Pallas ``xch_route`` in interpret
mode, and ``harness/calibrate.measure``'s fit against the reference's.

``xch_route``'s plain version takes the row prefix with ``torch.cumsum`` and
routes by ``index_add_`` where the TPU kernel uses a triangle matmul and
masked sums, so sums round in another order: outputs agree to
1e-5·max|out|.  The fit is checked key for key on scripted timings: both
packages' ``_bench`` return the same times in call order.
"""
import json
import math

import numpy as np
import pytest
import torch

from singlespmv_tpu.harness import calibrate as ref_cal
from singlespmv_tpu.ops.pallas.xch import xch_route as pallas_route
from singlespmv_tpu_torch.core import chipconst
from singlespmv_tpu_torch.harness import calibrate
from singlespmv_tpu_torch.harness.roofline import ChipSpec
from singlespmv_tpu_torch.ops import xch as ops

TOL = 1e-5
KEYS = {"hbm_bps", "step_fixed_s", "base_slot_s", "sel_slot_s",
        "route_slot_s", "scatter_rate"}


def _route_case(planes, m, T=64, H=1024, g_grp=16, seed=0):
    """The reference's ``_route_args`` as numpy arrays, with gids and ngb
    for ``g_grp``."""
    args, _ = ref_cal._route_args(np.random.default_rng(seed), H, planes, m,
                                  T)
    arrs = [np.array(a) for a in args]
    arrs[1] = (arrs[0] // g_grp).astype(np.int32)
    return arrs, int(arrs[1][-1]) + 1


def _check_route(arrs, ngb, m, planes, T, g_grp=16, pg=8):
    want = np.asarray(pallas_route(*arrs, ngb, m, planes, T, g_grp, pg))
    tens = [torch.from_numpy(a) for a in arrs]
    before = ops.xch_route.launches
    got = ops.xch_route(*tens, ngb, m, planes, T, g_grp, pg).numpy()
    assert ops.xch_route.launches == before          # CPU: plain version
    assert got.shape == want.shape == (ngb * g_grp * planes, 128)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * np.abs(want).max())
    return got


@pytest.mark.parametrize("planes", [8, 16])
def test_route_matches_pallas_on_calibrate_args(planes):
    arrs, ngb = _route_case(planes, 1)
    _check_route(arrs, ngb, 1, planes, 64)


def test_route_prunes_by_plane_groups():
    """m 8, g_grp 2, pg 4 and random sg0/sg1: groups outside the range are
    skipped, a group that meets it routes all of its planes, and a step
    whose sg1 < sg0 routes a group only where both fall into it (the TPU
    kernel's predicate)."""
    planes, pg, T = 16, 4, 64
    arrs, ngb = _route_case(planes, 8, g_grp=2, seed=3)
    n_steps = len(arrs[0])
    rng = np.random.default_rng(5)
    sg0 = rng.integers(-2, planes + 2, n_steps).astype(np.int32)
    sg1 = rng.integers(-2, planes + 2, n_steps).astype(np.int32)
    sg0[0], sg1[0] = 0, -1          # empty: no group
    sg0[1], sg1[1] = 9, 6           # sg1 < sg0 across groups: no group
    sg0[2], sg1[2] = 6, 5           # sg1 < sg0 in group 1: routes it
    sg0[3], sg1[3] = 5, 9           # groups 1 and 2, all 8 planes
    arrs[3], arrs[4] = sg0, sg1
    got = _check_route(arrs, ngb, 8, planes, T, g_grp=2, pg=pg)
    full = arrs[:3] + [np.zeros(n_steps, np.int32),
                       np.full(n_steps, planes - 1, np.int32)] + arrs[5:]
    unpruned = ops.xch_route(*map(torch.from_numpy, full), ngb, 8, planes,
                             T, 2, pg).numpy()
    assert not np.allclose(got, unpruned)        # the pruning took effect


def test_route_wrapper_checks():
    arrs, ngb = _route_case(8, 1, H=256)
    tens = [torch.from_numpy(a) for a in arrs]
    with pytest.raises(ValueError):
        ops.xch_route(*tens, ngb, 1, 8, 48)                 # H % T
    with pytest.raises(ValueError):
        ops.xch_route(*tens[:9], tens[9][:4], tens[10], ngb, 1, 8, 64)
    with pytest.raises(TypeError):
        ops.xch_route(*tens[:10], tens[10].double(), ngb, 1, 8, 64)
    big = torch.full((65, 256, 128), -1, dtype=torch.int8)
    with pytest.raises(ValueError, match="planes"):
        ops.xch_route(*tens[:9], big, tens[10], ngb, 1, 65, 64)
    with pytest.raises(ValueError, match="cuda"):
        ops.xch_route(*[t.to("meta") for t in tens], ngb, 1, 8, 64)


SCRIPTS = [
    # hbm, xch_mul T32 m1, T128 m1, T128 m8, route p8, p16, scatter
    (1.2e-4, 3.1e-5, 2.2e-5, 4.7e-5, 1.1e-5, 1.9e-5, 8.0e-5),
    # the card's case: T32 no dearer than T128, p16 no dearer than p8
    (1.2e-4, 2.0e-5, 2.2e-5, 4.7e-5, 1.9e-5, 1.1e-5, 8.0e-5),
]


@pytest.mark.parametrize("times", SCRIPTS)
def test_fit_is_the_references(monkeypatch, times):
    def scripted():
        it = iter(times)
        return lambda fn, args, loop=16: next(it)

    monkeypatch.setattr(ref_cal, "_bench", scripted())
    want = ref_cal.measure(log=lambda m: None)
    monkeypatch.setattr(calibrate, "_bench", scripted())
    got = calibrate.measure("cpu", log=lambda m: None)
    assert got == want and set(got) == KEYS
    if times[1] < times[2]:
        assert got["step_fixed_s"] == 0.0        # the clamp; load skips it


def test_measure_on_the_host_at_small_sizes():
    got = calibrate.measure("cpu", log=lambda m: None, n_big=1 << 16,
                            H=1024, CB=256, n_scatter=1 << 12)
    assert set(got) == KEYS
    assert all(math.isfinite(v) and v >= 0 for v in got.values())
    assert got["hbm_bps"] > 0 and got["scatter_rate"] > 0


def test_no_card_no_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        calibrate.measure()


def test_main_saves_through_chipconst(monkeypatch, tmp_path):
    vals = dict.fromkeys(KEYS, 1e-9) | {"step_fixed_s": 0.0}
    monkeypatch.setattr(calibrate, "device_of", lambda d: torch.device("cpu"))
    monkeypatch.setattr(calibrate, "measure", lambda device: vals)
    out = tmp_path / "chip_constants.json"
    calibrate.main(["--out", str(out)])
    assert json.loads(out.read_text()) == vals
    monkeypatch.setenv("SPMV_TORCH_CHIP_CONSTANTS", str(out))
    monkeypatch.setattr(chipconst, "_cache", None)
    loaded = chipconst.load()
    assert loaded["step_fixed_s"] == chipconst.DEFAULTS["step_fixed_s"]
    assert loaded["route_slot_s"] == 1e-9
    monkeypatch.setattr(chipconst, "_cache", None)


def test_main_needs_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        calibrate.main(["--out", str(tmp_path / "c.json")])
    with pytest.raises(SystemExit):
        calibrate.main(["--device", "cpu"])        # no host run from the CLI


def test_screen_leaves_out_what_the_card_cannot_do(monkeypatch, tmp_path):
    """A bandwidth above the card's peak and a rate at _bench's clamp are
    left out, whatever else the fit read; main saves only the rest."""
    good = {"hbm_bps": 3.0e12, "step_fixed_s": 0.0, "base_slot_s": 1e-11,
            "sel_slot_s": 7e-13, "route_slot_s": 0.0,
            "scatter_rate": 1.0e11}
    assert calibrate.screen(good, 3350.0) == (good, {})
    assert calibrate.screen(good, None) == (good, {})
    bad = good | {"hbm_bps": 4.16e12,
                  "scatter_rate": calibrate.N_SCATTER / calibrate.CLAMP_S}
    keep, why = calibrate.screen(bad, 3350.0)
    assert set(why) == {"hbm_bps", "scatter_rate"}
    assert keep == {k: v for k, v in good.items() if k not in why}
    assert "peak" in why["hbm_bps"] and "clamp" in why["scatter_rate"]
    clamped = good | {"hbm_bps": calibrate.N_BIG * 4 / calibrate.CLAMP_S}
    assert set(calibrate.screen(clamped, None)[1]) == {"hbm_bps"}
    # the fit at the clamp, as _bench returns it
    monkeypatch.setattr(calibrate, "_bench", lambda fn, args, loop=16:
                        calibrate.CLAMP_S)
    fit = calibrate.measure("cpu", log=lambda m: None, n_big=1 << 10,
                            H=256, CB=64, n_scatter=1 << 10)
    assert set(calibrate.screen(fit, None, n_big=1 << 10,
                                n_scatter=1 << 10)[1]) == {
        "hbm_bps", "scatter_rate"}
    monkeypatch.setattr(calibrate, "device_of", lambda d: torch.device("cpu"))
    monkeypatch.setattr(calibrate, "detect_chip",
                        lambda d: ChipSpec("NVIDIA H100 SXM", 3350.0))
    monkeypatch.setattr(calibrate, "measure", lambda device: bad)
    out = tmp_path / "chip_constants.json"
    assert calibrate.main(["--out", str(out)]) == keep
    assert json.loads(out.read_text()) == keep
    monkeypatch.setattr(chipconst, "_cache", None)
