"""The port's converted-state cache (``formats/cache.py``): round trips of
every kind of state through ``save_state``/``load_state``, each loaded
state's spmv against the JAX package's on the same COO, and the
fingerprint that refuses a stale state.

A loaded state must equal the saved one field by field: tensors (their
dtype too), tuples of tensors, nested states (xch's ``long``, hyb's dia and
residual, auto's ``inner``) and scalars (csr5's convert times, auto's
``costs``, ``trials`` and ``failed``).  Its spmv agrees with the
reference's to rtol 1e-5 with atol 1e-5·max|y| in float32.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from singlespmv_tpu import formats as ref_formats
from singlespmv_tpu.config import Config
from singlespmv_tpu.core.types import COOMatrix
from singlespmv_tpu.data.generators import powerlaw
from singlespmv_tpu_torch import formats
from singlespmv_tpu_torch.formats import auto, cache, csr5, slab, xch
from singlespmv_tpu_torch.harness import run_benchmark
from torch_parity import port_cfg, port_coo

RTOL = 1e-5


def _assert_same(a, b, path="state"):
    assert type(a) is type(b), path
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name),
                         f"{path}.{f.name}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for i, (u, v) in enumerate(zip(a, b)):
            _assert_same(u, v, f"{path}[{i}]")
    else:
        assert a == b, path


def _long_rows():
    from test_torch_xch_ops import long_rows_matrix

    return long_rows_matrix()


CASES = {
    "csr": (Config(format="csr"), lambda: powerlaw(2000, 12000, seed=3)),
    "slab": (Config(format="slab"), lambda: powerlaw(3000, 20000, seed=2)),
    "xch-long": (Config(format="xch"), _long_rows),
    "hyb": (Config(format="hyb"), lambda: powerlaw(3000, 20000, seed=4)),
    "bkt": (Config(format="bkt"), lambda: powerlaw(2000, 12000, seed=5)),
    "csr5": (Config(format="csr5", sigma=2),
             lambda: powerlaw(2000, 12000, seed=6)),
}


def _x(coo):
    return np.random.default_rng(3).uniform(-1, 1, coo.n_col).astype(
        np.float32)


def _ref_y(coo, cfg, x):
    state = ref_formats.convert(coo, cfg)
    return np.asarray(jax.jit(ref_formats.spmv_fn(cfg))(state, x))


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("label", sorted(CASES))
def test_round_trip(tmp_path, label):
    cfg, make = CASES[label]
    coo = make()
    pcoo, pcfg = port_coo(coo), port_cfg(cfg)
    state = formats.convert(pcoo, pcfg)
    if label == "xch-long":
        assert state.long is not None
    path = str(tmp_path / label)
    cache.save_state(path, state, pcoo, pcfg)
    loaded = cache.load_state(path, pcoo, pcfg)
    _assert_same(state, loaded)
    if label == "csr5":
        assert formats.report_fields(loaded, pcfg) == \
            formats.report_fields(state, pcfg)
        assert loaded.convert_ms == state.convert_ms and loaded.convert_ms
    x = _x(coo)
    got = formats.spmv_fn(pcfg)(loaded, torch.from_numpy(x)).numpy()
    _close(got, _ref_y(coo, cfg, x))


def test_auto_round_trip_keeps_the_choice(tmp_path):
    coo = powerlaw(3000, 20000, seed=7)
    cfg = Config(format="auto")
    pcoo, pcfg = port_coo(coo), port_cfg(cfg)
    state = auto.convert(pcoo, pcfg)
    state = dataclasses.replace(
        state, trials=((state.chosen, 1.25e-5), ("xch", 3.5e-5)),
        failed=(("bsr", "ValueError: fill"),))
    cache.save_state(str(tmp_path / "a"), state, pcoo, pcfg)
    loaded = cache.load_state(str(tmp_path / "a"), pcoo, pcfg)
    _assert_same(state, loaded)
    assert loaded.costs and loaded.costs == state.costs
    x = _x(coo)
    got = auto.spmv(loaded, torch.from_numpy(x)).numpy()
    _close(got, _ref_y(coo, cfg, x))


def test_fingerprint_mismatch_gives_none(tmp_path):
    coo = powerlaw(1000, 6000, seed=8)
    pcoo, pcfg = port_coo(coo), port_cfg(Config(format="slab"))
    cache.save_state(str(tmp_path / "s"), formats.convert(pcoo, pcfg), pcoo,
                     pcfg)
    other = COOMatrix(n_row=coo.n_row, n_col=coo.n_col, row=coo.row,
                      col=coo.col, val=coo.val * 2)
    assert cache.load_state(str(tmp_path / "s"), other, pcfg) is None
    assert cache.load_state(str(tmp_path / "s"), pcoo,
                            pcfg.replace(segment_width=1024)) is None
    assert cache.load_state(str(tmp_path / "missing"), pcoo, pcfg) is None
    assert cache.load_state(str(tmp_path / "s"), pcoo, pcfg) is not None


@pytest.mark.parametrize("fmt,bumped", [("slab", slab), ("auto", xch)])
def test_state_rev_bump_gives_none(tmp_path, monkeypatch, fmt, bumped):
    """A bump of a format's ``STATE_REV`` invalidates its states, and a
    bump of any engine's invalidates auto's."""
    coo = port_coo(powerlaw(1000, 6000, seed=9))
    cfg = port_cfg(Config(format=fmt))
    path = str(tmp_path / fmt)
    cache.save_state(path, formats.get_format(fmt).convert(coo, cfg), coo,
                     cfg)
    assert cache.load_state(path, coo, cfg) is not None
    monkeypatch.setattr(bumped, "STATE_REV", bumped.STATE_REV + 1)
    assert cache.load_state(path, coo, cfg) is None


@pytest.mark.parametrize("field,value", [
    ("n_trials", 3), ("calibrate_seconds", 0.05), ("verify", False),
    ("profiling", True), ("measure_step_time", True)])
def test_fields_convert_does_not_read_keep_the_state(tmp_path, field, value):
    coo = port_coo(powerlaw(1000, 6000, seed=10))
    cfg = port_cfg(Config(format="csr"))
    cache.save_state(str(tmp_path / "c"), formats.convert(coo, cfg), coo, cfg)
    assert cache.load_state(str(tmp_path / "c"), coo,
                            cfg.replace(**{field: value})) is not None


def test_convert_cached_loads_the_second_time(tmp_path, monkeypatch):
    coo = port_coo(powerlaw(1000, 6000, seed=11))
    cfg = port_cfg(Config(format="slab"))
    first = cache.convert_cached(coo, cfg, str(tmp_path), "pl")
    monkeypatch.setattr(slab, "convert", lambda *a, **k: pytest.fail(
        "a cached state was converted again"))
    again = cache.convert_cached(coo, cfg, str(tmp_path), "pl")
    _assert_same(first, again)


def test_run_benchmark_with_cache_dir(tmp_path):
    coo = powerlaw(2000, 12000, seed=12)
    cfg = Config(format="slab")
    runs = [run_benchmark(port_coo(coo), port_cfg(cfg), quick=True,
                          cache_dir=str(tmp_path), device="cpu",
                          log=lambda m: None) for _ in range(2)]
    assert all(r.verify_ok for r in runs)
    assert np.array_equal(runs[0].y, runs[1].y)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "in-memory-slab.json", "in-memory-slab.npz"]


def test_only_the_ports_states_load(tmp_path):
    coo = port_coo(powerlaw(500, 3000, seed=13))
    cfg = port_cfg(Config(format="csr"))
    path = str(tmp_path / "c")
    cache.save_state(path, formats.convert(coo, cfg))
    with open(path + ".json") as f:
        text = f.read()
    with open(path + ".json", "w") as f:
        f.write(text.replace("singlespmv_tpu_torch.formats.csr",
                             "os.path"))
    with pytest.raises(ValueError, match="not the port's"):
        cache.load_state(path)
