"""The port's coo, ell, jds, bcoo and hostlib (and the aliases crs and mkl)
against the JAX package's on the same seeded inputs.

Tolerances: a float32 y agrees with the reference's y to 1e-6·max|y| and
passes the float64 COO oracle (1e-6 abs-or-rel); a float64 y agrees with
the reference's to 1e-12·max|y|.  ``to_coo`` gives back the matrix
exactly (its values in float32), and ``report_fields`` and
``traffic_bytes`` equal the reference's.  A cache round trip gives back every field of a state.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singlespmv_tpu import formats as ref_formats
from singlespmv_tpu.config import Config
from singlespmv_tpu.data import fixtures as fx
from singlespmv_tpu.data.generators import generate, powerlaw
from singlespmv_tpu_torch import formats
from singlespmv_tpu_torch.core.oracle import verify_result
from singlespmv_tpu_torch.formats import cache, csr, hostlib
from singlespmv_tpu_torch.harness import run_benchmark
from singlespmv_tpu_torch.harness.report import FORMAT_NAMES
from torch_parity import port_cfg, port_coo

FMTS = ("coo", "ell", "jds", "bcoo", "hostlib")
F32_TOL = 1e-6
F64_TOL = 1e-12

MATS = [(n, f()) for n, f in fx.ALL_FIXTURES.items()] + [
    ("band-300", generate("band", 300, 7, seed=2)),
    ("powerlaw-900", powerlaw(900, 7000, seed=5)),
]
IDS = [n for n, _ in MATS]


@contextlib.contextmanager
def x64_restored():
    """Puts ``jax_enable_x64`` back as it was on entry (the reference's
    float64 convert turns it on for good)."""
    saved = jax.config.jax_enable_x64
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", saved)


@pytest.fixture(autouse=True)
def _x64_scope():
    with x64_restored():
        yield


def _x(coo, dtype=np.float32, seed=3):
    return np.random.default_rng(seed).uniform(-1, 1, coo.n_col).astype(dtype)


def _ref_spmv(coo, cfg, x):
    state = ref_formats.convert(coo, cfg)
    return np.asarray(ref_formats.spmv_fn(cfg)(state, x)), state


def _port(coo, cfg):
    pcfg = port_cfg(cfg)
    return formats.convert(port_coo(coo), pcfg), pcfg


def _close(got, want, tol):
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("label,coo", MATS, ids=IDS)
def test_spmv_f32_matches_reference(fmt, label, coo):
    cfg = Config(format=fmt)
    x = _x(coo)
    want, ref_state = _ref_spmv(coo, cfg, x)
    state, pcfg = _port(coo, cfg)
    got = formats.spmv_fn(pcfg)(state, torch.from_numpy(x)).numpy()
    _close(got, want, F32_TOL)
    ok, det = verify_result(port_coo(coo), x, got, dtype=np.float32)
    assert ok, det
    assert formats.report_fields(state, pcfg) == \
        ref_formats.report_fields(ref_state, cfg)
    assert formats.traffic_bytes(state, pcfg) == \
        ref_formats.traffic_bytes(ref_state, cfg)


@pytest.mark.parametrize("fmt", ("coo", "ell", "jds"))
@pytest.mark.parametrize("label,coo", MATS[-3:], ids=IDS[-3:])
def test_spmv_f64_matches_reference(fmt, label, coo):
    cfg = Config(format=fmt, dtype="float64")
    x = _x(coo, np.float64)
    want, _ = _ref_spmv(coo, cfg, x)
    state, pcfg = _port(coo, cfg)
    got = formats.spmv_fn(pcfg)(state, torch.from_numpy(x)).numpy()
    assert got.dtype == np.float64
    _close(got, want, F64_TOL)


@pytest.mark.parametrize("fmt", ("ell", "hostlib"))
@pytest.mark.parametrize("label,coo", MATS[-2:], ids=IDS[-2:])
def test_spmm_matches_reference(fmt, label, coo):
    cfg = Config(format=fmt)
    X = np.random.default_rng(4).uniform(-1, 1, (coo.n_col, 5)).astype(
        np.float32)
    ref_state = ref_formats.convert(coo, cfg)
    want = np.asarray(ref_formats.spmm_fn(cfg)(ref_state, jnp.asarray(X)))
    state, pcfg = _port(coo, cfg)
    assert formats.spmm_fn(pcfg) is formats.get_format(fmt).spmm
    got = formats.spmm_fn(pcfg)(state, torch.from_numpy(X)).numpy()
    _close(got, want, F32_TOL)


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("label,coo", MATS, ids=IDS)
def test_to_coo_round_trip(fmt, label, coo):
    state, pcfg = _port(coo, Config(format=fmt))
    back = formats.to_coo(state, pcfg)
    # the float32 values the state holds, exactly
    np.testing.assert_array_equal(
        back.to_dense(), coo.to_dense().astype(np.float32).astype(np.float64))


def test_aliases():
    assert formats.get_format("crs") is csr
    assert formats.get_format("mkl") is hostlib
    assert FORMAT_NAMES["crs"] == "CRS"
    coo = powerlaw(500, 3000, seed=6)
    x = _x(coo)
    for alias, name in (("crs", "csr"), ("mkl", "hostlib")):
        want, _ = _ref_spmv(coo, Config(format=alias), x)
        state, pcfg = _port(coo, Config(format=alias))
        got = formats.spmv_fn(pcfg)(state, torch.from_numpy(x)).numpy()
        _close(got, want, F32_TOL)
        assert type(state) is type(formats.convert(port_coo(coo), port_cfg(
            Config(format=name))))


def test_hostlib_runs_on_the_host_whatever_the_device():
    """hostlib's PREFERRED_DEVICE puts state and x on the CPU, as the
    reference's driver does; the block says so and names the library."""
    import scipy

    coo = port_coo(powerlaw(400, 2400, seed=7))
    res = run_benchmark(coo, port_cfg(Config(format="mkl")), quick=True,
                        device="cuda", log=lambda m: None)
    rep = res.report
    assert res.verify_ok and rep["PreferredDevice"] == "cpu"
    assert rep["Architecture"] == "CPU" and rep["Chip"] == "host cpu"
    assert rep["Library"] == f"scipy.sparse {scipy.__version__}"
    with pytest.raises(ValueError, match="runs on the host"):
        hostlib.spmv(formats.convert(coo, port_cfg(Config(
            format="hostlib"))), torch.zeros(coo.n_col, device="meta"))


def _assert_same(a, b, path="state"):
    assert type(a) is type(b), path
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name),
                         f"{path}.{f.name}")
    elif isinstance(a, torch.Tensor) and a.is_sparse:
        assert b.is_sparse and b.is_coalesced() and a.shape == b.shape
        _assert_same(a.indices(), b.indices(), f"{path}.indices")
        _assert_same(a.values(), b.values(), f"{path}.values")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    elif isinstance(a, tuple):
        assert len(a) == len(b), path
        for i, (u, v) in enumerate(zip(a, b)):
            _assert_same(u, v, f"{path}[{i}]")
    else:
        assert a == b, path


@pytest.mark.parametrize("fmt", FMTS + ("ellg",))
def test_cache_round_trip(tmp_path, fmt):
    from test_torch_ellg import mixed_tail

    coo = mixed_tail() if fmt == "ellg" else powerlaw(900, 7000, seed=5)
    pcoo, pcfg = port_coo(coo), port_cfg(Config(format=fmt))
    state = formats.convert(pcoo, pcfg)
    if fmt == "ellg":       # a pass of one member (no src) and a bkt_g rest
        assert any(p.src is None for p in state.passes)
        assert state.rest_fmt == "bkt_g"
    cache.save_state(str(tmp_path / fmt), state, pcoo, pcfg)
    loaded = cache.load_state(str(tmp_path / fmt), pcoo, pcfg)
    _assert_same(state, loaded)
    x = torch.from_numpy(_x(coo))
    spmv = formats.spmv_fn(pcfg)
    assert torch.equal(spmv(loaded, x), spmv(state, x))
