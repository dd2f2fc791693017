"""Port SpMM, Y = A @ X, at format level on the CPU against the reference's
``spmm_fn``: the panel paths of slab (unit mode) and xch (with a nested
long-row state), bsr's block-ELL and chunked products, dense, csr, hyb and
auto, and ``spmm_fn``'s column loop for formats without an ``spmm`` (ss,
css, dia).  One COO, converted by each package, and one panel X made from a
seed by numpy go through both.

The port's plain kernel versions sum in another order than the Pallas
kernels (interpret mode) and XLA, so Y agrees to rtol 1e-5 with atol
1e-5·max|Y| in float32; float64 SpMM takes the column loop over the
native-fp64 spmv and agrees with the dense float64 product to
1e-12·max|Y|.  ``auto.estimate_costs`` with ``spmm_b`` agrees with the
reference's to 1e-12 relative.  Shapes are small: the reference's panels
run its Pallas kernels in interpret mode.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singlespmv_tpu.config import Config
from singlespmv_tpu.data.generators import generate, powerlaw
from singlespmv_tpu.formats import auto as ref_auto
from singlespmv_tpu.formats import base as ref_base
from singlespmv_tpu.core.types import COOMatrix
from singlespmv_tpu.formats import slab as ref_slab
from singlespmv_tpu.formats import xch as ref_xch
from singlespmv_tpu_torch import formats
from singlespmv_tpu_torch.formats import auto, bsr, slab, xch
from test_torch_auto import IDS, MATS
from test_torch_dia_hyb import _mixed
from test_xch import _mix
from torch_parity import port_cfg, port_coo

RTOL = 1e-5


def _panel(n_col, n_cols, seed, dtype=np.float32):
    return np.random.default_rng(seed).uniform(-1.0, 1.0,
                                               (n_col, n_cols)).astype(dtype)


def _dense(coo):
    a = np.zeros((coo.n_row, coo.n_col))
    np.add.at(a, (coo.row, coo.col), coo.val)
    return a


def _ref_spmm(coo, cfg, X, **kw):
    st = ref_base.get_format(cfg.format).convert(coo, cfg, **kw)
    return np.asarray(ref_base.spmm_fn(cfg)(st, jnp.asarray(X)))


def _port_spmm(coo, cfg, X, **kw):
    pcfg = port_cfg(cfg)
    st = formats.get_format(cfg.format).convert(port_coo(coo), pcfg, **kw)
    Y = formats.spmm_fn(pcfg)(st, torch.from_numpy(X))
    assert Y.shape == (coo.n_row, X.shape[1]) and Y.dtype == torch.float32
    return Y.numpy(), st


def _close(got, want):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


def _refuse(*a, **k):
    raise AssertionError("this path must not run")


def _unit_plans(coo, planes):
    """Each package's unit-mode slab plan at ``planes`` (16: pair blocks)."""
    fixed = {"mode": "unit", "kblk": 1, "m": 8, "t": 32, "planes": planes}
    rows, cols = coo.row.astype(np.int64), coo.col.astype(np.int64)
    plans = []
    for mod in (ref_slab, slab):
        p = mod._estimate_cols(rows, cols, coo.nnz, fixed=fixed)
        p.update(hub_cols=None, cols_eff=None, hub_off=0)
        plans.append(p)
    return plans


@pytest.mark.parametrize("planes", [8, 16])
def test_slab_unit_panel_matches_reference(planes, monkeypatch):
    coo = powerlaw(1500, 8000, seed=2)
    cfg = Config(format="slab")
    ref_plan, plan = _unit_plans(coo, planes)
    X = _panel(coo.n_col, 3, seed=1)
    want = _ref_spmm(coo, cfg, X, plan=ref_plan)
    monkeypatch.setattr(slab, "column_loop", _refuse)      # the panel path
    got, st = _port_spmm(coo, cfg, X, plan=plan)
    assert (st.mode, st.planes) == ("unit", planes)
    _close(got, want)


def test_slab_blk_takes_the_column_loop(monkeypatch):
    coo = powerlaw(1500, 8000, seed=3)
    cfg = Config(format="slab")
    X = _panel(coo.n_col, 2, seed=2)
    want = _ref_spmm(coo, cfg, X)
    monkeypatch.setattr(slab, "slab_spmm", _refuse)
    got, st = _port_spmm(coo, cfg, X)
    assert st.mode == "blk"
    _close(got, want)


def test_slab_panel_gates(monkeypatch):
    """Unit mode takes the panel for 2 ≤ B ≤ 32 only."""
    coo = powerlaw(1500, 8000, seed=2)
    st = slab.convert(port_coo(coo), port_cfg(Config(format="slab")),
                      plan=_unit_plans(coo, 8)[1])
    looped, real = [], slab.column_loop

    def loop(spmv, state, X):
        looped.append(X.shape[1])
        return real(spmv, state, X)

    monkeypatch.setattr(slab, "column_loop", loop)
    a = _dense(coo)
    for n_cols in (1, 2, 32, 33):
        X = _panel(coo.n_col, n_cols, seed=n_cols)
        _close(slab.spmm(st, torch.from_numpy(X)).numpy(),
               (a @ X.astype(np.float64)).astype(np.float32))
    assert looped == [1, 33]


def _xch_plans(coo, **fix):
    """Each package's xch plan with the reference's ``*_fix`` keys."""
    cfg = Config(format="xch")
    return (ref_xch.estimate(coo, cfg) | fix,
            xch.estimate(port_coo(coo), port_cfg(cfg)) | fix)


def _long_rows(n=5000, seed=11):
    """Scatter plus 4 rows of degree 800, which the planner splits into a
    nested state."""
    rng = np.random.default_rng(seed)
    rows = np.concatenate([rng.integers(0, n, 15000),
                           np.repeat(rng.choice(n, 4, replace=False), 800)])
    return COOMatrix.from_triplets(n, n, rows, rng.integers(0, n, len(rows)),
                                   rng.uniform(1, 2, len(rows)), sort=True)


@pytest.mark.parametrize("label,make,n_cols", [
    ("plain", lambda: _mix(3000, 15000, 0), 3),
    ("nested-long", _long_rows, 2)])
def test_xch_panel_matches_reference(label, make, n_cols, monkeypatch):
    coo = make()
    ref_plan, plan = _xch_plans(coo, t1_fix=32, t2_fix=32)
    X = _panel(coo.n_col, n_cols, seed=3)
    want = _ref_spmm(coo, Config(format="xch"), X, plan=ref_plan)
    monkeypatch.setattr(xch, "column_loop", _refuse)    # the panel path
    got, st = _port_spmm(coo, Config(format="xch"), X, plan=plan)
    assert st.n_slots1 and (st.long is not None) == (label == "nested-long")
    _close(got, want)


def test_xch_panel_gate_and_peeled_bands():
    """B = 17 takes the column loop; a peeled band adds over the panel."""
    coo = generate("band", 3000, 2, seed=5)
    extra = _mix(3000, 6000, 6)
    coo = type(coo).from_triplets(
        3000, 3000, np.concatenate([coo.row, extra.row]),
        np.concatenate([coo.col, extra.col]),
        np.concatenate([coo.val, extra.val]), sort=True, sum_duplicates=True)
    st = xch.convert(port_coo(coo), port_cfg(Config(format="xch")))
    assert st.dia_offs
    a = _dense(coo)
    for n_cols in (3, 17):
        X = _panel(coo.n_col, n_cols, seed=n_cols)
        Y = xch.spmm(st, torch.from_numpy(X)).numpy()
        _close(Y, (a @ X.astype(np.float64)).astype(np.float32))


@pytest.mark.parametrize("label,make,ell", [
    ("ell", lambda: generate("band", 2000, 8, seed=1), True),
    ("chunked", lambda: generate("unbalance", 2000, seed=1), False)])
def test_bsr_matches_reference(label, make, ell, monkeypatch):
    coo = make()
    X = _panel(coo.n_col, 12, seed=5)
    want = _ref_spmm(coo, Config(format="bsr"), X)
    monkeypatch.setattr(bsr, "MAX_GATHERED_ELEMS", 1)   # chunks of 8 cols
    got, st = _port_spmm(coo, Config(format="bsr"), X)
    assert bool(st.ell_k) == ell
    _close(got, want)


def test_bsr_ell_fields_match_reference():
    coo = generate("band", 2000, 8, seed=1)
    cfg = Config(format="bsr")
    ref = ref_base.get_format("bsr").convert(coo, cfg)
    st = bsr.convert(port_coo(coo), port_cfg(cfg))
    assert st.ell_k == ref.ell_k > 0
    for f in ("ell_blocks", "ell_bcol"):
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(ref, f)))
    moved = bsr.state_from_reference({
        f.name: (np.asarray(v) if hasattr(v, "shape") else v)
        for f in dataclasses.fields(ref)
        for v in (getattr(ref, f.name),)})
    X = torch.from_numpy(_panel(coo.n_col, 3, seed=6))
    assert moved.ell_k == ref.ell_k
    assert torch.equal(bsr.spmm(moved, X), bsr.spmm(st, X))


@pytest.mark.parametrize("fmt,make", [
    ("dense", lambda: generate("random", 400, 40000, seed=4)),
    ("csr", lambda: powerlaw(2000, 20000, seed=4)),
    ("hyb", lambda: _mixed(1500, 7, 6, 3)),
    ("auto", lambda: powerlaw(3000, 30000, seed=2)),
    # no spmm of their own: spmm_fn's column loop of spmv
    ("ss", lambda: powerlaw(2000, 20000, seed=5)),
    ("css", lambda: powerlaw(2000, 20000, seed=6)),
    ("dia", lambda: generate("band", 2000, 8, seed=2)),
])
def test_spmm_matches_reference(fmt, make):
    coo = make()
    cfg = Config(format=fmt, spmm_b=6 if fmt == "auto" else 0)
    X = _panel(coo.n_col, 6, seed=7)
    want = _ref_spmm(coo, cfg, X)
    got, st = _port_spmm(coo, cfg, X)
    if fmt == "auto":
        assert st.chosen == ref_auto.choose(coo, cfg)
    if fmt == "hyb":
        assert st.rest_fmt
    _close(got, want)


@pytest.mark.parametrize("fmt,make", [
    ("slab", lambda: _mix(3000, 15000, 1)),
    ("xch", lambda: _mix(3000, 15000, 1)),
    ("bsr", lambda: generate("band", 2000, 8, seed=1))])
def test_float64_spmm_matches_dense_product(fmt, make, monkeypatch):
    """float64 panels take the column loop over the fp64 spmv, as the
    reference's do on its chip: no panel kernel runs."""
    coo = make()
    for name in ("slab_spmm", "xch_mul_panel", "xch_route4_panel"):
        for mod in (slab, xch):
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, _refuse)
    st = formats.convert(port_coo(coo),
                         port_cfg(Config(format=fmt, dtype="float64")))
    X = _panel(coo.n_col, 5, seed=8, dtype=np.float64)
    Y = formats.spmm_fn(port_cfg(Config(format=fmt)))(st, torch.from_numpy(X))
    assert Y.dtype == torch.float64
    want = _dense(coo) @ X
    assert np.abs(Y.numpy() - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("spmm_b", [8, 32])
@pytest.mark.parametrize("label,make", MATS, ids=IDS)
def test_estimate_costs_spmm_b_match_reference(label, make, spmm_b):
    coo = make()
    cfg = Config(format="auto", spmm_b=spmm_b)
    want = ref_auto.estimate_costs(coo, cfg)
    got = auto.estimate_costs(port_coo(coo), port_cfg(cfg))
    assert set(got) == set(want)
    for k, v in got.items():
        assert v == pytest.approx(want[k], rel=1e-12, abs=0), k
    spmv = auto.estimate_costs(port_coo(coo),
                               port_cfg(cfg.replace(spmm_b=0)))
    assert got["csr"] == pytest.approx(spmm_b * spmv["csr"], rel=1e-12)
    if "slab" in got and spmm_b <= 32:
        assert got["slab"] == pytest.approx(spmm_b / 1.05 * spmv["slab"],
                                            rel=1e-12)
