"""Port float64 against the reference's df64 path: the same COO converted by
both packages at float64 gives the same plans and index arrays, and the
port's float64 values equal the reference's (hi, lo) float32 planes' sum;
the port's plain float64 kernels agree with the reference's df64 Pallas
kernels (interpret mode) on the same layouts, and both spmv meet the oracle.

The df64 kernels carry ~48 bits, so kernels and spmv agree to
1e-11·max|y_ref|, and the port's spmv meets the float64 oracle to
1e-12·max|y|, which an f32 computation (~1e-7) would not.

The reference's float64 convert turns ``jax_enable_x64`` on for good
(``singlespmv_tpu/formats/base.py:74-83``); every test here runs inside
``x64_restored``, which puts the flag back, so later test files on the same
worker see the flag they started with.
"""
import contextlib
import dataclasses

import jax
import numpy as np
import pytest
import torch

from singlespmv_tpu.config import Config
from singlespmv_tpu.core.oracle import reference_spmv
from singlespmv_tpu.core.types import COOMatrix
from singlespmv_tpu.data.generators import generate, powerlaw
from singlespmv_tpu.formats import base as ref_base
from singlespmv_tpu.formats import slab as ref_slab
from singlespmv_tpu.formats import xch as ref_xch
from singlespmv_tpu.ops.pallas.slab import slab_spmv_df
from singlespmv_tpu.ops.pallas.xch import xch_mul_df, xch_route4_df
from singlespmv_tpu_torch.formats import slab, xch
from singlespmv_tpu_torch.ops import slab as slab_ops
from singlespmv_tpu_torch.ops import xch as xch_ops
from torch_parity import port_cfg, port_coo

F64 = Config(format="slab", dtype="float64")
X64 = F64.replace(format="xch")
TOL = 1e-11
VAL_TOL = 2.0 ** -44


@contextlib.contextmanager
def x64_restored():
    """Puts ``jax_enable_x64`` back as it was on entry."""
    saved = jax.config.jax_enable_x64
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", saved)


@pytest.fixture(autouse=True)
def _x64_scope():
    with x64_restored():
        yield


def test_x64_flag_comes_back_after_a_reference_f64_convert():
    coo = generate("band", 256, 4, seed=0)
    jax.config.update("jax_enable_x64", False)
    with x64_restored():
        st = ref_base.convert(coo, F64)
        assert jax.config.jax_enable_x64 and st.val_lo is not None
    assert not jax.config.jax_enable_x64


def _np(a):
    return np.asarray(a)


def _close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.dtype == np.float64 and got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _oracle_rel(coo, x, y):
    ref = reference_spmv(coo, x)
    return np.abs(_np(y) - ref).max() / max(np.abs(ref).max(), 1e-300)


def _split(a):
    """(hi, lo) float32 planes of a float64 array, as the reference's
    df64 path makes them."""
    a = _np(a)
    hi = a.astype(np.float32)
    return hi, (a - hi.astype(np.float64)).astype(np.float32)


def _assert_values(port_vals, hi, lo):
    want = _np(hi).astype(np.float64) + _np(lo).astype(np.float64)
    got = port_vals.numpy()
    assert got.dtype == np.float64
    assert (np.abs(got - want) <= VAL_TOL * np.abs(got)).all()


def _assert_same_state(ref, port, lo_fields, path=""):
    """Every field equal, but the value fields, which must equal the
    reference's hi + lo (``lo_fields``: port field → reference lo field),
    and the spmv route streams of xch and slab, which must equal
    ``route_rows`` of the reference's arrays (xch's ``val2`` holds values:
    ``route_rows`` takes them as the reference's hi + lo, so it must equal
    them as ``val1`` does)."""
    routes = xch.route_rows(ref) if isinstance(port, xch.Xch4State) \
        else slab.route_rows(ref) if isinstance(port, slab.SlabState) else {}
    for f in dataclasses.fields(port):
        a = routes[f.name] if f.name in routes else getattr(ref, f.name)
        b = getattr(port, f.name)
        name = path + f.name
        if isinstance(b, xch.Xch4State):
            _assert_same_state(a, b, lo_fields, name + ".")
        elif f.name in lo_fields and b is not None:
            lo = getattr(ref, lo_fields[f.name])
            if isinstance(b, tuple):
                assert len(a) == len(b) == len(lo), name
                for v, h, l_ in zip(b, a, lo):
                    _assert_values(v, h, l_)
            else:
                _assert_values(b, a, lo)
        elif f.name == "val2" and isinstance(port, xch.Xch4State):
            assert len(a) == len(b), name
            for x, y in zip(a, b):
                assert x.dtype == y.dtype == torch.float64, name
                assert (np.abs(x.numpy() - y.numpy())
                        <= VAL_TOL * np.abs(y.numpy())).all(), name
        elif isinstance(b, tuple) and b and isinstance(b[0], torch.Tensor):
            assert len(a) == len(b), name
            for x, y in zip(a, b):
                assert np.array_equal(_np(x), y.numpy()), name
                assert _np(x).dtype == y.numpy().dtype, name
        elif isinstance(b, torch.Tensor):
            assert np.array_equal(_np(a), b.numpy()), name
            assert _np(a).dtype == b.numpy().dtype, name
        else:
            assert a == b, (name, a, b)


def _host(st):
    """A reference state's fields on the host, recursively."""
    out = {}
    for f in dataclasses.fields(st):
        v = getattr(st, f.name)
        if isinstance(v, ref_xch.Xch4State):
            v = _host(v)
        elif isinstance(v, tuple) and v and hasattr(v[0], "shape"):
            v = tuple(np.asarray(a) for a in v)
        elif hasattr(v, "shape"):
            v = np.asarray(v)
        out[f.name] = v
    return out


def _unit_plan(mod, coo, planes, m):
    plan = mod._estimate_cols(coo.row.astype(np.int64),
                              coo.col.astype(np.int64), coo.nnz,
                              fixed={"mode": "unit", "kblk": 1, "m": m,
                                     "t": 32, "planes": planes},
                              unit_only=True)
    assert plan["feasible"]
    plan.update(hub_cols=None, cols_eff=None, hub_off=0)
    return plan


def test_slab_plan_parity():
    """The float64 planner is the reference's: unit mode only, priced
    ×DF_COST; the default convert gives the reference's arrays."""
    coo = powerlaw(3000, 30000, seed=7)
    a, b = ref_slab.estimate(coo, F64), slab.estimate(port_coo(coo),
                                                      port_cfg(F64))
    for k in ("feasible", "est_s", "slots", "m", "t", "planes", "mode",
              "kblk", "hub_off"):
        assert a[k] == b[k], k
    assert b["mode"] == "unit"
    ref, port = ref_slab.convert(coo, F64), slab.convert(port_coo(coo),
                                                         port_cfg(F64))
    _assert_same_state(ref, port, {"val": "val_lo"})
    x = np.random.default_rng(1).uniform(-1, 1, coo.n_col)
    y = slab.spmv(port, torch.from_numpy(x))
    assert _oracle_rel(coo, x, y) <= 1e-12
    _close(y, jax.jit(ref_slab.spmv)(ref, x))


@pytest.mark.parametrize("planes,m", [(8, 1), (16, 8)])
def test_slab_unit_kernel_matches_df64(planes, m):
    coo = powerlaw(2000, 16000, seed=planes + m)
    ref = ref_slab.convert(coo, F64, plan=_unit_plan(ref_slab, coo, planes,
                                                     m))
    port = slab.convert(port_coo(coo), port_cfg(F64),
                        plan=_unit_plan(slab, coo, planes, m))
    assert (port.planes, port.m, port.mode) == (planes, m, "unit")
    _assert_same_state(ref, port, {"val": "val_lo"})
    x = np.random.default_rng(m).uniform(-1, 1, coo.n_col)
    xt = slab.x_table(port, torch.from_numpy(x))
    xh, xl = (a.reshape(xt.shape) for a in _split(xt))
    for c, nu in enumerate(port.chunk_nu):
        oh, ol = slab_spmv_df(
            *(getattr(ref, f)[c] for f in ("uids", "sg0", "sg1", "win",
                                           "lane", "sub", "val", "val_lo",
                                           "hm1", "idx")),
            xh, xl, nu, m, ref.t_step, ref.pg or 2)
        before = slab_ops.slab_spmv.launches_f64
        got = slab_ops.slab_spmv(
            *(getattr(port, f)[c] for f in ("uids", "sg0", "sg1", "win",
                                            "lane", "sub", "val", "hm1",
                                            "idx")),
            xt, nu, m, port.t_step)
        assert slab_ops.slab_spmv.launches_f64 == before   # CPU: plain
        # out blocks that no step owns are left unwritten by the Pallas
        # kernel (NaN in interpret mode) and come back zero from the port
        owned = np.repeat(np.isin(np.arange(nu), _np(port.uids[c])),
                          planes)
        assert owned.any()
        _close(_np(got)[owned], (_np(oh).astype(np.float64)
                            + _np(ol).astype(np.float64))[owned])
    y = slab.spmv(port, torch.from_numpy(x))
    assert _oracle_rel(coo, x, y) <= 1e-12
    carried = slab.state_from_reference(_host(ref))
    _close(slab.spmv(carried, torch.from_numpy(x)), y, 1e-12)


def _peeled_long_rows():
    """3 rows of degree ~900 (a nested state) over a scatter of degree ~20,
    plus two full diagonals: the planner peels them and the scatter's
    densest offsets into bands.  Small route plans (kblk ≤ 2, p_oh 8) keep
    the df64 route's interpret-mode trace short."""
    rng = np.random.default_rng(11)
    n = 1200
    d = np.arange(n)
    rows = np.concatenate([rng.integers(0, n, 24000),
                           np.repeat(rng.choice(n, 3, replace=False), 900)])
    cols = rng.integers(0, n, len(rows))
    return COOMatrix.from_triplets(
        n, n, np.concatenate([rows, d, d[1:]]),
        np.concatenate([cols, d, d[1:] - 1]),
        np.concatenate([rng.uniform(1, 2, len(rows)),
                        rng.uniform(-2, 2, 2 * n - 1)]),
        sort=True, sum_duplicates=True)


def test_xch_kernels_and_spmv_match_df64():
    """Both kernels call by call on the main state; the nested state's
    kernels through the spmv, which runs them in both packages."""
    coo = _peeled_long_rows()
    ref, port = ref_xch.convert(coo, X64), xch.convert(port_coo(coo),
                                                       port_cfg(X64))
    assert port.long is not None and {-1, 0} <= set(port.dia_offs)
    assert port.dia_vals.dtype == torch.float64
    _assert_same_state(ref, port, {"val1": "val1_lo", "dia_vals": "dia_lo"})
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, coo.n_col)
    p = port          # the main state; its nested one rides the spmv below
    xt = xch.x_table(p, torch.from_numpy(x))
    xh, xl = (a.reshape(xt.shape) for a in _split(xt))
    mul_df = jax.jit(lambda *a: xch_mul_df(*a, p.m1, p.t1))
    for c in range(len(p.win1)):
        ph, pl_ = mul_df(*(getattr(ref, f)[c] for f in (
            "win1", "lane1", "sub1", "val1", "val1_lo")), xh, xl)
        got = xch_ops.xch_mul(*(getattr(p, f)[c] for f in (
            "win1", "lane1", "sub1", "val1")), xt, p.m1, p.t1)
        _close(got, _np(ph).astype(np.float64)
               + _np(pl_).astype(np.float64))
    prod = rng.uniform(-1, 1, (p.n_chunks, p.p1, 128))
    hi, lo = _split(prod)
    prod = hi.astype(np.float64) + lo.astype(np.float64)
    for c, ng in enumerate(p.chunk_ngrp):
        args = ("gids2", "off2", "cs2", "win2", "lane2", "sub2", "hm2",
                "sig2", "idx2")
        oh, ol = jax.jit(lambda *a: xch_route4_df(
            *a, ng, p.gb, p.m2, p.t2, p.p_oh))(
                *(getattr(ref, f)[c] for f in args), hi, lo)
        before = xch_ops.xch_route4.launches_f64
        got = xch_ops.xch_route4(*(getattr(p, f)[c] for f in args),
                                 torch.from_numpy(prod), ng, p.gb, p.m2,
                                 p.t2, p.p_oh)
        assert xch_ops.xch_route4.launches_f64 == before  # CPU: plain
        _close(got, _np(oh).astype(np.float64)
               + _np(ol).astype(np.float64))
    y = xch.spmv(port, torch.from_numpy(x))
    assert y.dtype == torch.float64
    assert _oracle_rel(coo, x, y) <= 1e-12
    _close(y, jax.jit(ref_xch.spmv)(ref, x))
    carried = xch.state_from_reference(_host(ref))
    assert carried.long.val1[0].dtype == torch.float64
    _close(xch.spmv(carried, torch.from_numpy(x)), y, 1e-12)


def test_f64_calls_keep_their_type():
    """A float64 call never meets a float32 table or kernel: mixed value
    types raise; the block route is float32 only."""
    coo = powerlaw(1500, 9000, seed=3)
    st = slab.convert(port_coo(coo), port_cfg(F64))
    xt = slab.x_table(st, torch.zeros(coo.n_col, dtype=torch.float64))
    args = [getattr(st, f)[0] for f in ("uids", "sg0", "sg1", "win", "lane",
                                        "sub", "val", "hm1", "idx")]
    with pytest.raises(TypeError, match="float32"):
        slab_ops.slab_spmv(*args, xt.float(), st.chunk_nu[0], st.m,
                           st.t_step)
    with pytest.raises(TypeError):
        slab.spmv(st, torch.zeros(coo.n_col, dtype=torch.float32))
    h = args[4].shape[0]
    with pytest.raises(TypeError):
        slab_ops.slab_spmv_blk(args[0], *args[3:7], args[7],
                               torch.full((1, h, 128), -1, dtype=torch.int8),
                               torch.zeros(h, 128, dtype=torch.int8), xt, 1,
                               st.m, 8, st.t_step)
    with pytest.raises(ValueError, match="unit route only"):
        slab.convert(port_coo(coo), port_cfg(F64),
                     plan=dict(slab._estimate_cols(
            coo.row.astype(np.int64), coo.col.astype(np.int64), coo.nnz,
            fixed={"mode": "blk", "kblk": 1, "m": 1, "t": 32, "planes": 8}),
            hub_cols=None, cols_eff=None, hub_off=0))
    xs = xch.convert(port_coo(coo), port_cfg(X64))
    with pytest.raises(TypeError):
        xch_ops.xch_mul(xs.win1[0], xs.lane1[0], xs.sub1[0], xs.val1[0],
                        torch.zeros(xs.cb_pad, 128), xs.m1, xs.t1)
    with pytest.raises(TypeError, match="float16"):
        xch_ops.xch_mul(xs.win1[0], xs.lane1[0], xs.sub1[0],
                        xs.val1[0].half(), torch.zeros(xs.cb_pad, 128).half(),
                        xs.m1, xs.t1)


def test_attainable_seconds_use_the_value_size():
    """8-byte values in the traffic terms, and no df64 multiplier."""
    coo = powerlaw(3000, 30000, seed=7)
    f32 = F64.replace(dtype="float32")
    plan = _unit_plan(slab, coo, 8, 8)
    s32 = slab.convert(port_coo(coo), port_cfg(f32), plan=plan)
    s64 = slab.convert(port_coo(coo), port_cfg(F64), plan=plan)
    extra = ((s64.cb_pad * 128 + 2 * coo.n_row) * 4
             / slab._cc.get("hbm_bps"))
    assert slab.attainable_seconds(s64, port_cfg(F64)) == pytest.approx(
        slab.attainable_seconds(s32, port_cfg(f32)) + extra, rel=1e-12)

    def extra(st):      # 4 more bytes per band value, x and y element
        more = (len(st.dia_offs) * 2 + 3) * st.n_row * 4 / xch.HBM_BPS
        return more + (extra(st.long) if st.long is not None else 0.0)

    x32, x64 = xch.convert(port_coo(coo),
                           port_cfg(f32)), xch.convert(port_coo(coo),
                                                       port_cfg(X64))
    assert xch.attainable_seconds(x64, port_cfg(X64)) == pytest.approx(
        xch.attainable_seconds(x32, port_cfg(f32)) + extra(x64), rel=1e-12)
