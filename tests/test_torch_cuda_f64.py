"""Port CUDA kernels at float64 on the card: the native-fp64 builds of the
slab unit kernel and of the xch kernels (``xch_mul``, the spmv route
``xch_route4_rows`` and the first port's ``xch_route4``) against their plain
versions, the first port's route at p_oh 64 (its dynamic shared memory), and
the slab, xch, dia
and hyb spmv against the float64 oracle; the float32 builds of the templated
kernels against their plain versions beside them.

Needs an NVIDIA GPU and skips without one.  This file imports no jax, so it
runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_f64.py

At float64 a kernel and its plain version agree to 1e-12·max|out|, and an
spmv to the oracle to 1e-12·max|y|: an f32 computation would reach ~1e-7
and pass the oracle's own 1e-6 bound, so the bound shows the path is fp64.
At float32 the bound is 1e-5·max|out| (sums in run-dependent order).
"""
import numpy as np
import pytest
import torch

from singlespmv_tpu_torch import Config
from singlespmv_tpu_torch.core import COOMatrix, reference_spmv
from singlespmv_tpu_torch.data import powerlaw
from singlespmv_tpu_torch.formats import dia, hyb, slab, xch
from singlespmv_tpu_torch.ops import slab as slab_ops
from singlespmv_tpu_torch.ops import xch as xch_ops

pytestmark = pytest.mark.cuda

F64 = Config(format="slab", dtype="float64")
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _close(got, want):
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.is_cuda
    assert got.dtype == want.dtype
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= TOL[want.dtype] * scale


def _counts(wrapper):
    return wrapper.launches, wrapper.launches_f64


def _launched(wrapper, before, vt):
    f32, f64 = before
    want = (f32, f64 + 1) if vt == torch.float64 else (f32 + 1, f64)
    assert _counts(wrapper) == want


def _oracle_rel(coo, x, y):
    ref = reference_spmv(coo, x)
    return np.abs(y - ref).max() / max(np.abs(ref).max(), 1e-300)


def _x(coo, seed=3):
    return np.random.default_rng(seed).uniform(-1, 1, coo.n_col)


def _scatter(n, nnz, seed, long_rows=0):
    """Diagonal, local and scattered entries, plus ``long_rows`` rows of
    degree ~2000 that the xch planner splits into a nested state."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, nnz)
    c = np.where(rng.random(nnz) < 0.4,
                 np.clip(r + rng.integers(-50, 50, nnz), 0, n - 1),
                 rng.integers(0, n, nnz))
    rows = np.concatenate([np.arange(n), r,
                           np.repeat(rng.choice(n, long_rows, replace=False),
                                     2000)])
    cols = np.concatenate([np.arange(n), c,
                           rng.integers(0, n, 2000 * long_rows)])
    return COOMatrix.from_triplets(n, n, rows, cols,
                                   rng.uniform(-1.0, 2.0, len(rows)),
                                   sort=True, sum_duplicates=True)


def _slab_state(coo, cfg, planes, m, mode="unit", t=32):
    plan = slab._estimate_cols(coo.row.astype(np.int64),
                               coo.col.astype(np.int64), coo.nnz,
                               fixed={"mode": mode, "kblk": 1, "m": m,
                                      "t": t, "planes": planes})
    assert plan["feasible"]
    plan.update(hub_cols=None, cols_eff=None, hub_off=0)
    return slab.convert(coo, cfg, plan=plan)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("planes,m", [(8, 1), (8, 8), (16, 1), (16, 8)])
def test_slab_unit_kernel(cuda, dtype, planes, m):
    coo = powerlaw(6000, 60000, seed=2)
    st = _slab_state(coo, F64.replace(dtype=dtype), planes, m).to(cuda)
    vt = st.val[0].dtype
    xt = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, (st.cb_pad, 128))).to(cuda, vt)
    for a in zip(st.uids, st.sg0, st.sg1, st.win, st.lane, st.sub, st.val,
                 st.hm1, st.idx, st.chunk_nu):
        before = _counts(slab_ops.slab_spmv)
        got = slab_ops.slab_spmv(*a[:-1], xt, a[-1], st.m, st.t_step)
        _launched(slab_ops.slab_spmv, before, vt)
        _close(got, slab_ops.slab_spmv_ref(*a[:-1], xt, a[-1], st.m,
                                            st.t_step))
    if vt == torch.float64:
        x = _x(coo)
        y = slab.spmv(st, torch.from_numpy(x).to(cuda)).cpu().numpy()
        assert y.dtype == np.float64 and _oracle_rel(coo, x, y) <= 1e-12


def _xch_kernels_vs_plain(st, xd):
    """Every call of both xch kernels of the state and its nested state."""
    xt = xch.x_table(st, xd)
    vt = xt.dtype
    for a in zip(st.win1, st.lane1, st.sub1, st.val1):
        before = _counts(xch_ops.xch_mul)
        got = xch_ops.xch_mul(*a, xt, st.m1, st.t1)
        _launched(xch_ops.xch_mul, before, vt)
        _close(got, xch_ops.xch_mul_ref(*a, xt, st.m1, st.t1))
    prod3 = xch.products(st, xt)
    for *a, ng in zip(st.gids2, st.off2, st.cs2, st.win2, st.lane2, st.sub2,
                      st.hm2, st.sig2, st.idx2, st.chunk_ngrp):
        g = (prod3, ng, st.gb, st.m2, st.t2, st.p_oh)
        before = _counts(xch_ops.xch_route4)
        got = xch_ops.xch_route4(*a, *g)
        _launched(xch_ops.xch_route4, before, vt)
        _close(got, xch_ops.xch_route4_ref(*a, *g))
    for a in zip(st.base2, st.cs2, st.win2, st.lane2, st.sub2, st.hm2,
                 st.dest2):
        y = lambda: torch.zeros(st.n_row, dtype=vt, device=xd.device)
        before = _counts(xch_ops.xch_route4_rows)
        got = xch_ops.xch_route4_rows(*a, prod3, y(), st.m2, st.t2,
                                      st.merge2)
        _launched(xch_ops.xch_route4_rows, before, vt)
        _close(got, xch_ops.xch_route4_rows_ref(*a, prod3, y(), st.m2,
                                                st.t2))
    if st.long is not None:
        _xch_kernels_vs_plain(st.long, xd)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("kblk,m2,t2,p_oh", [(8, 8, 64, 16),
                                             (32, 8, 256, 64)])
def test_xch_kernels(cuda, dtype, kblk, m2, t2, p_oh):
    cfg = F64.replace(format="xch", dtype=dtype)
    coo = _scatter(40000, 200000, seed=kblk)
    plan = xch.estimate(coo, cfg) | dict(kblk=kblk, kblk_fix=True,
                                         m2_fix=m2, t2_fix=t2,
                                         p_oh_fix=p_oh)
    st = xch.convert(coo, cfg, plan=plan).to(cuda)
    assert (st.kblk, st.m2, st.t2, st.p_oh) == (kblk, m2, t2, p_oh)
    x = _x(coo)
    xd = torch.from_numpy(x).to(cuda, st.val1[0].dtype)
    _xch_kernels_vs_plain(st, xd)
    if dtype == "float64":
        y = xch.spmv(st, xd).cpu().numpy()
        assert _oracle_rel(coo, x, y) <= 1e-12


def test_xch_f64_merge_kernel(cuda):
    """The float64 merge kernel (64 KB of spans at p_oh 8) on the nested
    state of 128 rows of degree 2,000, against its plain version and the
    oracle."""
    cfg = F64.replace(format="xch")
    rng = np.random.default_rng(12)
    n = 40000
    rows = np.concatenate([rng.integers(0, n, 120000),
                           np.repeat(rng.choice(n, 128, replace=False), 2000)])
    coo = COOMatrix.from_triplets(n, n, rows, rng.integers(0, n, len(rows)),
                                  rng.uniform(0.1, 1.0, len(rows)),
                                  sort=True, sum_duplicates=True)
    st = xch.convert(coo, cfg)
    assert st.long.merge2 == st.long.p_oh * 128
    st = st.to(cuda)
    x = _x(coo)
    xd = torch.from_numpy(x).to(cuda)
    _xch_kernels_vs_plain(st, xd)
    assert _oracle_rel(coo, x, xch.spmv(st, xd).cpu().numpy()) <= 1e-12


def test_xch_f64_peel_and_nested_state(cuda):
    cfg = F64.replace(format="xch")
    coo = _scatter(20000, 60000, seed=11, long_rows=8)
    st = xch.convert(coo, cfg)
    assert st.long is not None and st.dia_vals is not None
    assert st.dia_vals.dtype == torch.float64
    st = st.to(cuda)
    x = _x(coo)
    xd = torch.from_numpy(x).to(cuda)
    _xch_kernels_vs_plain(st, xd)
    assert _oracle_rel(coo, x, xch.spmv(st, xd).cpu().numpy()) <= 1e-12


def _band_scatter(n, seed):
    """Three full diagonals (offsets −1, 0, 3), alone and with 3n scattered
    entries."""
    rng = np.random.default_rng(seed)
    d = np.arange(n)
    rows = np.concatenate([d, d[1:], d[:-3], rng.integers(0, n, 3 * n)])
    cols = np.concatenate([d, d[1:] - 1, d[:-3] + 3,
                           rng.integers(0, n, 3 * n)])
    vals = rng.uniform(-1, 2, len(rows))
    nb = 3 * n - 4
    return (COOMatrix.from_triplets(n, n, rows[:nb], cols[:nb], vals[:nb],
                                    sort=True),
            COOMatrix.from_triplets(n, n, rows, cols, vals, sort=True,
                                    sum_duplicates=True))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_dia_and_hyb_spmv(cuda, dtype):
    band, mixed = _band_scatter(30000, seed=4)
    x = _x(mixed)
    for fmt, coo in ((dia, band), (hyb, mixed)):
        st = fmt.convert(coo, F64.replace(dtype=dtype))
        if fmt is hyb:
            # float32 residuals may ride the bucket engine (bkt_g here),
            # float64 ones slab or xch
            assert st.rest_fmt in (("slab", "xch") if dtype == "float64"
                                   else hyb.REST_MODULES)
            assert st.dia_state.n_diag == 3
        st = st.to(cuda)
        xd = torch.from_numpy(x).to(cuda, getattr(torch, dtype))
        y = fmt.spmv(st, xd)
        assert y.is_cuda and y.dtype == xd.dtype
        assert _oracle_rel(coo, x, y.cpu().numpy()) <= TOL[xd.dtype]


def test_no_silent_downgrade(cuda):
    coo = powerlaw(3000, 30000, seed=5)
    st = _slab_state(coo, F64, 8, 1).to(cuda)
    a = (st.uids[0], st.sg0[0], st.sg1[0], st.win[0], st.lane[0], st.sub[0],
         st.val[0], st.hm1[0], st.idx[0])
    xt32 = torch.zeros(st.cb_pad, 128, device=cuda)
    with pytest.raises(TypeError):
        slab_ops.slab_spmv(*a, xt32, st.chunk_nu[0], st.m, st.t_step)
    with pytest.raises(TypeError):
        slab.spmv(st, torch.zeros(coo.n_col, device=cuda))
    blk = _slab_state(coo, F64.replace(dtype="float32"), 8, 1,
                      mode="blk").to(cuda)
    with pytest.raises(TypeError):
        slab_ops.slab_spmv_blk(
            blk.uids[0], blk.win[0], blk.lane[0], blk.sub[0],
            blk.val[0].double(), blk.hm1[0], blk.idx[0], blk.sig[0],
            torch.zeros(blk.cb_pad, 128, device=cuda, dtype=torch.float64),
            blk.chunk_nu[0], blk.m, blk.planes, blk.t_step)
