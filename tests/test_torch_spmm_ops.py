"""Port panel kernels, plain path: ``slab_spmm``, ``xch_mul_panel`` and
``xch_route4_panel`` of ``singlespmv_tpu_torch.ops`` on CPU tensors against
the Pallas panel kernels run in interpret mode, on layouts made by the
reference convert (plans forced), with panels made from a seed by numpy.

The plain versions take the row prefix with ``torch.cumsum`` and route by
``index_add_`` where the TPU kernels use triangle and one-hot matmuls, so
sums round in another order: outputs agree to rtol 1e-5 with atol
1e-5·max|out|; the pass-1 products are one product per slot and agree
exactly.  Slab out blocks that no grid step owns (``lo_mask`` 0) are
unwritten on the TPU and are not compared.  The shapes are small (T 32) to
keep the interpret-mode traces short.
"""
import numpy as np
import pytest
import torch

from singlespmv_tpu.config import Config
from singlespmv_tpu.data.generators import powerlaw
from singlespmv_tpu.formats import slab as ref_slab
from singlespmv_tpu.formats import xch as ref_xch
from singlespmv_tpu.ops.pallas.slab import slab_spmm as pallas_spmm
from singlespmv_tpu.ops.pallas.xch import xch_mul_panel as pallas_mul
from singlespmv_tpu.ops.pallas.xch import xch_route4_panel as pallas_route
from singlespmv_tpu_torch.ops import slab as sops
from singlespmv_tpu_torch.ops import xch as xops
from test_xch import _mix

RTOL = 1e-5
SLAB_NAMES = ("uids", "win", "lane", "sub", "val", "hm1", "idx")
MUL_NAMES = ("win1", "lane1", "sub1", "val1")
ROUTE_NAMES = ("gids2", "off2", "cs2", "win2", "lane2", "sub2", "hm2", "sig2",
               "idx2")


def _args(st, names, c=0):
    """Call ``c`` of the reference state's streams: numpy arrays for
    Pallas, torch tensors for the port."""
    arrs = [np.asarray(getattr(st, n)[c]) for n in names]
    return arrs, [torch.from_numpy(np.array(a)) for a in arrs]


def _panel(shape, seed):
    return np.random.default_rng(seed).uniform(-1.0, 1.0, shape).astype(
        np.float32)


def _close(got, want, keep=None):
    if keep is not None:
        got, want = got[keep], want[keep]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


def _slab_state(planes, m):
    coo = powerlaw(1500, 8000, seed=2)
    plan = ref_slab._estimate_cols(
        coo.row.astype(np.int64), coo.col.astype(np.int64), coo.nnz,
        fixed={"mode": "unit", "kblk": 1, "m": m, "t": 32, "planes": planes})
    assert plan["feasible"]
    plan.update(hub_cols=None, cols_eff=None, hub_off=0)
    st = ref_slab.convert(coo, Config(format="slab"), plan=plan)
    assert (st.mode, st.planes, st.m, len(st.uids)) == ("unit", planes, m, 1)
    return st


@pytest.mark.parametrize("planes,m,n_cols", [(8, 1, 2), (8, 8, 5),
                                             (16, 1, 5), (16, 8, 2)])
def test_slab_spmm_matches_pallas(planes, m, n_cols):
    st = _slab_state(planes, m)
    arrs, tens = _args(st, SLAB_NAMES)
    xp = _panel((n_cols, st.cb_pad, 128), seed=planes + m)
    nu = st.chunk_nu[0]
    want = np.asarray(pallas_spmm(*arrs, xp, nu, st.m, st.t_step))
    before = sops.slab_spmm.launches
    got = sops.slab_spmm(*tens, torch.from_numpy(xp), nu, st.m, st.t_step)
    assert sops.slab_spmm.launches == before       # CPU: plain version
    assert got.shape == want.shape == (nu * n_cols * planes, 128)
    keep = np.repeat(np.asarray(st.lo_mask)[:, 0] > 0, n_cols * planes)
    assert keep.any()
    _close(got.numpy(), want, keep)


def _xch_state(m, kblk, p_oh, seed=0):
    plan = ref_xch.estimate(_mix(3000, 15000, seed), Config(format="xch"))
    plan.update(m1_fix=m, t1_fix=32, m2_fix=m, t2_fix=32, kblk=kblk,
                kblk_fix=True, p_oh_fix=p_oh)
    st = ref_xch.convert(_mix(3000, 15000, seed), Config(format="xch"),
                         plan=plan)
    assert (st.m1, st.m2, st.kblk, st.p_oh) == (m, m, kblk, p_oh)
    return st


XCH_CASES = [(1, 1, 8, 2), (8, 4, 16, 5)]    # m, kblk, p_oh, B


@pytest.mark.parametrize("m,kblk,p_oh,n_cols", XCH_CASES)
def test_xch_mul_panel_matches_pallas(m, kblk, p_oh, n_cols):
    st = _xch_state(m, kblk, p_oh)
    arrs, tens = _args(st, MUL_NAMES)
    xp = _panel((n_cols, st.cb_pad, 128), seed=m)
    want = np.asarray(pallas_mul(*arrs, xp, st.m1, st.t1))
    before = xops.xch_mul_panel.launches
    got = xops.xch_mul_panel(*tens, torch.from_numpy(xp), st.m1, st.t1)
    assert xops.xch_mul_panel.launches == before
    assert got.shape == (n_cols, st.n_slots1 // 128, 128)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("m,kblk,p_oh,n_cols", XCH_CASES)
def test_xch_route4_panel_matches_pallas(m, kblk, p_oh, n_cols):
    st = _xch_state(m, kblk, p_oh)
    arrs, tens = _args(st, ROUTE_NAMES)
    prod = _panel((n_cols, st.n_chunks, st.p1, 128), seed=kblk)
    g = (st.chunk_ngrp[0], st.gb, st.m2, st.t2, st.p_oh)
    want = np.asarray(pallas_route(*arrs, prod, *g))
    before = xops.xch_route4_panel.launches
    got = xops.xch_route4_panel(*tens, torch.from_numpy(prod), *g)
    assert xops.xch_route4_panel.launches == before
    assert got.shape == (n_cols, g[0] * st.gb, 128)
    _close(got.numpy(), want)


def test_panel_plain_versions_are_what_cpu_wrappers_run():
    """On the CPU each wrapper is its plain version, and a panel of one
    column is the single-column plain version."""
    st = _slab_state(16, 1)
    _, tens = _args(st, SLAB_NAMES)
    xp = torch.from_numpy(_panel((3, st.cb_pad, 128), 4))
    a = (xp, st.chunk_nu[0], st.m, st.t_step)
    assert torch.equal(sops.slab_spmm(*tens, *a), sops.slab_spmm_ref(*tens, *a))
    one = sops.slab_spmm_ref(*tens, xp[1:2], *a[1:])
    _, t9 = _args(st, ("uids", "sg0", "sg1") + SLAB_NAMES[1:])
    assert torch.equal(one, sops.slab_spmv_ref(*t9, xp[1], *a[1:]))

    xs = _xch_state(8, 4, 16, seed=3)
    _, mt = _args(xs, MUL_NAMES)
    xt = torch.from_numpy(_panel((3, xs.cb_pad, 128), 5))
    assert torch.equal(xops.xch_mul_panel(*mt, xt, xs.m1, xs.t1),
                       xops.xch_mul_panel_ref(*mt, xt, xs.m1, xs.t1))
    _, rt = _args(xs, ROUTE_NAMES)
    p4 = torch.from_numpy(_panel((3, xs.n_chunks, xs.p1, 128), 6))
    g = (xs.chunk_ngrp[0], xs.gb, xs.m2, xs.t2, xs.p_oh)
    got = xops.xch_route4_panel(*rt, p4, *g)
    assert torch.equal(got, xops.xch_route4_panel_ref(*rt, p4, *g))
    assert torch.equal(got[2], xops.xch_route4_ref(*rt, p4[2], *g))


def test_panel_wrappers_check_layout():
    st = _slab_state(8, 1)
    _, tens = _args(st, SLAB_NAMES)
    xp = torch.from_numpy(_panel((2, st.cb_pad, 128), 1))
    nu, m, t = st.chunk_nu[0], st.m, st.t_step
    with pytest.raises(TypeError):                  # the panel is float32
        sops.slab_spmm(*tens[:4], tens[4].double(), *tens[5:], xp.double(),
                       nu, m, t)
    with pytest.raises(ValueError):                 # a table, not a panel
        sops.slab_spmm(*tens, xp[0], nu, m, t)
    with pytest.raises(ValueError):                 # no column
        sops.slab_spmm(*tens, xp[:0], nu, m, t)
    with pytest.raises(ValueError):                 # H not a multiple of T
        sops.slab_spmm(*tens, xp, nu, m, t + 1)
    with pytest.raises(ValueError, match="cuda"):
        sops.slab_spmm(*[a.to("meta") for a in tens], xp.to("meta"), nu, m,
                       t)

    xs = _xch_state(1, 1, 8)
    _, mt = _args(xs, MUL_NAMES)
    xt = torch.from_numpy(_panel((2, xs.cb_pad, 128), 2))
    with pytest.raises(ValueError):
        xops.xch_mul_panel(*mt, xt.transpose(0, 1), xs.m1, xs.t1)
    with pytest.raises(TypeError):
        xops.xch_mul_panel(*mt[:3], mt[3].double(), xt.double(), xs.m1,
                           xs.t1)
    _, rt = _args(xs, ROUTE_NAMES)
    p4 = torch.from_numpy(_panel((2, xs.n_chunks, xs.p1, 128), 3))
    g = (xs.chunk_ngrp[0], xs.gb, xs.m2, xs.t2)
    with pytest.raises(ValueError):                 # a product grid, not a panel
        xops.xch_route4_panel(*rt, p4[0], *g, xs.p_oh)
    with pytest.raises(ValueError):                 # p_oh past 64
        xops.xch_route4_panel(*rt, p4, *g, 72)
