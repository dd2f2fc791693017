"""Port panel kernels, plain path: ``slab_spmm``, ``xch_mul_panel`` and
``xch_route4_panel`` of ``singlespmv_tpu_torch.ops`` on CPU tensors against
the Pallas panel kernels run in interpret mode, on layouts made by the
reference convert (plans forced), with panels made from a seed by numpy.
The port's panels are interleaved: it is handed the reference's tables
permuted, (B, CB, 128) → (CB, 128, B) and (B, n_chunks, P1, 128) →
(n_chunks, P1, 128, B), and its (H, 128, B) products, (n_out, 128, B) out
rows and (nu·planes, 128, B) out blocks are compared with the reference's
permuted the same way; the numbers are the same.  ``slab_spmm`` routes only the planes [sg0, sg1] of each step:
``test_unit_steps_route_nothing_outside_sg`` holds the reference's
unit-mode states to what makes that pruning exact, and to the run layout
that the CUDA panel kernels' walk takes (``csrc/panel_row.cuh``).

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
from singlespmv_tpu.data.structgen import RECIPES, _assemble
from singlespmv_tpu.formats import slab as ref_slab
from singlespmv_tpu.formats import xch as ref_xch
from singlespmv_tpu.ops.pallas.slab import slab_spmm as pallas_spmm
from singlespmv_tpu.ops.pallas.xch import xch_mul_panel as pallas_mul
from singlespmv_tpu.ops.pallas.xch import xch_route4_panel as pallas_route
from singlespmv_tpu_torch.ops import slab as sops
from singlespmv_tpu_torch.ops import xch as xops
from test_xch import _mix

RTOL = 1e-5
SLAB_NAMES = ("uids", "sg0", "sg1", "win", "lane", "sub", "val", "hm1",
              "idx")
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


def _interleaved(a):
    """The reference's per-column arrays (B, ...) as the port's interleaved
    panel (..., B)."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, 0, -1)))


def _by_column(t):
    """The port's interleaved output (..., B) as the reference's (B, ...)."""
    return np.moveaxis(t.numpy(), -1, 0)


def _close(got, want, keep=None):
    if keep is not None:
        got, want = got[keep], want[keep]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


def _slab_state(planes, m, coo=None):
    coo = powerlaw(1500, 8000, seed=2) if coo is None else coo
    plan = ref_slab._estimate_cols(
        coo.row.astype(np.int64), coo.col.astype(np.int64), coo.nnz,
        fixed={"mode": "unit", "kblk": 1, "m": m, "t": 32, "planes": planes})
    assert plan["feasible"]
    plan.update(hub_cols=None, cols_eff=None, hub_off=0)
    st = ref_slab.convert(coo, Config(format="slab"), plan=plan)
    assert (st.mode, st.planes, st.m, len(st.uids)) == ("unit", planes, m, 1)
    return st


def _stand_in(name, n):
    """The reference's structgen recipe of ``name`` at n rows and its
    published nnz per row."""
    n_pub, nnz_pub, build = RECIPES[name]
    nnz = n * nnz_pub // n_pub
    rng = np.random.default_rng(7)
    return _assemble(rng, n, n, nnz, build(rng, n, nnz))


PRUNE_MATS = [
    ("powerlaw", lambda: powerlaw(1500, 8000, seed=2)),
    ("g7jac200sc", lambda: _stand_in("g7jac200sc", 3000)),
    ("lhr34", lambda: _stand_in("lhr34", 2000)),
]


@pytest.mark.parametrize("planes,m,n_cols,mat", [
    (8, 1, 2, 0), (8, 8, 5, 0), (16, 1, 5, 0), (16, 8, 2, 0),
    (8, 4, 3, 1), (16, 4, 2, 2)])
def test_slab_spmm_matches_pallas(planes, m, n_cols, mat):
    """The pruned plain version against the TPU's panel, which routes every
    plane."""
    st = _slab_state(planes, m, PRUNE_MATS[mat][1]())
    arrs, tens = _args(st, SLAB_NAMES)
    xp = _panel((n_cols, st.cb_pad, 128), seed=planes + m)
    nu = st.chunk_nu[0]
    no_sg = [a for n, a in zip(SLAB_NAMES, arrs) if n not in ("sg0", "sg1")]
    want = np.asarray(pallas_spmm(*no_sg, xp, nu, st.m, st.t_step))
    before = sops.slab_spmm.launches
    got = sops.slab_spmm(*tens, _interleaved(xp), nu, st.m, st.t_step)
    assert sops.slab_spmm.launches == before       # CPU: plain version
    assert want.shape == (nu * n_cols * planes, 128)
    assert got.shape == (nu * planes, 128, n_cols)
    want = np.moveaxis(want.reshape(nu, n_cols, planes, 128), 1, -1)
    keep = np.asarray(st.lo_mask)[:, 0] > 0        # the owned unit blocks
    assert keep.any()
    _close(got.numpy().reshape(want.shape), want, keep)


def _assert_walkable(hm1, idx):
    """What the CUDA panel kernels' walk takes of a stream: a row routes
    each end lane e at most once, and the last run head at or before e
    (a slot l with hm1 = l − 1) is hm1[e] + 1, so that the run sum it keeps
    is W[e] = P[e] − P[hm1[e]]."""
    hm1 = np.asarray(hm1).astype(np.int64)
    lanes = np.arange(128)
    last = np.maximum.accumulate(np.where(hm1 == lanes - 1, lanes, -1), 1)
    _, rows, _ = np.nonzero(np.asarray(idx) >= 0)
    ends = np.asarray(idx)[np.asarray(idx) >= 0].astype(np.int64)
    np.testing.assert_array_equal(last[rows, ends], hm1[rows, ends] + 1)
    key = rows * 128 + ends
    assert len(np.unique(key)) == len(key), "an end lane routed twice"


@pytest.mark.parametrize("planes,m", [(8, 1), (8, 4), (16, 1), (16, 4)])
@pytest.mark.parametrize("label,make", PRUNE_MATS,
                         ids=[m[0] for m in PRUNE_MATS])
def test_unit_steps_route_nothing_outside_sg(label, make, planes, m):
    """Every idx entry of a plane outside [sg0[t], sg1[t]] is −1 in each
    step t of the reference's unit-mode states, so routing only those
    planes (``slab_spmm``) is exact."""
    st = _slab_state(planes, m, make())
    t = st.t_step
    for s0, s1, hm1, idx in zip(st.sg0, st.sg1, st.hm1, st.idx):
        idx = np.asarray(idx)
        step = np.arange(idx.shape[1]) // t
        s = np.arange(planes)[:, None]
        outside = (s < np.asarray(s0)[step]) | (s > np.asarray(s1)[step])
        assert outside.any() or planes == 8
        assert (idx[outside] < 0).all()
        assert (idx >= 0).any()
        _assert_walkable(hm1, idx)


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
    got = xops.xch_mul_panel(*tens, _interleaved(xp), st.m1, st.t1)
    assert xops.xch_mul_panel.launches == before
    assert got.shape == (st.n_slots1 // 128, 128, n_cols)
    np.testing.assert_array_equal(_by_column(got), want)


@pytest.mark.parametrize("m,kblk,p_oh,n_cols", XCH_CASES)
def test_xch_route4_panel_matches_pallas(m, kblk, p_oh, n_cols):
    st = _xch_state(m, kblk, p_oh)
    arrs, tens = _args(st, ROUTE_NAMES)
    prod = _panel((n_cols, st.n_chunks, st.p1, 128), seed=kblk)
    g = (st.chunk_ngrp[0], st.gb, st.m2, st.t2, st.p_oh)
    want = np.asarray(pallas_route(*arrs, prod, *g))
    before = xops.xch_route4_panel.launches
    got = xops.xch_route4_panel(*tens, _interleaved(prod), *g)
    assert xops.xch_route4_panel.launches == before
    assert got.shape == (g[0] * st.gb, 128, n_cols)
    _close(_by_column(got), want)
    _assert_walkable(arrs[6], arrs[8])          # hm2, idx2


def test_panel_plain_versions_are_what_cpu_wrappers_run():
    """On the CPU each wrapper is its plain version, and a panel of one
    column is the single-column plain version."""
    st = _slab_state(16, 1)
    _, tens = _args(st, SLAB_NAMES)
    xp = _interleaved(_panel((3, st.cb_pad, 128), 4))
    a = (xp, st.chunk_nu[0], st.m, st.t_step)
    assert torch.equal(sops.slab_spmm(*tens, *a), sops.slab_spmm_ref(*tens, *a))
    one = sops.slab_spmm_ref(*tens, xp[..., 1:2], *a[1:])
    assert torch.equal(one[..., 0],
                       sops.slab_spmv_ref(*tens, xp[..., 1], *a[1:]))

    xs = _xch_state(8, 4, 16, seed=3)
    _, mt = _args(xs, MUL_NAMES)
    xt = _interleaved(_panel((3, xs.cb_pad, 128), 5))
    prods = xops.xch_mul_panel(*mt, xt, xs.m1, xs.t1)
    assert torch.equal(prods, xops.xch_mul_panel_ref(*mt, xt, xs.m1, xs.t1))
    assert torch.equal(prods[..., 1],
                       xops.xch_mul_ref(*mt, xt[..., 1], xs.m1, xs.t1))
    _, rt = _args(xs, ROUTE_NAMES)
    p4 = _interleaved(_panel((3, xs.n_chunks, xs.p1, 128), 6))
    g = (xs.chunk_ngrp[0], xs.gb, xs.m2, xs.t2, xs.p_oh)
    got = xops.xch_route4_panel(*rt, p4, *g)
    assert torch.equal(got, xops.xch_route4_panel_ref(*rt, p4, *g))
    assert torch.equal(got[..., 2], xops.xch_route4_ref(*rt, p4[..., 2], *g))


def test_panel_wrappers_check_layout():
    st = _slab_state(8, 1)
    _, tens = _args(st, SLAB_NAMES)
    xp = _interleaved(_panel((2, st.cb_pad, 128), 1))
    nu, m, t = st.chunk_nu[0], st.m, st.t_step
    with pytest.raises(TypeError):                  # no float64 panel
        sops.slab_spmm(*tens[:6], tens[6].double(), *tens[7:], xp.double(),
                       nu, m, t)
    with pytest.raises(ValueError):                 # a table, not a panel
        sops.slab_spmm(*tens, xp[..., 0], nu, m, t)
    with pytest.raises(ValueError):                 # no column
        sops.slab_spmm(*tens, xp[..., :0], nu, m, t)
    with pytest.raises(ValueError):                 # H not a multiple of T
        sops.slab_spmm(*tens, xp, nu, m, t + 1)
    with pytest.raises(ValueError, match="cuda"):
        sops.slab_spmm(*[a.to("meta") for a in tens], xp.to("meta"), nu, m,
                       t)

    xs = _xch_state(1, 1, 8)
    _, mt = _args(xs, MUL_NAMES)
    xt = _interleaved(_panel((2, xs.cb_pad, 128), 2))
    with pytest.raises(ValueError):
        xops.xch_mul_panel(*mt, xt.transpose(0, 1), xs.m1, xs.t1)
    with pytest.raises(TypeError):
        xops.xch_mul_panel(*mt[:3], mt[3].double(), xt.double(), xs.m1,
                           xs.t1)
    _, rt = _args(xs, ROUTE_NAMES)
    p4 = _interleaved(_panel((2, xs.n_chunks, xs.p1, 128), 3))
    g = (xs.chunk_ngrp[0], xs.gb, xs.m2, xs.t2)
    with pytest.raises(ValueError):                 # a product grid, not a panel
        xops.xch_route4_panel(*rt, p4[..., 0], *g, xs.p_oh)
    with pytest.raises(ValueError):                 # p_oh past 64
        xops.xch_route4_panel(*rt, p4, *g, 72)
