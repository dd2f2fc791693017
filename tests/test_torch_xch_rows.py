"""Port xch spmv route, plain path: ``route_rows`` derives the run-end
destination stream (``base2``, ``dest2``) from the reference's routing
arrays, and ``xch_route4_rows_ref`` on it adds into y what the Pallas
``xch_route4`` (interpret mode) and ``xch_route4_ref`` return, once their
out groups are placed into y at ``vis_gids``; on layouts made by the
reference convert, plans forced through its ``*_fix`` keys.

The three sum a y position's run totals in different orders (one-hot
matmuls, ``index_add_`` per plane, ``index_add_`` per run), so float32
agrees to rtol 1e-5 with atol 1e-5·max|y|.  At float64 the reference runs
its df64 route, ~48 bits: 1e-11·max|y|.  The reference's float64 convert
turns ``jax_enable_x64`` on for good; every test here puts the flag back.
"""
import contextlib
import dataclasses

import jax
import numpy as np
import pytest
import torch

from singlespmv_tpu.config import Config
from singlespmv_tpu.core import verify_result
from singlespmv_tpu.core.types import COOMatrix
from singlespmv_tpu.formats import xch as ref_xch
from singlespmv_tpu.ops.pallas.xch import xch_route4 as pallas_route4
from singlespmv_tpu.ops.pallas.xch import xch_route4_df as pallas_route4_df
from singlespmv_tpu_torch.formats import xch
from singlespmv_tpu_torch.ops import xch as ops
from test_torch_xch_ops import ROUTES, _ref_state, _uniform, long_rows_matrix
from test_xch import _mix
from torch_parity import port_cfg, port_coo

F32 = Config(format="xch", dtype="float32")
X64 = F32.replace(dtype="float64")
TOL = {np.float32: 1e-5, np.float64: 1e-11}
ROUTE_ARGS = ("gids2", "off2", "cs2", "win2", "lane2", "sub2", "hm2", "sig2",
              "idx2")


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


def _host(st):
    """A reference state's fields on the host, recursively, as
    ``state_from_reference`` takes them."""
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


def _n_out_rows(st):
    return -(-(-(-st.n_row // 128)) // st.gb) * st.gb


def _placed(st, outs):
    """y from per-call out groups, as the spmv placed them before: group g
    of call c lands at vis_gids[sum(chunk_ngrp[:c]) + g]; rows past n_row
    are cut."""
    yg = np.zeros((_n_out_rows(st) // st.gb, st.gb * 128), outs[0].dtype)
    vis = np.asarray(st.vis_gids)
    g0 = 0
    for out, ng in zip(outs, st.chunk_ngrp):
        yg[vis[g0:g0 + ng]] = np.asarray(out).reshape(ng, st.gb * 128)
        g0 += ng
    return yg.reshape(-1)[:st.n_row]


def _pallas_y(ref, prod):
    """The reference's Pallas route (df64 at float64), placed into y."""
    outs = []
    for c, ng in enumerate(ref.chunk_ngrp):
        a = [getattr(ref, f)[c] for f in ROUTE_ARGS]
        if prod.dtype == np.float64:
            hi = prod.astype(np.float32)
            lo = (prod - hi.astype(np.float64)).astype(np.float32)
            oh, ol = pallas_route4_df(*a, hi, lo, ng, ref.gb, ref.m2, ref.t2,
                                      ref.p_oh)
            outs.append(np.asarray(oh).astype(np.float64)
                        + np.asarray(ol).astype(np.float64))
        else:
            outs.append(np.asarray(pallas_route4(
                *a, prod, ng, ref.gb, ref.m2, ref.m2, ref.t2, ref.p_oh)))
    return _placed(ref, outs)


def _bridge_y(port, prod):
    """``xch_route4_ref`` on the idx planes, placed into y."""
    p3 = torch.from_numpy(prod)
    return _placed(port, [
        ops.xch_route4_ref(*a, p3, ng, port.gb, port.m2, port.t2,
                           port.p_oh).numpy()
        for *a, ng in zip(*(getattr(port, f) for f in ROUTE_ARGS),
                          port.chunk_ngrp)])


def _rows_y(port, prod):
    """``xch_route4_rows_ref`` of every call on the state's stream, adding
    into one zeroed y."""
    p3 = torch.from_numpy(prod)
    y = torch.zeros(port.n_row, dtype=p3.dtype)
    for b, c, w, la, su, h2, d in zip(port.base2, port.cs2, port.win2,
                                      port.lane2, port.sub2, port.hm2,
                                      port.dest2):
        ops.xch_route4_rows_ref(b, c, w, la, su, h2, d, p3, y, port.m2,
                                port.t2)
    return y.numpy()


def _close(got, want):
    tol = TOL[want.dtype.type]
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())


def _check_three(ref, seed, dtype=np.float32):
    """The Pallas route, the bridge and the rows route agree on random
    products; the port's state comes from the reference's arrays."""
    port = xch.state_from_reference(_host(ref))
    rng = np.random.default_rng(seed)
    prod = rng.uniform(-1, 1, (ref.n_chunks, ref.p1, 128)).astype(dtype)
    want = _pallas_y(ref, prod)
    _close(_bridge_y(port, prod), want)
    got = _rows_y(port, prod)
    _close(got, want)
    assert np.abs(want).max() > 0
    return port


@pytest.mark.parametrize("m2,kblk,t2,p_oh", ROUTES)
def test_rows_route_matches_pallas(m2, kblk, t2, p_oh):
    ref = _ref_state(_mix(5000, 25000, 0), m2_fix=m2, t2_fix=t2, kblk=kblk,
                     kblk_fix=True, p_oh_fix=p_oh)
    assert (ref.m2, ref.kblk, ref.t2, ref.p_oh) == (m2, kblk, t2, p_oh)
    _check_three(ref, seed=kblk)


def test_rows_route_several_source_chunks():
    ref = _ref_state(_mix(5000, 25000, 0), k_slots=128 * 32, t2_fix=32,
                     kblk=4, kblk_fix=True)
    assert ref.n_chunks > 2 and len(np.unique(np.asarray(ref.cs2[0]))) > 2
    _check_three(ref, seed=5)


def test_rows_route_several_calls(monkeypatch):
    monkeypatch.setattr(ref_xch, "CHUNK_ROWS", 8 * 64)
    ref = ref_xch.convert(_mix(60000, 150000, 0), F32)
    assert len(ref.gids2) > 1
    port = _check_three(ref, seed=6)
    assert len(port.base2) == len(port.dest2) == len(ref.gids2)


@pytest.mark.parametrize("level", ["outer", "nested"])
def test_rows_route_long_row_state(level):
    ref = ref_xch.convert(long_rows_matrix(), F32)
    st = ref if level == "outer" else ref.long
    assert ref.long is not None and ref.long.kblk == 1
    _check_three(st, seed=8)


@pytest.mark.parametrize("fix", [dict(kblk=4, kblk_fix=True, t2_fix=32),
                                 dict(kblk=2, kblk_fix=True, m2_fix=16,
                                      t2_fix=32, p_oh_fix=8)])
def test_rows_route_float64(fix):
    coo = _mix(2000, 8000, 1)
    ref = ref_xch.convert(coo, X64, plan=ref_xch.estimate(coo, X64) | fix)
    port = _check_three(ref, seed=9, dtype=np.float64)
    assert port.val1[0].dtype == torch.float64


FIXTURES = [
    ("circuit-mix", lambda: _mix(5000, 25000, 0), {}),
    ("web-hubs", lambda: _mix(4096, 16384, 1, local_frac=0.0, hub_cols=40),
     {}),
    ("banded", lambda: _mix(2048, 14000, 4, local_frac=0.95), {}),
    ("long-rows", long_rows_matrix, {}),
    ("kblk-16", lambda: _mix(5000, 25000, 0),
     dict(m2_fix=8, t2_fix=64, kblk=16, kblk_fix=True, p_oh_fix=24)),
    ("small-chunks", lambda: _mix(5000, 25000, 0),
     dict(k_slots=128 * 32, t2_fix=32, kblk=4, kblk_fix=True)),
]


@pytest.mark.parametrize("label,make,fix", FIXTURES,
                         ids=[f[0] for f in FIXTURES])
def test_convert_and_reference_give_one_stream(label, make, fix):
    """``dest2`` and ``base2`` of the port's convert equal those that
    ``state_from_reference`` derives from the reference's arrays, nested
    states included; every routed end lane has one destination inside its
    step's p_oh rows."""
    coo = make()
    ref = ref_xch.convert(coo, F32, plan=ref_xch.estimate(coo, F32) | fix)
    port = xch.convert(port_coo(coo), port_cfg(F32),
                       plan=xch.estimate(port_coo(coo), port_cfg(F32)) | fix)
    carried = xch.state_from_reference(_host(ref))
    while port is not None:
        assert port.merge2 == carried.merge2
        for f in ("base2", "dest2"):
            for a, b in zip(getattr(port, f), getattr(carried, f)):
                assert a.dtype == b.dtype and torch.equal(a, b), f
        for d, idx, sig in zip(port.dest2, port.idx2, port.sig2):
            kept = sum(int(((idx[j] >= 0) & (sig + j < port.p_oh)).sum())
                       for j in range(idx.shape[0]))
            assert int((d >= 0).sum()) == kept
            assert int(d.max()) < port.p_oh * 128 if d.numel() else True
        port, carried = port.long, carried.long


def _small_port(**fix):
    ref = _ref_state(_mix(3000, 15000, 3), t2_fix=32, kblk=4, kblk_fix=True,
                     **fix)
    return xch.state_from_reference(_host(ref))


def test_route_rows_refuses_an_end_lane_named_twice():
    st = _small_port()
    idx = st.idx2[0].clone()
    j, r, l_ = (int(v[0]) for v in torch.nonzero(idx >= 0, as_tuple=True))
    s = int(st.sig2[0][r, 0])
    free = [(jj, ll) for jj in range(idx.shape[0])
            for ll in range(128) if idx[jj, r, ll] < 0
            and 0 <= s + jj < st.p_oh]
    jj, ll = free[0]
    idx[jj, r, ll] = idx[j, r, l_]
    with pytest.raises(ValueError, match="named twice"):
        xch.route_rows(dataclasses.replace(st, idx2=(idx,)))


def test_route_rows_refuses_a_row_outside_its_group():
    st = _small_port()
    r = int(torch.nonzero(st.idx2[0][0] >= 0, as_tuple=True)[0][0])
    off = st.off2[0].clone()
    off[r // st.t2] = st.gb - int(st.sig2[0][r, 0])    # sig + j ≥ gb − off
    with pytest.raises(ValueError, match="leaves its step's out group"):
        xch.route_rows(dataclasses.replace(st, off2=(off,)))


def test_route_rows_drops_what_the_reference_drops():
    """A group past its call's n_grp · gb rows and a group placed past
    n_row route nothing; every other run lands as before."""
    st = _small_port(gb=16, p_oh_fix=8)
    ng = st.chunk_ngrp[0]
    assert ng >= 2
    prod = _uniform((st.n_chunks, st.p1, 128), 4)
    want = _rows_y(st, prod)

    def rows_of(g):
        """The y rows of the call's compact group g."""
        v = int(st.vis_gids[g]) * st.gb * 128
        mask = np.zeros(st.n_row, bool)
        mask[v:v + st.gb * 128] = True
        return mask

    far = st.vis_gids.clone()
    far[0] = _n_out_rows(st) // st.gb
    for cut, lost in ((dict(chunk_ngrp=(ng - 1,)), rows_of(ng - 1)),
                      (dict(vis_gids=far), rows_of(0))):
        got = _rows_y(xch.with_routes(dataclasses.replace(st, **cut)), prod)
        assert want[lost].any() and not got[lost].any()
        np.testing.assert_array_equal(got[~lost], want[~lost])


def hub_rows_matrix(seed=12):
    """128 rows of degree 2,000 over a hyper-sparse scatter: in the nested
    state each stream row ends runs of ~23 of the same 128 rows, the pile-up
    of run ends that makes the route merge (webbase-1M's nested state:
    ~2,100 run ends on each of its 960 y rows)."""
    rng = np.random.default_rng(seed)
    n = 20000
    rows = np.concatenate([rng.integers(0, n, 60000),
                           np.repeat(rng.choice(n, 128, replace=False), 2000)])
    return COOMatrix.from_triplets(n, n, rows,
                                   rng.integers(0, n, len(rows)),
                                   rng.uniform(1, 2, len(rows)), sort=True,
                                   sum_duplicates=True)


@pytest.mark.parametrize("cfg", [F32, X64], ids=["float32", "float64"])
def test_merge_span_where_run_ends_pile_up(cfg):
    """``route_rows`` sets the merge span p_oh · 128 on the nested hub
    state and none on the scattered outer one; at either span the route
    adds the same y, and the spmv meets the oracle."""
    coo = hub_rows_matrix()
    st = xch.convert(port_coo(coo), port_cfg(cfg))
    sub = st.long
    assert sub is not None and sub.p_oh * 128 * 8 * (
        4 if cfg is F32 else 8) <= ops.MERGE_SMEM
    assert (st.merge2, sub.merge2) == (0, sub.p_oh * 128)
    unmerged = dataclasses.replace(sub, merge2=0)
    prod = _uniform((sub.n_chunks, sub.p1, 128), 7).astype(cfg.np_dtype)
    np.testing.assert_array_equal(_rows_y(sub, prod), _rows_y(unmerged, prod))
    x = np.random.default_rng(2).uniform(-1, 1, coo.n_col).astype(
        cfg.np_dtype)
    y = xch.spmv(st, torch.from_numpy(x)).numpy()
    ok, det = verify_result(coo, x, y, dtype=cfg.np_dtype)
    assert ok, det


@pytest.mark.parametrize("r0,r1", [(0, 64), (64, 192)])
def test_mul_out_writes_only_its_slice(r0, r1):
    ref = _ref_state(_mix(5000, 25000, 0), m1_fix=8, t1_fix=64)
    assert ref.win1[0].shape[0] >= r1
    args = [torch.from_numpy(np.array(getattr(ref, f)[0][r0:r1]))
            for f in ("win1", "lane1", "sub1", "val1")]
    x = torch.from_numpy(_uniform((ref.cb_pad, 128), 2))
    grid = torch.full((256, 128), 7.0)
    got = ops.xch_mul(*args, x, 8, 64, out=grid[r0:r1])
    assert got.data_ptr() == grid[r0:r1].data_ptr()
    assert torch.equal(grid[r0:r1], ops.xch_mul_ref(*args, x, 8, 64))
    outside = torch.ones(256, dtype=torch.bool)
    outside[r0:r1] = False
    assert (grid[outside] == 7.0).all()
    with pytest.raises(ValueError):
        ops.xch_mul(*args, x, 8, 64, out=grid[r0:r1 + 1])     # shape
    with pytest.raises(TypeError):
        ops.xch_mul(*args, x, 8, 64, out=grid[r0:r1].double())


def test_rows_wrapper_is_its_plain_version_and_checks_layout():
    st = _small_port()
    p3 = torch.from_numpy(_uniform((st.n_chunks, st.p1, 128), 3))
    a = (st.base2[0], st.cs2[0], st.win2[0], st.lane2[0], st.sub2[0],
         st.hm2[0], st.dest2[0])
    before = (ops.xch_route4_rows.launches, ops.xch_route4_rows.launches_f64)
    y = torch.zeros(st.n_row)
    assert ops.xch_route4_rows(*a, p3, y, st.m2, st.t2) is y
    assert (ops.xch_route4_rows.launches,
            ops.xch_route4_rows.launches_f64) == before     # CPU: plain
    assert torch.equal(y, ops.xch_route4_rows_ref(
        *a, p3, torch.zeros(st.n_row), st.m2, st.t2))
    with pytest.raises(TypeError):
        ops.xch_route4_rows(*a[:6], a[6].int(), p3, y, st.m2, st.t2)
    with pytest.raises(TypeError):
        ops.xch_route4_rows(*a, p3, y.double(), st.m2, st.t2)
    with pytest.raises(ValueError):
        ops.xch_route4_rows(*a, p3, y.view(1, -1), st.m2, st.t2)
    with pytest.raises(ValueError):
        ops.xch_route4_rows(*a, p3, y, st.m2, st.t2 + 1)     # H % T
    with pytest.raises(ValueError):
        ops.xch_route4_rows(*a, p3.view(-1, 128), y, st.m2, st.t2)
    with pytest.raises(ValueError, match="cuda"):
        ops.xch_route4_rows(*(t.to("meta") for t in a), p3.to("meta"),
                            y.to("meta"), st.m2, st.t2)
    for span in (100, -128, 65 * 128):         # not a multiple, < 0, > max
        with pytest.raises(ValueError, match="merge span"):
            ops.xch_route4_rows(*a, p3, y, st.m2, st.t2, span)
    with pytest.raises(ValueError, match="shared memory"):
        ops.xch_route4_rows(*a, p3.double(), y.double(), st.m2, st.t2,
                            24 * 128)                  # 8 spans of 24 KB
