"""Port slab spmv route, plain path: ``route_rows`` derives the run-end
destination stream (``ybase``, ``dest``) from the reference's routing
arrays, and ``slab_spmv_rows_ref`` on it, every chunk adding into one y,
gives what the reference's spmv gives: its Pallas kernels ``slab_spmv``,
``slab_spmv_blk`` and, at float64, ``slab_spmv_df`` (interpret mode), with
their out blocks through the reference's own y assembly; on layouts made by
the reference convert, plans forced through its ``fixed`` keys.

The two sum a y position's run totals in different orders (triangle matmul
prefixes, one-hot routes and the shift- or overlap-add against
``torch.cumsum`` and one ``index_add_``), so float32 agrees to rtol 1e-5
with atol 1e-5·max|y|.  At float64 the reference runs its df64 kernel,
~48 bits: 1e-11·max|y|.  The reference's float64 convert turns
``jax_enable_x64`` on for good; every test here puts the flag back.
"""
import contextlib
import dataclasses

import jax
import numpy as np
import pytest
import torch

from singlespmv_tpu.config import Config
from singlespmv_tpu.core import verify_result
from singlespmv_tpu.core.oracle import reference_spmv
from singlespmv_tpu.core.types import COOMatrix
from singlespmv_tpu.data.generators import generate, powerlaw
from singlespmv_tpu.formats import slab as ref_slab
from singlespmv_tpu_torch.formats import slab
from singlespmv_tpu_torch.ops import slab as ops
from torch_parity import port_cfg, port_coo

F32 = Config(format="slab", dtype="float32")
X64 = F32.replace(dtype="float64")
TOL = {np.float32: 1e-5, np.float64: 1e-11}


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


def _plan(mod, coo, mode, kblk=1, planes=8, m=1, t=32):
    plan = mod._estimate_cols(coo.row.astype(np.int64),
                              coo.col.astype(np.int64), coo.nnz,
                              fixed={"mode": mode, "kblk": kblk, "m": m,
                                     "t": t, "planes": planes},
                              unit_only=mode == "unit")
    assert plan["feasible"]
    plan.update(hub_cols=None, cols_eff=None, hub_off=0)
    return plan


def _ref_state(coo, cfg=F32, **fixed):
    return ref_slab.convert(coo, cfg, plan=_plan(ref_slab, coo, **fixed))


def _host(st):
    """A reference state's fields on the host, as ``state_from_reference``
    takes them."""
    out = {}
    for f in dataclasses.fields(st):
        v = getattr(st, f.name)
        if isinstance(v, tuple) and f.name != "chunk_nu":
            v = tuple(np.asarray(a) for a in v)
        elif hasattr(v, "shape"):
            v = np.asarray(v)
        out[f.name] = v
    return out


def _x(coo, seed, dtype=np.float32):
    return np.random.default_rng(seed).uniform(-1, 1, coo.n_col).astype(
        dtype)


def _rows_y(port, x):
    """``slab_spmv_rows_ref`` of every chunk of the port's state, adding
    into one zeroed y."""
    xt = slab.x_table(port, torch.from_numpy(x))
    y = torch.zeros(port.n_row, dtype=xt.dtype)
    for yb, w, la, su, va, h1, d in zip(port.ybase, port.win, port.lane,
                                        port.sub, port.val, port.hm1,
                                        port.dest):
        ops.slab_spmv_rows_ref(yb, w, la, su, va, h1, d, xt, y, port.m,
                               port.t_step, port.merge)
    return y.numpy()


def _ref_y(ref, x):
    """The reference's spmv: its Pallas kernels and its y assembly."""
    return np.asarray(jax.jit(ref_slab.spmv)(ref, x))


def _close(got, want):
    tol = TOL[want.dtype.type]
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())


def _check(ref, seed, dtype=np.float32):
    """The rows route of the state carried from the reference's arrays adds
    the y of the reference's Pallas spmv."""
    port = slab.state_from_reference(_host(ref))
    x = _x(ref, seed, dtype)
    want = _ref_y(ref, x)
    assert np.abs(want).max() > 0
    _close(_rows_y(port, x), want)
    return port


ROUTES = [("unit", 1, 8, 1), ("unit", 1, 8, 8), ("unit", 1, 16, 1),
          ("unit", 1, 16, 8), ("blk", 1, 8, 1), ("blk", 2, 16, 8),
          ("blk", 4, 8, 8), ("blk", 4, 32, 1), ("blk", 1, 32, 8)]


@pytest.mark.parametrize("mode,kblk,planes,m", ROUTES)
def test_rows_route_matches_pallas(mode, kblk, planes, m):
    # 3100 rows = 25 blocks: the last kblk group reaches past y's end
    ref = _ref_state(powerlaw(3100, 30000, seed=3), mode=mode, kblk=kblk,
                     planes=planes, m=m)
    assert (ref.mode, ref.planes, ref.m) == (mode, planes, m)
    port = _check(ref, seed=planes + m)
    assert port.ybase[0].shape == (len(port.uids[0]), planes)
    assert all(int((d >= 0).sum()) > 0 for d in port.dest)


def _one_unit(n=800, seed=4):
    """800 rows: one compact unit whose last 128-row block starts past
    n_row."""
    return powerlaw(n, 12000, seed=seed)


def test_pair_half_off_the_last_unit_and_blocks_past_y():
    """A 16-plane pair block of the only unit: its second half names no
    unit and the block of rows 896-1023 lies past n_row, so their ybase
    entries are −1; the route still adds the reference's y."""
    ref = _ref_state(_one_unit(), mode="unit", planes=16, m=1)
    assert ref.n_units == 1
    port = _check(ref, seed=1)
    yb = port.ybase[0]
    assert (yb[:, 8:] == -1).all() and (yb[:, 7] == -1).all()
    assert (yb[:, :7] >= 0).all()


def test_blk_blocks_past_the_last_compact_block_and_y():
    """kblk 4 over 25 blocks: groups reach past y's 25th block and past
    the last compact block slot; both drop, as in the reference."""
    ref = _ref_state(powerlaw(3100, 30000, seed=5), mode="blk", kblk=4,
                     planes=8, m=8)
    port = _check(ref, seed=2)
    yb = torch.cat(port.ybase)
    ids = np.asarray(ref.unit_ids)
    assert ids.max() * 128 >= ref.n_row          # a block slot past y
    assert (yb == -1).any() and (yb >= 0).any()


@pytest.mark.parametrize("shift", [-1, "top"])
def test_blk_sig_outside_the_one_hot_range(shift):
    """Rows whose sig + j leaves [0, planes) route those planes nowhere, as
    the TPU's one-hot drops them; the rest of the row still lands."""
    ref = _ref_state(powerlaw(3000, 30000, seed=6), mode="blk", kblk=2,
                     planes=8, m=1)
    sig = np.array(ref.sig[0])
    idx = np.asarray(ref.idx[0])
    rows = np.flatnonzero((idx[0] >= 0).any(1) & (idx[1] >= 0).any(1))
    assert len(rows) >= 4
    new = -1 if shift == -1 else ref.planes - 1   # j = 0 or j = 1 leaves
    sig[rows[::2]] = new
    moved = dataclasses.replace(ref, sig=(sig,) + tuple(ref.sig[1:]))
    port = _check(moved, seed=3)
    d = port.dest[0].numpy()
    lost = idx[0 if shift == -1 else 1][rows[::2]]
    for r, e in zip(rows[::2], lost):
        assert (d[r][e[e >= 0]] == -1).all()


@pytest.mark.parametrize("mode", ["unit", "blk"])
def test_rows_route_chunked_stream(monkeypatch, mode):
    coo = powerlaw(6000, 24000, seed=7)
    for mod in (ref_slab, slab):
        monkeypatch.setattr(mod, "CHUNK_ROWS", 256)
    ref = _ref_state(coo, mode=mode, planes=16 if mode == "unit" else 8)
    port = _check(ref, seed=4)
    assert len(port.dest) == len(port.ybase) == len(ref.uids) > 1
    own = slab.convert(port_coo(coo), port_cfg(F32), plan=_plan(
        slab, coo, mode, planes=16 if mode == "unit" else 8))
    for a, b in zip(own.dest + own.ybase, port.dest + port.ybase):
        assert torch.equal(a, b)


def _hubby(n=200_000, seed=5):
    """Hyper-sparse rows plus 500 columns of degree 80: the planner moves
    the hub columns into the x table's appendix."""
    rng = np.random.default_rng(seed)
    hubs = rng.choice(n, 500, replace=False)
    r = np.concatenate([rng.integers(0, n, 40000),
                        rng.integers(0, n, 40000)])
    c = np.concatenate([rng.integers(0, n, 40000), np.repeat(hubs, 80)])
    return COOMatrix.from_triplets(n, n, r, c, rng.uniform(0.1, 1.0, len(r)),
                                   sort=True, sum_duplicates=True)


def test_rows_route_hub_appendix():
    coo = _hubby()
    ref = ref_slab.convert(coo, F32)
    assert ref.hub_cols is not None and ref.hub_off > 0
    _check(ref, seed=5)


@pytest.mark.parametrize("planes,m", [(8, 1), (16, 8)])
def test_rows_route_float64(planes, m):
    coo = powerlaw(2000, 16000, seed=planes + m)
    ref = _ref_state(coo, X64, mode="unit", planes=planes, m=m)
    assert ref.val_lo is not None        # the reference's df64 planes
    port = _check(ref, seed=6, dtype=np.float64)
    assert port.val[0].dtype == torch.float64


def piled_rows(n_units=2, n_blocks=64, seed=8):
    """Rows 0-127 of each 1024-row unit hold one entry in each of
    ``n_blocks`` column blocks: in every layout a block of stream rows ends
    runs of the same 128 y rows again and again (the dense-row stand-ins'
    pile-up)."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.concatenate([u * 1024 + np.arange(128)
                                     for u in range(n_units)]), n_blocks)
    cols = (np.tile(np.arange(n_blocks), n_units * 128) * 128
            + rng.integers(0, 128, len(rows)))
    return COOMatrix.from_triplets(n_units * 1024, n_blocks * 128, rows, cols,
                                   rng.uniform(-1, 1, len(rows)), sort=True)


@pytest.mark.parametrize("cfg,mode", [(F32, "blk"), (X64, "unit")],
                         ids=["float32-blk", "float64-unit"])
def test_merge_span_where_run_ends_pile_up(cfg, mode):
    """``route_rows`` sets the merge span planes · 128 on the piled-up
    layout and none on a scattered one; the route adds the reference's y,
    and the format's spmv meets the oracle."""
    coo = piled_rows()
    ref = _ref_state(coo, cfg, mode=mode, planes=8, m=1)
    port = _check(ref, seed=7, dtype=cfg.np_dtype)
    assert port.merge == 8 * 128
    scattered = slab.state_from_reference(_host(_ref_state(
        generate("band", 3000, 3, seed=1), cfg, mode=mode, planes=8, m=1)))
    assert scattered.merge == 0
    x = _x(coo, 9, cfg.np_dtype)
    y = slab.spmv(port, torch.from_numpy(x)).numpy()
    ok, det = verify_result(coo, x, y, dtype=cfg.np_dtype)
    assert ok, det


@pytest.mark.parametrize("mode", ["unit", "blk"])
def test_route_rows_refuses_an_end_lane_named_twice(mode):
    ref = _ref_state(powerlaw(2000, 16000, seed=9), mode=mode,
                     kblk=1 if mode == "unit" else 2, planes=8)
    st = slab.state_from_reference(_host(ref))
    idx = st.idx[0].clone()
    j, r, l_ = (int(v[0]) for v in torch.nonzero(idx >= 0, as_tuple=True))
    free = [(jj, ll) for jj in range(idx.shape[0]) for ll in range(128)
            if idx[jj, r, ll] < 0]
    t = r // st.t_step
    if mode == "unit":    # a plane the step routes
        free = [(jj, ll) for jj, ll in free
                if st.sg0[0][t] <= jj <= st.sg1[0][t]]
    else:                 # a plane inside the one-hot's range
        free = [(jj, ll) for jj, ll in free
                if 0 <= int(st.sig[0][r, 0]) + jj < st.planes]
    jj, ll = free[0]
    idx[jj, r, ll] = idx[j, r, l_]
    with pytest.raises(ValueError, match="named twice"):
        slab.route_rows(dataclasses.replace(st, idx=(idx,) + st.idx[1:]))


@pytest.mark.parametrize("cfg", [F32, X64], ids=["float32", "float64"])
def test_format_spmv_matches_reference_and_oracle(cfg):
    """The port's convert and spmv on the default plan against the
    reference's spmv and the float64 COO oracle."""
    coo = generate("band", 3000, 12, seed=2)
    ref = ref_slab.convert(coo, cfg)
    port = slab.convert(port_coo(coo), port_cfg(cfg))
    x = _x(coo, 10, cfg.np_dtype)
    y = slab.spmv(port, torch.from_numpy(x)).numpy()
    assert y.shape == (coo.n_row,) and y.dtype == cfg.np_dtype
    _close(y, _ref_y(ref, x))
    ok, det = verify_result(coo, x, y, dtype=cfg.np_dtype)
    assert ok, det
    if cfg is X64:
        want = reference_spmv(coo, x)
        assert np.abs(y - want).max() <= 1e-12 * np.abs(want).max()


LAYOUTS = [("unit8-m8", dict(mode="unit", planes=8, m=8)),
           ("unit16", dict(mode="unit", planes=16, m=1)),
           ("blk-k4-32", dict(mode="blk", kblk=4, planes=32, m=1))]


@pytest.mark.parametrize("label,fixed", LAYOUTS, ids=[c[0] for c in LAYOUTS])
def test_convert_and_reference_give_one_stream(label, fixed):
    """The port's convert derives the stream that ``state_from_reference``
    derives from the reference's arrays; every kept run end has one dest
    inside its step's out block."""
    coo = powerlaw(3100, 30000, seed=11)
    own = slab.convert(port_coo(coo), port_cfg(F32),
                       plan=_plan(slab, coo, **fixed))
    carried = slab.state_from_reference(_host(_ref_state(coo, **fixed)))
    assert own.merge == carried.merge
    for f in ("ybase", "dest"):
        for a, b in zip(getattr(own, f), getattr(carried, f)):
            assert a.dtype == b.dtype and torch.equal(a, b), f
    for d, idx in zip(own.dest, own.idx):
        assert int((d >= 0).sum()) <= int((idx >= 0).sum())
        assert int(d.max()) < own.planes * 128


def test_rows_wrapper_is_its_plain_version_and_checks_layout():
    ref = _ref_state(powerlaw(2000, 16000, seed=12), mode="blk", kblk=2,
                     planes=16, m=1)
    st = slab.state_from_reference(_host(ref))
    xt = slab.x_table(st, torch.from_numpy(_x(st, 13)))
    a = (st.ybase[0], st.win[0], st.lane[0], st.sub[0], st.val[0],
         st.hm1[0], st.dest[0])
    before = (ops.slab_spmv_rows.launches, ops.slab_spmv_rows.launches_f64)
    y = torch.zeros(st.n_row)
    assert ops.slab_spmv_rows(*a, xt, y, st.m, st.t_step) is y
    assert (ops.slab_spmv_rows.launches,
            ops.slab_spmv_rows.launches_f64) == before     # CPU: plain
    assert torch.equal(y, ops.slab_spmv_rows_ref(
        *a, xt, torch.zeros(st.n_row), st.m, st.t_step))
    with pytest.raises(TypeError):
        ops.slab_spmv_rows(*a[:6], a[6].int(), xt, y, st.m, st.t_step)
    with pytest.raises(TypeError):
        ops.slab_spmv_rows(*a, xt, y.double(), st.m, st.t_step)
    with pytest.raises(ValueError):
        ops.slab_spmv_rows(*a, xt, y.view(1, -1), st.m, st.t_step)
    with pytest.raises(ValueError):
        ops.slab_spmv_rows(*a, xt, y, st.m, st.t_step + 1)     # H % T
    with pytest.raises(ValueError, match="ybase"):
        ops.slab_spmv_rows(a[0].repeat(1, 3), *a[1:], xt, y, st.m,
                           st.t_step)                          # 48 planes
    with pytest.raises(ValueError, match="cuda"):
        ops.slab_spmv_rows(*(t.to("meta") for t in a), xt.to("meta"),
                           y.to("meta"), st.m, st.t_step)
    for span in (100, 8 * 128):            # neither 0 nor planes · 128
        with pytest.raises(ValueError, match="merge span"):
            ops.slab_spmv_rows(*a, xt, y, st.m, st.t_step, span)
    wide = (a[0].repeat(1, 2),) + a[1:4] + (a[4].double(),) + a[5:]
    with pytest.raises(ValueError, match="shared memory"):
        ops.slab_spmv_rows(*wide, xt.double(), y.double(), st.m, st.t_step,
                           32 * 128)        # 8 spans of 32 KB at float64
