"""Port slab spmv route on the card: ``slab_rows_kernel`` and its merge
variant ``slab_rows_merge_kernel`` (``ops.slab.slab_spmv_rows``) against
their plain version at float32 and float64, in unit and blk mode, on the
int16 run-end destinations that ``route_rows`` derives; the first port's
``slab_unit_kernel`` and ``slab_blk_kernel`` against theirs; and the slab
spmv, which launches only the new route, against the oracle.

Needs an NVIDIA GPU and skips without one.  This file imports no jax, so it
runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_slab.py

A kernel and its plain version agree to 1e-5·max|y| at float32 and
1e-12·max|y| at float64: the kernels add a position's run totals with
atomics in run-dependent order.
"""
import dataclasses

import numpy as np
import pytest
import torch

from singlespmv_tpu_torch import Config
from singlespmv_tpu_torch.core import COOMatrix, reference_spmv
from singlespmv_tpu_torch.data import powerlaw
from singlespmv_tpu_torch.formats import slab
from singlespmv_tpu_torch.ops import slab as ops

pytestmark = pytest.mark.cuda

F32 = Config(format="slab", dtype="float32")
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _state(coo, dtype, mode, kblk=1, planes=8, m=1, t=32):
    plan = slab._estimate_cols(coo.row.astype(np.int64),
                               coo.col.astype(np.int64), coo.nnz,
                               fixed={"mode": mode, "kblk": kblk, "m": m,
                                      "t": t, "planes": planes},
                               unit_only=mode == "unit")
    assert plan["feasible"]
    plan.update(hub_cols=None, cols_eff=None, hub_off=0)
    if mode == "blk" and dtype == "float64":
        # the planner's float64 plans are unit mode only: the kernel's blk
        # route at double, on a float32 layout's values widened
        st = slab.convert(coo, F32, plan=plan)
        return dataclasses.replace(st, val=tuple(v.double() for v in st.val))
    return slab.convert(coo, F32.replace(dtype=dtype), plan=plan)


def piled_rows(n_units=3, n_blocks=64, seed=8):
    """Rows 0-127 of each unit hold one entry in each of ``n_blocks``
    column blocks: a block of stream rows ends runs of the same 128 y rows
    again and again, and ``route_rows`` sets the merge span."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.concatenate([u * 1024 + np.arange(128)
                                     for u in range(n_units)]), n_blocks)
    cols = (np.tile(np.arange(n_blocks), n_units * 128) * 128
            + rng.integers(0, 128, len(rows)))
    return COOMatrix.from_triplets(n_units * 1024, n_blocks * 128, rows, cols,
                                   rng.uniform(-1, 1, len(rows)), sort=True)


def _close(got, want):
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.is_cuda and got.dtype == want.dtype
    scale = float(want.abs().max())
    assert scale > 0
    assert float((got - want).abs().max()) <= TOL[want.dtype] * scale


def _counts(w):
    return w.launches, getattr(w, "launches_f64", 0)


def _rows_vs_plain(st, span, seed=0):
    """Every chunk of the state through the kernel (merge span ``span``)
    and through the plain version, each adding into a zeroed y."""
    vt = st.val[0].dtype
    dev = st.val[0].device
    xt = torch.from_numpy(np.random.default_rng(seed).uniform(
        -1, 1, (st.cb_pad, 128))).to(dev, vt)
    got = torch.zeros(st.n_row, dtype=vt, device=dev)
    want = torch.zeros_like(got)
    for a in zip(st.ybase, st.win, st.lane, st.sub, st.val, st.hm1,
                 st.dest):
        before = _counts(ops.slab_spmv_rows)
        ops.slab_spmv_rows(*a, xt, got, st.m, st.t_step, span)
        f32, f64 = before
        assert _counts(ops.slab_spmv_rows) == (
            (f32, f64 + 1) if vt == torch.float64 else (f32 + 1, f64))
        ops.slab_spmv_rows_ref(*a, xt, want, st.m, st.t_step)
    _close(got, want)


ROUTES = [("float32", "unit", 1, 8, 1), ("float32", "unit", 1, 16, 8),
          ("float32", "blk", 1, 8, 1), ("float32", "blk", 2, 16, 8),
          ("float32", "blk", 4, 32, 1), ("float64", "unit", 1, 8, 8),
          ("float64", "unit", 1, 16, 1), ("float64", "blk", 4, 8, 1)]


@pytest.mark.parametrize("dtype,mode,kblk,planes,m", ROUTES)
@pytest.mark.parametrize("merge", [False, True], ids=["direct", "merge"])
def test_rows_kernel_matches_plain(cuda, dtype, mode, kblk, planes, m,
                                   merge):
    st = _state(powerlaw(6100, 60000, seed=2), dtype, mode, kblk, planes,
                m).to(cuda)
    span = planes * 128 if merge else 0
    if 8 * span * st.val[0].element_size() > ops.MERGE_SMEM:
        pytest.skip("the spans pass the merge kernel's shared memory")
    _rows_vs_plain(st, span)


@pytest.mark.parametrize("dtype,mode", [("float32", "blk"),
                                        ("float32", "unit"),
                                        ("float64", "unit")])
def test_merge_where_run_ends_pile_up(cuda, dtype, mode):
    coo = piled_rows()
    st = _state(coo, dtype, mode).to(cuda)
    assert st.merge == st.planes * 128
    _rows_vs_plain(st, st.merge, seed=1)
    _rows_vs_plain(st, 0, seed=1)
    x = np.random.default_rng(2).uniform(-1, 1, coo.n_col)
    y = slab.spmv(st, torch.from_numpy(x).to(cuda, st.val[0].dtype))
    want = reference_spmv(coo, x)
    rel = np.abs(y.cpu().numpy() - want).max() / np.abs(want).max()
    assert rel <= (1e-12 if dtype == "float64" else 1e-5)


def test_chunked_stream(cuda, monkeypatch):
    monkeypatch.setattr(slab, "CHUNK_ROWS", 256)
    for mode, planes in (("unit", 16), ("blk", 8)):
        st = _state(powerlaw(8000, 30000, seed=6), "float32", mode,
                    planes=planes).to(cuda)
        assert len(st.dest) > 1
        _rows_vs_plain(st, 0, seed=3)


@pytest.mark.parametrize("dtype,mode,kblk,planes,m",
                         [("float32", "unit", 1, 16, 1),
                          ("float32", "blk", 4, 32, 8),
                          ("float64", "unit", 1, 8, 8)])
def test_spmv_launches_only_the_rows_route(cuda, dtype, mode, kblk, planes,
                                           m):
    coo = powerlaw(6000, 60000, seed=4)
    st = _state(coo, dtype, mode, kblk, planes, m).to(cuda)
    first = (ops.slab_spmv, ops.slab_spmv_blk)
    before = [_counts(w) for w in first]
    rows = _counts(ops.slab_spmv_rows)
    x = np.random.default_rng(5).uniform(-1, 1, coo.n_col)
    y = slab.spmv(st, torch.from_numpy(x).to(cuda, st.val[0].dtype))
    assert [_counts(w) for w in first] == before
    assert sum(_counts(ops.slab_spmv_rows)) == sum(rows) + len(st.dest)
    want = reference_spmv(coo, x)
    rel = np.abs(y.cpu().numpy() - want).max() / np.abs(want).max()
    assert rel <= (1e-12 if dtype == "float64" else 1e-5)


@pytest.mark.parametrize("dtype,mode,kblk,planes,m",
                         [("float32", "unit", 1, 16, 8),
                          ("float32", "blk", 2, 16, 1),
                          ("float64", "unit", 1, 8, 1)])
def test_first_port_kernels_match_plain(cuda, dtype, mode, kblk, planes, m):
    st = _state(powerlaw(6000, 60000, seed=7), dtype, mode, kblk, planes,
                m).to(cuda)
    vt = st.val[0].dtype
    xt = torch.from_numpy(np.random.default_rng(6).uniform(
        -1, 1, (st.cb_pad, 128))).to(cuda, vt)
    for c, nu in enumerate(st.chunk_nu):
        f = {k: getattr(st, k)[c] for k in (
            "uids", "sg0", "sg1", "win", "lane", "sub", "val", "hm1", "idx",
            "sig") if getattr(st, k) is not None}
        if mode == "blk":
            a = [f[k] for k in ("uids", "win", "lane", "sub", "val", "hm1",
                                "idx", "sig")]
            got = ops.slab_spmv_blk(*a, xt, nu, st.m, planes, st.t_step)
            want = ops.slab_spmv_blk_ref(*a, xt, nu, st.m, planes, st.t_step)
        else:
            a = [f[k] for k in ("uids", "sg0", "sg1", "win", "lane", "sub",
                                "val", "hm1", "idx")]
            got = ops.slab_spmv(*a, xt, nu, st.m, st.t_step)
            want = ops.slab_spmv_ref(*a, xt, nu, st.m, st.t_step)
        _close(got, want)


def test_rows_wrapper_refuses_bad_cuda_layouts(cuda):
    st = _state(powerlaw(3000, 30000, seed=5), "float32", "blk", 2,
                16).to(cuda)
    a = [st.ybase[0], st.win[0], st.lane[0], st.sub[0], st.val[0],
         st.hm1[0], st.dest[0]]
    xt = torch.zeros(st.cb_pad, 128, device=cuda)
    y = torch.zeros(st.n_row, device=cuda)
    with pytest.raises(ValueError, match="is on"):
        ops.slab_spmv_rows(*a[:6], a[6].cpu(), xt, y, st.m, st.t_step)
    flat = torch.zeros(a[4].numel() + 1, device=cuda)
    shifted = flat[1:].view(a[4].shape)          # 4-byte aligned only
    with pytest.raises(ValueError, match="aligned"):
        ops.slab_spmv_rows(*a[:4], shifted, *a[5:], xt, y, st.m, st.t_step)
    bad = dataclasses.replace(st, merge=16 * 128 + 1)
    with pytest.raises(ValueError, match="merge span"):
        slab.spmv(bad, torch.zeros(st.n_col, device=cuda))
