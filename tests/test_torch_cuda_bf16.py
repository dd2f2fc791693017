"""bfloat16 SpMV and SpMM on the card (ROADMAP A.10, A.10b): each bfloat16
kernel build against its plain version, and the bfloat16 spmv and spmm of
every kernel format against its plain versions and the oracle.

The bfloat16 builds read values, x and the product grids as 2 bytes
(``csrc/stream_row.cuh``: ``load4``, ``gather4``) and sum in float32:
``slab_spmv_rows``, ``xch_mul`` and ``xch_route4_rows``,
``block_gather_mul`` and ``bucket_rows``, ``bucket_fused_rows``,
``ellg_rows``, ``segmented_scan_tiles`` and ``block_gather_scan``.  A
product kernel (``xch_mul``, ``block_gather_mul``: each bfloat16 product
exact in float32, rounded once) equals its plain version bit for bit; a
route or scan, whose y or output is float32, agrees with its plain version
to 1e-5 of max|y| (the atomics and the prefix sum in other orders).  The
fused kernels round each product once to bfloat16 as stage A stores it:
``bucket_fused_rows`` lies within each row's float32 ``reorder_bound`` of
the unfused pair on the same state, ``ellg_rows`` within the bound of any
order of a row's products of the first port of the passes (stage A, then
the sums in torch); a product left unrounded would miss either by far.  The whole spmv, y rounded once to
bfloat16, on the card (twice) and on the plain versions (the state moved
to the host) lies within ``torch_bounds.accuracy_bound`` of the float64
oracle of the stored values; the two card results lie within each row's
``reorder_bound`` (float32 accumulator, bfloat16 output) of each other;
and all pass the oracle at bfloat16.  A bfloat16 call launches only
bfloat16 builds: the float32 and float64 counters stay.

The panels' bfloat16 builds (``slab_spmm``, ``xch_mul_panel``,
``xch_route4_panel``) are held one call at a time: the products equal
their plain version bit for bit; a route's float32 out, kernel and plain
version, each within ``torch_bounds.route_entry_bound`` of the float64
plain version on the call's inputs.  Every column of the spmm's Y, on the
kernels (twice) and on the plain versions (on the card's tensors), lies
within ``accuracy_bound`` of the oracle of the stored values, the two
kernel results within each row's ``reorder_bound`` of each other.

Needs an NVIDIA GPU and skips without one.  This file imports no jax:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_bf16.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from singlespmv_tpu_torch import Config
from singlespmv_tpu_torch.core import COOMatrix, verify_result
from singlespmv_tpu_torch.core.dtypes import round_values, to_host
from singlespmv_tpu_torch.core.oracle import reference_spmv, reorder_bound
from singlespmv_tpu_torch.data import powerlaw
from singlespmv_tpu_torch.data.generators import generate
from singlespmv_tpu_torch.formats import (adds_per_row, bkt, css, csr5, ellg,
                                          get_format, slab, ss, xch)
from singlespmv_tpu_torch.ops import blockgather as gops
from singlespmv_tpu_torch.ops import bucket as bops
from singlespmv_tpu_torch.ops import segscan as sops
from singlespmv_tpu_torch.ops import slab as ops
from singlespmv_tpu_torch.ops import xch as xops

from torch_bounds import accuracy_bound, route_entry_bound, stored
from test_torch_cuda_bkt import _scattered
from test_torch_cuda_slab import _state as slab_state
from test_torch_cuda_slab import piled_rows
from test_torch_cuda_xch import _scatter

pytestmark = pytest.mark.cuda

BF16 = "bfloat16"
TOL = 1e-5       # a float32 y or scan against its plain version, of max|y|
WRAPPERS = (ops.slab_spmv_rows, xops.xch_fused_rows, xops.xch_mul,
            xops.xch_route4_rows,
            bops.block_gather_mul, bops.bucket_rows, bops.bucket_fused_rows,
            bops.ellg_rows, sops.segmented_scan_tiles,
            gops.block_gather_scan)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _counts():
    return {(w.__name__, a): getattr(w, a) for w in WRAPPERS
            for a in ("launches", "launches_f64", "launches_bf16")
            if hasattr(w, a)}


def _x(coo, dev):
    xh = round_values(np.random.default_rng(1).uniform(-1, 1, coo.n_col),
                      BF16)
    return xh, torch.from_numpy(xh).to(dev, torch.bfloat16)


def _close(got, want):
    torch.cuda.synchronize()
    assert got.is_cuda and got.dtype == want.dtype and got.shape == want.shape
    scale = float(want.abs().max())
    assert scale > 0
    assert float((got - want).abs().max()) <= TOL * scale


def _spmv_within_bound(coo, st, cfg, dev, kernels=True):
    """The state's bfloat16 spmv, twice on the card and once on the host
    (the plain versions): each within the accuracy bound of the oracle of
    the stored values, the two card results within each row's reorder
    bound of each other, all through the oracle; only bfloat16 builds
    launch (and some do, where ``kernels``)."""
    xh, x = _x(coo, dev)
    mod = get_format(cfg.format)
    before = _counts()
    y_k = mod.spmv(st, x)
    torch.cuda.synchronize()
    after = _counts()
    rose = {k for k in after if after[k] != before[k]}
    assert all(a == "launches_bf16" for _, a in rose), rose
    assert rose or not kernels
    y_k2 = mod.spmv(st, x)
    y_p = mod.spmv(st.to("cpu"), x.cpu())
    assert y_k.dtype == y_k2.dtype == y_p.dtype == torch.bfloat16
    sc = stored(coo)
    fmt = "bkt_g" if cfg.format == "bkt" and cfg.bkt_row_group == 1024 \
        else cfg.format
    bound = accuracy_bound(sc, xh, st, fmt, x)
    r = reference_spmv(sc, xh)
    ys = [to_host(y).astype(np.float64) for y in (y_k, y_k2, y_p)]
    for y in ys:
        err = np.abs(y - r)
        assert (err <= bound).all(), float(np.max(err / bound))
        ok, det = verify_result(coo, xh, y, dtype=BF16)
        assert ok, det
    reorder = reorder_bound(sc, xh, adds_per_row(st, cfg), "float32", BF16)
    assert (np.abs(ys[0] - ys[1]) <= reorder).all()


SLAB_CASES = {
    "unit": lambda: (powerlaw(6000, 40000, seed=2), "unit"),
    "blk": lambda: (powerlaw(6000, 40000, seed=3), "blk"),
    "merge": lambda: (piled_rows(), "blk"),
}


@pytest.mark.parametrize("case", sorted(SLAB_CASES))
def test_slab_rows_bf16(cuda, case):
    coo, mode = SLAB_CASES[case]()
    st = slab_state(coo, BF16, mode)
    assert (st.merge > 0) == (case == "merge")
    st = st.to(cuda)
    xh, x = _x(coo, cuda)
    xt = slab.x_table(st, x)
    assert st.val[0].dtype == xt.dtype == torch.bfloat16
    for a in zip(st.ybase, st.win, st.lane, st.sub, st.val, st.hm1,
                 st.dest):
        ys = [f(*a, xt, torch.zeros(st.n_row, device=cuda), st.m,
                st.t_step, st.merge)
              for f in (ops.slab_spmv_rows, ops.slab_spmv_rows_ref)]
        _close(*ys)
    _spmv_within_bound(coo, st, Config(format="slab", dtype=BF16), cuda)


@pytest.mark.parametrize("long_rows", [0, 8])
def test_xch_bf16(cuda, long_rows):
    coo = _scatter(30000, 150000, seed=8) if not long_rows \
        else _scatter(20000, 60000, seed=11, long_rows=long_rows)
    cfg = Config(format="xch", dtype=BF16)
    st = xch.convert(coo, cfg).to(cuda)
    assert (st.long is not None) == bool(long_rows)
    xh, x = _x(coo, cuda)
    xt = xch.x_table(st, x)
    for a in zip(st.win1, st.lane1, st.sub1, st.val1):
        got = xops.xch_mul(*a, xt, st.m1, st.t1)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, xops.xch_mul_ref(*a, xt, st.m1, st.t1))
    prod = xch.products(st, xt)
    assert prod.dtype == torch.bfloat16
    for a in zip(st.base2, st.cs2, st.win2, st.lane2, st.sub2, st.hm2,
                 st.dest2):
        ys = [f(*a, prod, torch.zeros(st.n_row, device=cuda), st.m2, st.t2,
                st.merge2)
              for f in (xops.xch_route4_rows, xops.xch_route4_rows_ref)]
        _close(*ys)
    _spmv_within_bound(coo, st, cfg, cuda)


@pytest.mark.parametrize("rg", [128, 1024])
def test_bucket_bf16(cuda, rg):
    coo = powerlaw(6000, 60000, seed=2) if rg == 128 \
        else _scattered(60000, 300000, 3)
    cfg = Config(format="bkt", dtype=BF16, bkt_row_group=rg)
    st = bkt.convert(coo, cfg).to(cuda)
    xh, x = _x(coo, cuda)
    a = (st.members, st.lane, st.src, st.val, bkt.x_table(st, x), st.m)
    prod = bops.block_gather_mul(*a)
    assert prod.dtype == torch.bfloat16
    assert torch.equal(prod, bops.block_gather_mul_ref(*a))
    nu_pad, sh, _, h = bkt._unit_rows(st)
    ys = [f(prod.view(h, 128), st.hm1r, st.dest, st.yrow,
            torch.zeros(st.n_row, device=cuda), sh, nu_pad, st.parts)
          for f in (bops.bucket_rows, bops.bucket_rows_ref)]
    _close(*ys)
    # the fused launch: each product rounded once, as the pair stores it
    fused = [f(*a, st.hm1r, st.dest, st.yrow,
               torch.zeros(st.n_row, device=cuda), sh, nu_pad, st.parts)
             for f in (bops.bucket_fused_rows, bops.bucket_fused_rows_ref)]
    _close(*fused)
    bound = reorder_bound(stored(coo), xh, bkt.adds_per_row(st), "float32",
                          "float32")
    err = np.abs(to_host(fused[0]).astype(np.float64) - to_host(ys[0]))
    assert (err <= bound).all(), float(np.max(err - bound))
    _spmv_within_bound(coo, st, cfg, cuda)


def test_ellg_rows_bf16(cuda):
    """ellg's passes in one bfloat16 launch: against its plain version,
    and against the first port of the passes (stage A's bfloat16 products,
    then the row sums in torch) within the bound of any order of a row's
    products."""
    coo = _scattered(20000, 100000, 2)
    cfg = Config(format="ellg", dtype=BF16)
    st = ellg.convert(coo, cfg)
    assert len(st.passes) > 1
    passes_only = dataclasses.replace(st, rest_fmt="", rest_state=None)
    pcoo = ellg.to_coo(passes_only)
    st = st.to(cuda)
    xh, x = _x(coo, cuda)
    xp = torch.zeros(-(-coo.n_col // 128) * 128, device=cuda,
                     dtype=torch.bfloat16)
    xp[: coo.n_col] = x
    n0 = bops.ellg_rows.launches_bf16
    first_port = dict(stage_a=bops.block_gather_mul)
    ys = [f(ellg.row_passes(st.passes), xp,
            torch.zeros(st.n_row, device=cuda), **kw)
          for f, kw in ((bops.ellg_rows, {}), (bops.ellg_rows_ref, {}),
                        (bops.ellg_rows_ref, first_port))]
    assert bops.ellg_rows.launches_bf16 == n0 + 1
    _close(ys[0], ys[1])
    bound = reorder_bound(pcoo, xh, pcoo.row_lengths(), "float32",
                          "float32")
    err = np.abs(to_host(ys[0]).astype(np.float64) - to_host(ys[2]))
    assert (err <= bound).all(), float(np.max(err - bound))
    _spmv_within_bound(coo, st, cfg, cuda)


@pytest.mark.parametrize("fmt", ["ss", "csr5", "css"])
def test_scans_bf16(cuda, fmt):
    coo = powerlaw(8000, 60000, seed=5)
    cfg = Config(format=fmt, dtype=BF16)
    mod = {"ss": ss, "csr5": csr5, "css": css}[fmt]
    st = mod.convert(coo, cfg).to(cuda)
    xh, x = _x(coo, cuda)
    if fmt == "css":
        args = (st.block_ids, st.col, st.val, st.heads, css.x_table(st, x))
        fn, ref = gops.block_gather_scan, gops.block_gather_scan_ref
    else:
        prod = csr5.normal_products(st, x) if fmt == "csr5" \
            else ss.mul(st, x)
        assert prod.dtype == torch.bfloat16
        args = (prod, st.heads)
        fn, ref = sops.segmented_scan_tiles, sops.segmented_scan_tiles_ref
    got = fn(*args)
    assert got.dtype == torch.float32
    _close(got, ref(*args))
    _spmv_within_bound(coo, st, cfg, cuda)


@pytest.mark.parametrize("fmt", ["hyb", "ellg", "auto"])
def test_composite_formats_bf16(cuda, fmt):
    """hyb (a dia peel and a kernel residual), ellg (stage A at gran 128
    and a rest) and auto (its trials at bfloat16 on the card)."""
    from test_torch_cuda_campaign import _tail

    if fmt == "hyb":       # a band over a scattered residual
        band, rest = generate("band", 20000, 5, seed=4), \
            powerlaw(20000, 100000, seed=6)
        coo = COOMatrix.from_triplets(
            20000, 20000, np.concatenate([band.row, rest.row]),
            np.concatenate([band.col, rest.col]),
            np.concatenate([band.val, rest.val]), sum_duplicates=True)
    else:
        coo = _tail() if fmt == "ellg" else powerlaw(20000, 120000, seed=6)
    cfg = Config(format=fmt, dtype=BF16)
    mod = get_format(fmt)
    st = (mod.convert(coo, cfg, device=cuda) if fmt == "auto"
          else mod.convert(coo, cfg)).to(cuda)
    if fmt == "ellg":
        assert all(p.val.dtype == torch.bfloat16 for p in st.passes)
        assert isinstance(st, ellg.ELLGState)
    # auto may choose an engine of plain torch operations
    _spmv_within_bound(coo, st, cfg, cuda, kernels=fmt != "auto")


def test_float32_only_kernels_refuse_bf16(cuda):
    """The first port's kernels have no bfloat16 build: their wrappers
    raise."""
    coo = powerlaw(3000, 20000, seed=7)
    st = slab_state(coo, BF16, "unit").to(cuda)
    x = torch.ones(coo.n_col, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        ops.slab_spmv(st.uids[0], st.sg0[0], st.sg1[0], st.win[0],
                      st.lane[0], st.sub[0], st.val[0], st.hm1[0], st.idx[0],
                      slab.x_table(st, x), st.chunk_nu[0], st.m, st.t_step)


# ------------------------------------------------------ SpMM (A.10b) -------

PANELS = (ops.slab_spmm, xops.xch_mul_panel, xops.xch_route4_panel)


def _panel_counts():
    return {(w.__name__, a): getattr(w, a)
            for w in PANELS + WRAPPERS
            for a in ("launches", "launches_f64", "launches_bf16")
            if hasattr(w, a)}


def _bf16_panel(coo, n_cols, dev, seed=3):
    Xh = round_values(np.random.default_rng(seed).uniform(
        -1, 1, (coo.n_col, n_cols)), BF16)
    return Xh, torch.from_numpy(Xh).to(dev, torch.bfloat16)


def _route_within_bound(got, want, plain, args, panel, hm1_at, rest,
                        val_at=None):
    """One route call: its kernel's float32 out and its plain version's,
    each within ``route_entry_bound`` of the float64 plain version."""
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == torch.float32
    exact, bound, _ = route_entry_bound(plain, args, panel, hm1_at, rest,
                                        val_at)
    for out in (got, want):
        err = np.abs(to_host(out).astype(np.float64) - exact)
        assert (err <= bound).all(), float(np.max(err / bound))


def _spmm_within_bound(coo, st, fmt, Xh, X, monkeypatch, need):
    """The state's bfloat16 spmm twice on the card's kernels and once on
    the plain panels (the card's tensors): every column within the accuracy
    bound of the oracle of the stored values and through the oracle, the
    two kernel results within each row's reorder bound of each other; only
    bfloat16 builds launch, the panels of ``need`` among them."""
    mod = get_format(fmt)
    before = _panel_counts()
    y1 = mod.spmm(st, X)
    torch.cuda.synchronize()
    after = _panel_counts()
    rose = {k for k in after if after[k] != before[k]}
    assert all(a == "launches_bf16" for _, a in rose), rose
    assert {w for w, _ in rose} >= set(need), rose
    y2 = mod.spmm(st, X)
    with monkeypatch.context() as m:
        m.setattr(slab, "slab_spmm", ops.slab_spmm_ref)
        m.setattr(xch, "xch_mul_panel", xops.xch_mul_panel_ref)
        m.setattr(xch, "xch_route4_panel", xops.xch_route4_panel_ref)
        yp = mod.spmm(st, X)
    assert y1.dtype == y2.dtype == yp.dtype == torch.bfloat16
    ys = [to_host(y).astype(np.float64) for y in (y1, y2, yp)]
    sc = stored(coo)
    adds = adds_per_row(st, Config(format=fmt, dtype=BF16))
    for b in range(X.shape[1]):
        xh = Xh[:, b].astype(np.float64)
        bound = accuracy_bound(sc, xh, st, fmt, X[:, b].contiguous())
        r = reference_spmv(sc, xh)
        for y in (ys[0], ys[2]):
            err = np.abs(y[:, b] - r)
            assert (err <= bound).all(), (b, float(np.max(err / bound)))
            ok, det = verify_result(coo, Xh[:, b], y[:, b], dtype=BF16)
            assert ok, (b, det)
        reorder = reorder_bound(sc, xh, adds, "float32", BF16)
        assert (np.abs(ys[0][:, b] - ys[1][:, b]) <= reorder).all(), b


def _unit_state(coo, planes, m, t=32):
    plan = slab._estimate_cols(coo.row.astype(np.int64),
                               coo.col.astype(np.int64), coo.nnz,
                               fixed={"mode": "unit", "kblk": 1, "m": m,
                                      "t": t, "planes": planes})
    assert plan["feasible"]
    plan.update(hub_cols=None, cols_eff=None, hub_off=0)
    return slab.convert(coo, Config(format="slab", dtype=BF16), plan=plan)


@pytest.mark.parametrize("n_cols", [2, 5, 8, 16, 20, 32])
@pytest.mark.parametrize("planes,m", [(8, 1), (16, 8)])
def test_slab_spmm_bf16(cuda, planes, m, n_cols, monkeypatch):
    coo = powerlaw(1500, 8000, seed=2)
    st = _unit_state(coo, planes, m).to(cuda)
    Xh, X = _bf16_panel(coo, n_cols, cuda)
    xp = slab.x_table(st, X)
    assert xp.dtype == st.val[0].dtype == torch.bfloat16
    for *a, nu in zip(st.uids, st.sg0, st.sg1, st.win, st.lane, st.sub,
                      st.val, st.hm1, st.idx, st.chunk_nu):
        rest = (nu, st.m, st.t_step)
        before = ops.slab_spmm.launches_bf16
        got = ops.slab_spmm(*a, xp, *rest)
        assert ops.slab_spmm.launches_bf16 == before + 1
        _route_within_bound(got, ops.slab_spmm_ref(*a, xp, *rest),
                            ops.slab_spmm_ref, a, xp, 7, rest, val_at=6)
    _spmm_within_bound(coo, st, "slab", Xh, X, monkeypatch, ("slab_spmm",))


def _xch_panels_bf16(st, X):
    """Both bfloat16 panel kernels against their plain versions on every
    call of the state and of its nested state."""
    xp = xch.x_table(st, X)
    prods = []
    for a in zip(st.win1, st.lane1, st.sub1, st.val1):
        before = xops.xch_mul_panel.launches_bf16
        got = xops.xch_mul_panel(*a, xp, st.m1, st.t1)
        assert xops.xch_mul_panel.launches_bf16 == before + 1
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, xops.xch_mul_panel_ref(*a, xp, st.m1, st.t1))
        prods.append(got)
    prod4 = torch.cat(prods, 0).view(st.n_chunks, st.p1, 128, X.shape[1])
    for *a, ng in zip(st.gids2, st.off2, st.cs2, st.win2, st.lane2, st.sub2,
                      st.hm2, st.sig2, st.idx2, st.chunk_ngrp):
        rest = (ng, st.gb, st.m2, st.t2, st.p_oh)
        before = xops.xch_route4_panel.launches_bf16
        got = xops.xch_route4_panel(*a, prod4, *rest)
        assert xops.xch_route4_panel.launches_bf16 == before + 1
        _route_within_bound(got, xops.xch_route4_panel_ref(*a, prod4, *rest),
                            xops.xch_route4_panel_ref, a, prod4, 6, rest)
    if st.long is not None:
        _xch_panels_bf16(st.long, X)


@pytest.mark.parametrize("n_cols", [2, 5, 8, 16])
@pytest.mark.parametrize("kblk,m2,t2,p_oh", [(1, 1, 32, 8), (8, 8, 64, 16),
                                             (32, 8, 256, 64)])
def test_xch_panels_bf16(cuda, kblk, m2, t2, p_oh, n_cols, monkeypatch):
    coo = _scatter(40000, 200000, seed=kblk)
    cfg = Config(format="xch", dtype=BF16)
    plan = xch.estimate(coo, cfg) | dict(
        kblk=kblk, kblk_fix=True, m2_fix=m2, t2_fix=t2, p_oh_fix=p_oh)
    st = xch.convert(coo, cfg, plan=plan).to(cuda)
    assert (st.kblk, st.m2, st.t2, st.p_oh) == (kblk, m2, t2, p_oh)
    Xh, X = _bf16_panel(coo, n_cols, cuda)
    _xch_panels_bf16(st, X)
    _spmm_within_bound(coo, st, "xch", Xh, X, monkeypatch,
                       ("xch_mul_panel", "xch_route4_panel"))


def test_xch_panels_bf16_peel_and_nested_state(cuda, monkeypatch):
    """A peeled band and a nested long-row state over several calls: the
    peel and the nested Y add in float32 before Y's one rounding."""
    monkeypatch.setattr(xch, "CHUNK_ROWS", 8 * 64)
    monkeypatch.setattr(xch, "PASS1_CALL_ROWS", 512)
    band, rest = generate("band", 20000, 3, seed=4), \
        _scatter(20000, 60000, seed=11, long_rows=8)
    coo = COOMatrix.from_triplets(
        20000, 20000, np.concatenate([band.row, rest.row]),
        np.concatenate([band.col, rest.col]),
        np.concatenate([band.val, rest.val]), sum_duplicates=True)
    st = xch.convert(coo, Config(format="xch", dtype=BF16)).to(cuda)
    assert st.long is not None and st.dia_vals is not None
    assert len(st.win1) > 1 and len(st.gids2) > 1
    Xh, X = _bf16_panel(coo, 16, cuda)
    _xch_panels_bf16(st, X)
    _spmm_within_bound(coo, st, "xch", Xh, X, monkeypatch,
                       ("xch_mul_panel", "xch_route4_panel"))


@pytest.mark.parametrize("fmt", ["hyb", "bsr", "csr", "auto"])
def test_spmm_fn_bf16(cuda, fmt, monkeypatch):
    """spmm_fn at bfloat16 and B 8 through formats without a panel kernel
    of their own (hyb's slab residual may take one) and auto with
    spmm_b 8: each column of Y through the oracle at bfloat16, and within
    the accuracy bound of the oracle of the stored values."""
    from singlespmv_tpu_torch.formats import auto, spmm_fn

    if fmt == "hyb":
        band, rest = generate("band", 20000, 5, seed=4), \
            powerlaw(20000, 100000, seed=6)
        coo = COOMatrix.from_triplets(
            20000, 20000, np.concatenate([band.row, rest.row]),
            np.concatenate([band.col, rest.col]),
            np.concatenate([band.val, rest.val]), sum_duplicates=True)
    elif fmt == "bsr":
        coo = generate("band", 4000, 8, seed=1)
    else:
        coo = powerlaw(8000, 80000, seed=3)
    cfg = Config(format=fmt, dtype=BF16, spmm_b=8 if fmt == "auto" else 0)
    st = (auto.convert(coo, cfg, device=cuda) if fmt == "auto"
          else get_format(fmt).convert(coo, cfg)).to(cuda)
    Xh, X = _bf16_panel(coo, 8, cuda)
    Y = spmm_fn(cfg)(st, X)
    assert Y.dtype == torch.bfloat16 and Y.shape == (coo.n_row, 8)
    y = to_host(Y).astype(np.float64)
    sc = stored(coo)
    for b in range(8):
        xh = Xh[:, b].astype(np.float64)
        bound = accuracy_bound(sc, xh, st, fmt, X[:, b].contiguous())
        err = np.abs(y[:, b] - reference_spmv(sc, xh))
        assert (err <= bound).all(), (b, float(np.max(err / bound)))
        assert verify_result(coo, Xh[:, b], y[:, b], dtype=BF16)[0], b
