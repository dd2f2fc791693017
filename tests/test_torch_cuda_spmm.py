"""Port panel (SpMM) CUDA kernels on the card: ``slab_spmm``,
``xch_mul_panel`` and ``xch_route4_panel`` against their plain versions at
the CPU tests' shapes and at panels wider than one column tile, and the
``spmm`` of slab, xch, bsr and auto against the float64 oracle per column.

Needs an NVIDIA GPU and skips without one.  This file imports no jax, so it
runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_spmm.py

Kernel and plain version agree to 1e-5·max|out|: the kernels sum runs
serially per lane group plus a scan across groups, and accumulate with
atomics in run-dependent order.  The panels are interleaved, (CB, 128, B).
A lane group of the panel kernels takes a column tile of the power of two
up to 32 that covers B, so an odd B and a B between powers of two leave
lanes idle, and xch_mul_panel takes 4 columns a lane where B is a multiple
of 4.
"""
import numpy as np
import pytest
import torch

from singlespmv_tpu_torch import Config
from singlespmv_tpu_torch.core import verify_result
from singlespmv_tpu_torch.data import powerlaw
from singlespmv_tpu_torch.formats import auto, bsr, slab, spmm_fn, xch
from singlespmv_tpu_torch.ops import _build
from singlespmv_tpu_torch.ops import slab as sops
from singlespmv_tpu_torch.ops import xch as xops
from test_torch_cuda_xch import _scatter

pytestmark = pytest.mark.cuda

TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _panel(n_col, n_cols, seed, device, dtype=np.float32):
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        -1.0, 1.0, (n_col, n_cols)).astype(dtype)).to(device)


def _close(got, want):
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.is_cuda
    assert float((got - want).abs().max()) <= TOL * float(want.abs().max())


def _verify_columns(coo, X, Y, dtype=np.float32):
    X, Y = X.cpu().numpy(), Y.cpu().numpy()
    assert Y.shape == (coo.n_row, X.shape[1])
    for b in range(X.shape[1]):
        ok, det = verify_result(coo, X[:, b], Y[:, b], dtype=dtype)
        assert ok, (b, det)


def _unit_state(coo, planes, m, t=32):
    plan = slab._estimate_cols(coo.row.astype(np.int64),
                               coo.col.astype(np.int64), coo.nnz,
                               fixed={"mode": "unit", "kblk": 1, "m": m,
                                      "t": t, "planes": planes})
    assert plan["feasible"]
    plan.update(hub_cols=None, cols_eff=None, hub_off=0)
    return slab.convert(coo, Config(format="slab"), plan=plan)


@pytest.mark.parametrize("n_cols", [2, 5, 8, 16, 20, 32])
@pytest.mark.parametrize("planes,m", [(8, 1), (16, 8)])
def test_slab_spmm_matches_plain(cuda, planes, m, n_cols):
    coo = powerlaw(1500, 8000, seed=2)
    st = _unit_state(coo, planes, m).to(cuda)
    X = _panel(coo.n_col, n_cols, planes + m, cuda)
    xp = slab.x_table(st, X)
    assert xp.shape == (st.cb_pad, 128, n_cols)
    for a in zip(st.uids, st.sg0, st.sg1, st.win, st.lane, st.sub, st.val,
                 st.hm1, st.idx, st.chunk_nu):
        *streams, nu = a
        before = sops.slab_spmm.launches
        got = sops.slab_spmm(*streams, xp, nu, st.m, st.t_step)
        assert sops.slab_spmm.launches == before + 1
        _close(got, sops.slab_spmm_ref(*streams, xp, nu, st.m, st.t_step))
    _verify_columns(coo, X, slab.spmm(st, X))


def test_slab_spmm_at_full_steps_and_several_chunks(cuda, monkeypatch):
    coo = _scatter(60000, 300000, seed=5)
    monkeypatch.setattr(slab, "CHUNK_ROWS", 2048)
    st = _unit_state(coo, 16, 8, t=128).to(cuda)
    assert len(st.uids) > 1
    X = _panel(coo.n_col, 32, 3, cuda)
    before = sops.slab_spmm.launches
    Y = slab.spmm(st, X)
    assert sops.slab_spmm.launches == before + len(st.uids)
    _verify_columns(coo, X, Y)


def _xch_kernels_vs_plain(st, X):
    """Both panel kernels against their plain versions on every call of
    the state and of its nested state."""
    xp = xch.x_table(st, X)
    prods = []
    for a in zip(st.win1, st.lane1, st.sub1, st.val1):
        before = xops.xch_mul_panel.launches
        got = xops.xch_mul_panel(*a, xp, st.m1, st.t1)
        assert xops.xch_mul_panel.launches == before + 1
        _close(got, xops.xch_mul_panel_ref(*a, xp, st.m1, st.t1))
        prods.append(got)
    prod4 = torch.cat(prods, 0).view(st.n_chunks, st.p1, 128, X.shape[1])
    for *a, ng in zip(st.gids2, st.off2, st.cs2, st.win2, st.lane2, st.sub2,
                      st.hm2, st.sig2, st.idx2, st.chunk_ngrp):
        g = (prod4, ng, st.gb, st.m2, st.t2, st.p_oh)
        before = xops.xch_route4_panel.launches
        got = xops.xch_route4_panel(*a, *g)
        assert xops.xch_route4_panel.launches == before + 1
        _close(got, xops.xch_route4_panel_ref(*a, *g))
    if st.long is not None:
        _xch_kernels_vs_plain(st.long, X)


ROUTES = [
    # kblk, m2, t2, p_oh
    (1, 1, 32, 8),
    (8, 8, 64, 16),
    (32, 8, 256, 64),
]


@pytest.mark.parametrize("n_cols", [2, 5, 8, 16, 20])
@pytest.mark.parametrize("kblk,m2,t2,p_oh", ROUTES)
def test_xch_panels_match_plain(cuda, kblk, m2, t2, p_oh, n_cols):
    coo = _scatter(40000, 200000, seed=kblk)
    plan = xch.estimate(coo, Config(format="xch")) | dict(
        kblk=kblk, kblk_fix=True, m2_fix=m2, t2_fix=t2, p_oh_fix=p_oh)
    st = xch.convert(coo, Config(format="xch"), plan=plan).to(cuda)
    assert (st.kblk, st.m2, st.t2, st.p_oh) == (kblk, m2, t2, p_oh)
    X = _panel(coo.n_col, n_cols, kblk, cuda)
    _xch_kernels_vs_plain(st, X)
    _verify_columns(coo, X, xch.spmm(st, X))


def test_xch_panel_nested_state_and_several_calls(cuda, monkeypatch):
    monkeypatch.setattr(xch, "CHUNK_ROWS", 8 * 64)
    monkeypatch.setattr(xch, "PASS1_CALL_ROWS", 512)
    coo = _scatter(20000, 60000, seed=11, long_rows=8)
    st = xch.convert(coo, Config(format="xch")).to(cuda)
    assert st.long is not None and len(st.win1) > 1 and len(st.gids2) > 1
    X = _panel(coo.n_col, 16, 4, cuda)
    _xch_kernels_vs_plain(st, X)
    _verify_columns(coo, X, xch.spmm(st, X))


def test_spmm_fn_on_the_card(cuda):
    """bsr (block-ELL and chunked) and auto with spmm_b."""
    from singlespmv_tpu_torch.data.generators import generate

    for cfg, coo in ((Config(format="bsr"), generate("band", 4000, 8,
                                                     seed=1)),
                     (Config(format="bsr"), generate("unbalance", 2048,
                                                     seed=1)),
                     (Config(format="auto", spmm_b=8),
                      powerlaw(8000, 80000, seed=3))):
        mod = auto if cfg.format == "auto" else bsr
        st = mod.convert(coo, cfg).to(cuda)
        X = _panel(coo.n_col, 8, 6, cuda)
        _verify_columns(coo, X, spmm_fn(cfg)(st, X))


@pytest.mark.parametrize("fmt", ["slab", "xch"])
def test_float64_spmm_runs_the_fp64_spmv(cuda, fmt):
    coo = _scatter(30000, 150000, seed=7)
    cfg = Config(format=fmt, dtype="float64")
    st = (slab if fmt == "slab" else xch).convert(coo, cfg).to(cuda)
    X = _panel(coo.n_col, 8, 8, cuda, np.float64)
    panel = (sops.slab_spmm.launches, xops.xch_mul_panel.launches,
             xops.xch_route4_panel.launches)
    Y = spmm_fn(cfg)(st, X)
    assert (sops.slab_spmm.launches, xops.xch_mul_panel.launches,
            xops.xch_route4_panel.launches) == panel
    assert Y.dtype == torch.float64
    _verify_columns(coo, X, Y, np.float64)


def test_failed_launch_raises_kernel_error(cuda, monkeypatch):
    st = _unit_state(powerlaw(1500, 8000, seed=2), 8, 1).to(cuda)
    X = _panel(st.n_col, 4, 1, cuda)
    lib = _build.load()

    class Refusing:
        def __getattr__(self, name):
            return lambda *a: 1          # cudaErrorInvalidValue

    monkeypatch.setattr(_build, "_lib", Refusing())
    before = sops.slab_spmm.launches
    with pytest.raises(_build.KernelError, match="slab_spmm"):
        slab.spmm(st, X)
    assert sops.slab_spmm.launches == before
    monkeypatch.setattr(_build, "_lib", lib)

    stream = torch.cuda.current_stream(cuda).cuda_stream
    null = [None] * 11
    # H T m planes B
    assert lib.slab_spmm_f32(*null, 64, 32, 1, 17, 4, stream) != 0
    assert lib.slab_spmm_f32(*null, 64, 32, 1, 8, 0, stream) != 0
    # H T m B
    assert lib.xch_mul_panel_f32(*null[:6], 96, 64, 8, 4, stream) != 0
    assert lib.xch_mul_panel_f32(*null[:6], 0, 64, 8, 4, stream) == 0
    # H T m kblk p_oh n_grp gb p1 B n_chunks
    assert lib.xch_route4_panel_f32(*null, 64, 64, 8, 4, 65, 1, 1024, 64, 4,
                                    1, stream) != 0
    assert lib.xch_route4_panel_f32(*null, 64, 64, 8, 4, 16, 1, 1024, 64, 0,
                                    1, stream) != 0
