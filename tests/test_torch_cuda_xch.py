"""Port xch CUDA kernels on the card: the spmv's fused route
``xch_fused_rows`` (both passes in one launch, the products in registers),
the pair it replaced, ``xch_mul`` and ``xch_route4_rows`` (on the profiling
phases and the calibration), and the first port's route ``xch_route4`` (on
no path) against their plain versions, and the xch spmv against the
float64 oracle through ``xch_fused_rows`` alone, one launch a pass-2 call,
over kblk 1/8/16/32, m2 1/8/24, t2 32 to 256, several kernel calls per
pass, and a nested long-row state; the fused route at float32, float64 and
bfloat16 in its direct and merge designs; the C entries' refusals.  The
v3 σ-plane path (``plan=estimate_v3(coo, cfg) | {"route_v": 3}``):
``xch_mul`` and ``xch_route`` (float and bfloat16 builds) against their
plain versions on every call, planes 8, 16 and 32, span 1 and 2, three
pass-2 calls, its spmv against the oracle and captured as a CUDA graph.

Needs an NVIDIA GPU and skips without one.  This file imports no jax, so it
runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_xch.py

Kernel and plain version agree to 1e-5·max|out|: the route kernel sums row
prefixes by warp shuffles and accumulates with atomics in run-dependent
order.
"""
import dataclasses

import numpy as np
import pytest
import torch

from singlespmv_tpu_torch import Config
from singlespmv_tpu_torch.core import COOMatrix, verify_result
from singlespmv_tpu_torch.formats import xch
from singlespmv_tpu_torch.ops import _build
from singlespmv_tpu_torch.ops import xch as ops

pytestmark = pytest.mark.cuda

F32 = Config(format="xch", dtype="float32")
TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _scatter(n, nnz, seed, long_rows=0):
    """Diagonal, local and scattered entries, plus ``long_rows`` rows of
    degree ~2000 that the planner splits into a nested state."""
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
                                   rng.uniform(0.1, 1.0, len(rows)),
                                   sort=True, sum_duplicates=True)


def _state(coo, **fix):
    return xch.convert(coo, F32, plan=xch.estimate(coo, F32) | fix)


def _close(got, want):
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.is_cuda
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= TOL * scale


def _kernels_vs_plain(st, x):
    """Every pass-1 and pass-2 call of the state (and of its nested state)
    through the kernel and its plain version."""
    for a in zip(st.base2, st.val2, st.col2, st.hm2, st.dest2):
        y = lambda: torch.zeros(st.n_row, device=x.device)
        before = ops.xch_fused_rows.launches
        got = ops.xch_fused_rows(*a, x, y(), st.t2, st.merge2)
        assert ops.xch_fused_rows.launches == before + 1
        _close(got, ops.xch_fused_rows_ref(*a, x, y(), st.t2))
    xt = xch.x_table(st, x)
    for w, la, su, va in zip(st.win1, st.lane1, st.sub1, st.val1):
        before = ops.xch_mul.launches
        got = ops.xch_mul(w, la, su, va, xt, st.m1, st.t1)
        assert ops.xch_mul.launches == before + 1
        _close(got, ops.xch_mul_ref(w, la, su, va, xt, st.m1, st.t1))
    prod3 = xch.products(st, xt)
    for *a, ng in zip(st.gids2, st.off2, st.cs2, st.win2, st.lane2, st.sub2,
                      st.hm2, st.sig2, st.idx2, st.chunk_ngrp):
        g = (prod3, ng, st.gb, st.m2, st.t2, st.p_oh)
        before = ops.xch_route4.launches
        got = ops.xch_route4(*a, *g)
        assert ops.xch_route4.launches == before + 1
        _close(got, ops.xch_route4_ref(*a, *g))
    for a in zip(st.base2, st.cs2, st.win2, st.lane2, st.sub2, st.hm2,
                 st.dest2):
        y = lambda: torch.zeros(st.n_row, device=x.device)
        before = ops.xch_route4_rows.launches
        got = ops.xch_route4_rows(*a, prod3, y(), st.m2, st.t2, st.merge2)
        assert ops.xch_route4_rows.launches == before + 1
        _close(got, ops.xch_route4_rows_ref(*a, prod3, y(), st.m2, st.t2))
    if st.long is not None:
        _kernels_vs_plain(st.long, x)


def _calls(st):
    """Pass-2 calls of the state and its nested states."""
    return len(st.base2) + (_calls(st.long) if st.long is not None else 0)


def _verify(coo, st, device, seed=3):
    x = np.random.default_rng(seed).uniform(-1, 1, coo.n_col).astype(
        np.float32)
    xd = torch.from_numpy(x).to(device)
    _kernels_vs_plain(st, xd)
    before = (ops.xch_route4.launches, ops.xch_mul.launches,
              ops.xch_route4_rows.launches, ops.xch_fused_rows.launches)
    y = xch.spmv(st, xd).cpu().numpy()
    assert (ops.xch_route4.launches, ops.xch_mul.launches,
            ops.xch_route4_rows.launches, ops.xch_fused_rows.launches) == (
        *before[:3], before[3] + _calls(st))    # the spmv's route: fused
    ok, det = verify_result(coo, x, y, dtype=np.float32)
    assert ok, det


ROUTES = [
    # kblk, m2, t2, p_oh
    (1, 1, 32, 8),
    (8, 8, 64, 16),
    (16, 24, 128, 32),
    (32, 8, 256, 64),
    (8, 24, 256, 40),
]


@pytest.mark.parametrize("kblk,m2,t2,p_oh", ROUTES)
def test_kernels_match_plain_and_oracle(cuda, kblk, m2, t2, p_oh):
    coo = _scatter(40000, 200000, seed=kblk)
    st = _state(coo, kblk=kblk, kblk_fix=True, m2_fix=m2, t2_fix=t2,
                p_oh_fix=p_oh)
    assert (st.kblk, st.m2, st.t2, st.p_oh) == (kblk, m2, t2, p_oh)
    _verify(coo, st.to(cuda), cuda)


@pytest.mark.parametrize("m1,t1", [(1, 64), (16, 128)])
def test_pass1_windows(cuda, m1, t1):
    coo = _scatter(30000, 150000, seed=m1)
    st = _state(coo, m1_fix=m1, t1_fix=t1, k_slots=128 * 64)
    assert (st.m1, st.t1) == (m1, t1) and st.n_chunks > 2
    _verify(coo, st.to(cuda), cuda)


def test_several_calls_per_pass(cuda, monkeypatch):
    coo = _scatter(60000, 300000, seed=6)
    monkeypatch.setattr(xch, "CHUNK_ROWS", 8 * 64)
    monkeypatch.setattr(xch, "PASS1_CALL_ROWS", 512)
    st = xch.convert(coo, F32)
    assert len(st.win1) > 2 and len(st.gids2) > 1
    _verify(coo, st.to(cuda), cuda)


def test_nested_long_state(cuda):
    coo = _scatter(20000, 60000, seed=11, long_rows=8)
    st = xch.convert(coo, F32)
    assert st.long is not None and st.long.kblk == 1
    moved = st.to(cuda)
    assert moved.long.val1[0].is_cuda and moved.long_rows.is_cuda
    _verify(coo, moved, cuda)


def test_default_plan_and_empty(cuda):
    coo = _scatter(100000, 400000, seed=9)
    _verify(coo, xch.convert(coo, F32).to(cuda), cuda)
    empty = xch.convert(COOMatrix.from_triplets(64, 64, [], [], [],
                                                sort=True), F32).to(cuda)
    y = xch.spmv(empty, torch.ones(64, device=cuda))
    assert y.is_cuda and not y.any()


def _hub_rows(n=40000, seed=12):
    """128 rows of degree 2,000 over a scatter: the nested state's stream
    rows pile run ends onto the same rows, so its route merges."""
    rng = np.random.default_rng(seed)
    rows = np.concatenate([rng.integers(0, n, 120000),
                           np.repeat(rng.choice(n, 128, replace=False), 2000)])
    return COOMatrix.from_triplets(n, n, rows, rng.integers(0, n, len(rows)),
                                   rng.uniform(0.1, 1.0, len(rows)),
                                   sort=True, sum_duplicates=True)


def test_merge_kernel_on_piled_up_run_ends(cuda):
    coo = _hub_rows()
    st = xch.convert(coo, F32)
    assert st.merge2 == 0 and st.long.merge2 == st.long.p_oh * 128
    _verify(coo, st.to(cuda), cuda)


@pytest.mark.parametrize("kblk,m2,t2,p_oh", [r for r in ROUTES
                                             if r[3] <= 24])
def test_merge_kernel_forced(cuda, kblk, m2, t2, p_oh):
    """The merge kernel computes the route's function on any stream whose
    spans fit, scattered ones too."""
    coo = _scatter(40000, 200000, seed=kblk)
    st = _state(coo, kblk=kblk, kblk_fix=True, m2_fix=m2, t2_fix=t2,
                p_oh_fix=p_oh)
    st = dataclasses.replace(st, merge2=p_oh * 128)
    _verify(coo, st.to(cuda), cuda)


def test_launchers_refuse_bad_ranges(cuda):
    lib = _build.load()
    null = [None] * 11
    stream = torch.cuda.current_stream(cuda).cuda_stream
    # H T m kblk p_oh n_grp gb p1
    assert lib.xch_route4_f32(*null, 64, 64, 8, 4, 65, 1, 1024, 64,
                              stream) != 0            # p_oh past 64
    assert lib.xch_route4_f32(*null, 64, 64, 8, 0, 8, 1, 1024, 64,
                              stream) != 0            # kblk 0
    assert lib.xch_route4_f32(*null, 64, 32, 121, 4, 8, 1, 1024, 64,
                              stream) != 0            # window past int8
    assert lib.xch_mul_f32(*null[:6], 96, 64, 8, stream) != 0   # H % T
    assert lib.xch_mul_f32(*null[:6], 0, 64, 8, stream) == 0    # nothing
    # base cs win lane sub hm1 dest prod y | H T m p1 n_y span
    for f in (lib.xch_route4_rows_f32, lib.xch_route4_rows_f64):
        assert f(*null[:9], 64, 64, 121, 64, 100, 0, stream) != 0  # window
        assert f(*null[:9], 96, 64, 8, 64, 100, 0, stream) != 0    # H % T
        assert f(*null[:9], 64, 64, 8, 0, 100, 0, stream) != 0     # p1 0
        assert f(*null[:9], 64, 64, 8, 64, -1, 0, stream) != 0     # n_y < 0
        assert f(*null[:9], 64, 0, 8, 64, 100, 0, stream) != 0     # T 0
        assert f(*null[:9], 64, 64, 8, 64, 100, 100, stream) != 0  # span
        assert f(*null[:9], 64, 64, 8, 64, 100, -128, stream) != 0
        assert f(*null[:9], 0, 64, 8, 64, 100, 0, stream) == 0     # nothing
    # 8 spans of 64 · 128 floats (256 KB) pass the merge kernel's 96 KB
    assert lib.xch_route4_rows_f32(*null[:9], 64, 64, 8, 64, 100, 64 * 128,
                                   stream) != 0


FUSED_TYPES = {"float32": ("launches", 1e-5), "float64": ("launches_f64",
                                                         1e-12),
               "bfloat16": ("launches_bf16", 1e-5)}


@pytest.mark.parametrize("design", ["direct", "merge"])
@pytest.mark.parametrize("dtype", list(FUSED_TYPES))
def test_fused_kernel_against_its_plain_version(cuda, dtype, design):
    """``xch_fused_rows`` against its plain version on every pass-2 call of
    a scattered state and of the nested hub state, in the direct design (a
    reduction a run end) and the merge design (a block's rows summed in
    shared memory first, at the span of p_oh · 128), at each value type."""
    from singlespmv_tpu_torch.core.dtypes import value_tensor

    counter, tol = FUSED_TYPES[dtype]
    cfg = Config(format="xch", dtype=dtype)
    for coo in (_scatter(40000, 200000, seed=3), _hub_rows()):
        st = xch.convert(coo, cfg)
        x = value_tensor(np.random.default_rng(4).uniform(-1, 1, coo.n_col),
                         dtype).to(cuda)
        for s in (st, st.long) if st.long is not None else (st,):
            s = s.to(cuda)
            span = 0 if design == "direct" else s.p_oh * 128
            if span * (8 if dtype == "float64" else 4) * 8 > ops.MERGE_SMEM:
                continue                       # the spans do not fit
            for a in zip(s.base2, s.val2, s.col2, s.hm2, s.dest2):
                y = lambda: torch.zeros(s.n_row, device=cuda,
                                        dtype=ops.acc_dtype(x.dtype))
                before = getattr(ops.xch_fused_rows, counter)
                got = ops.xch_fused_rows(*a, x, y(), s.t2, span)
                torch.cuda.synchronize()
                assert getattr(ops.xch_fused_rows, counter) == before + 1
                want = ops.xch_fused_rows_ref(*a, x, y(), s.t2)
                scale = float(want.abs().max())
                assert float((got - want).abs().max()) <= tol * scale


def test_fused_entries_refuse_bad_ranges(cuda):
    lib = _build.load()
    null = [None] * 7
    stream = torch.cuda.current_stream(cuda).cuda_stream
    # base val2 col2 hm1 dest x y | H T n_y span
    for f in (lib.xch_fused_rows_f32, lib.xch_fused_rows_f64,
              lib.xch_fused_rows_bf16):
        assert f(*null, 96, 64, 100, 0, stream) != 0     # H % T
        assert f(*null, 64, 0, 100, 0, stream) != 0      # T 0
        assert f(*null, 64, 64, -1, 0, stream) != 0      # n_y < 0
        assert f(*null, 64, 64, 100, 100, stream) != 0   # span % 128
        assert f(*null, 64, 64, 100, -128, stream) != 0
        assert f(*null, 64, 64, 100, 64 * 128, stream) != 0   # 8 spans
        assert f(*null, 0, 64, 100, 0, stream) == 0      # nothing


# ------------------------------------------------------- the v3 σ-plane path

V3_PLANS = {   # id → (plan overrides, CHUNK_ROWS or None)
    "default": ({}, None),
    "planes 8 span 2": ({"planes": 8, "span_fix": 2}, None),
    "planes 16 m2 16": ({"planes": 16, "span_fix": 1, "m2_fix": 16}, None),
    "planes 32 span 2": ({"planes": 32, "span_fix": 2, "m1_fix": 8}, None),
    "three calls": ({"planes": 8, "span_fix": 2}, 1024),
}
V3_COUNTERS = {"float32": "launches", "bfloat16": "launches_bf16"}


def _v3_state(coo, dtype, fix, chunk_rows, monkeypatch):
    cfg = Config(format="xch", dtype=dtype)
    with monkeypatch.context() as mp:
        if chunk_rows:
            mp.setattr(xch, "CHUNK_ROWS", chunk_rows)
        st = xch.convert(coo, cfg, plan=xch.estimate_v3(coo, cfg)
                         | {"route_v": 3} | fix)
    assert isinstance(st, xch.XchState)
    return st


@pytest.mark.parametrize("dtype", list(V3_COUNTERS))
@pytest.mark.parametrize("plan", list(V3_PLANS))
def test_v3_kernels_match_plain_and_oracle(cuda, monkeypatch, plan, dtype):
    """The v3 spmv's kernels against their plain versions on every call:
    ``xch_mul`` (each product rounded once at bfloat16) and ``xch_route``
    (its float and bfloat16 builds, float sums into a float out); then the
    spmv against the oracle."""
    from singlespmv_tpu_torch.core.dtypes import to_host, value_tensor

    coo = _scatter(40000, 160000, 3)
    fix, chunk_rows = V3_PLANS[plan]
    st = _v3_state(coo, dtype, fix, chunk_rows, monkeypatch).to(cuda)
    if chunk_rows:
        assert len(st.uids2) == 3
    xh = np.random.default_rng(4).uniform(-1, 1, coo.n_col)
    x = value_tensor(xh, dtype).to(cuda)
    xt = xch.x_table(st, x)
    counter = V3_COUNTERS[dtype]
    for a in zip(st.win1, st.lane1, st.sub1, st.val1):
        before = getattr(ops.xch_mul, counter)
        got = ops.xch_mul(*a, xt, st.m1, st.t1)
        assert getattr(ops.xch_mul, counter) == before + 1
        _close(got.float(), ops.xch_mul_ref(*a, xt, st.m1, st.t1).float())
    prod3 = xch.products(st, xt)
    op = st.span * st.planes
    for a in zip(st.uids2, st.gids2, st.cs2, st.sg0_2, st.sg1_2, st.win2,
                 st.lane2, st.sub2, st.hm2, st.idx2, st.chunk_nb):
        before = getattr(ops.xch_route, counter)
        got = ops.xch_route(*a[:10], prod3, a[10], st.m2, op, st.t2,
                            xch.G_GRP)
        assert getattr(ops.xch_route, counter) == before + 1
        assert got.dtype == torch.float32
        _close(got, ops.xch_route_ref(*a[:10], prod3, a[10], st.m2, op,
                                      st.t2, xch.G_GRP))
    y = xch.spmv(st, x)
    assert y.dtype == x.dtype and y.shape == (coo.n_row,)
    ok, det = verify_result(coo, to_host(x), to_host(y), dtype=dtype)
    assert ok, det


@pytest.mark.parametrize("dtype", list(V3_COUNTERS))
def test_v3_spmv_captures_in_a_graph(cuda, monkeypatch, dtype):
    """The v3 spmv reads no device value on the host: the driver's chained
    runner captures it as a CUDA graph, whose y passes the oracle and lies
    within each row's reorder bound of the eager y."""
    from singlespmv_tpu_torch import formats
    from singlespmv_tpu_torch.core.dtypes import to_host, value_tensor
    from singlespmv_tpu_torch.core.oracle import reorder_bound
    from singlespmv_tpu_torch.harness import driver

    coo = _scatter(40000, 160000, 3)
    fix, chunk_rows = V3_PLANS["three calls"]
    st = _v3_state(coo, dtype, fix, chunk_rows, monkeypatch).to(cuda)
    x = value_tensor(np.random.default_rng(4).uniform(-1, 1, coo.n_col),
                     dtype).to(cuda)
    eager = xch.spmv(st, x)
    y = driver.make_chained_runner(xch.spmv, st, x, name="xch v3",
                                   chain=8)(9)
    torch.cuda.synchronize()
    ok, det = verify_result(coo, to_host(x), to_host(y), dtype=dtype)
    assert ok, det
    cfg = Config(format="xch", dtype=dtype)
    stored = xch.to_coo(st.to("cpu"))
    bound = reorder_bound(stored, to_host(x).astype(np.float64),
                          formats.adds_per_row(st, cfg), "float32", dtype)
    drift = np.abs(to_host(y).astype(np.float64)
                   - to_host(eager).astype(np.float64))
    assert (drift <= bound).all()


def test_v3_route_entries_refuse_bad_ranges(cuda):
    lib = _build.load()
    null = [None] * 11
    stream = torch.cuda.current_stream(cuda).cuda_stream
    # uids cs sg0 sg1 win lane sub hm1 idx prod out
    # | H T m planes pg p1 n_out R | stream
    for f in (lib.xch_route_f32, lib.xch_route_bf16):
        assert f(*null, 96, 64, 1, 8, 8, 64, 8, 64, stream) != 0   # H % T
        assert f(*null, 64, 64, 0, 8, 8, 64, 8, 64, stream) != 0   # m 0
        assert f(*null, 64, 64, 1, 65, 8, 64, 8, 64, stream) != 0  # planes
        assert f(*null, 64, 64, 1, 8, 0, 64, 8, 64, stream) != 0   # pg 0
        assert f(*null, 64, 64, 1, 8, 8, 64, 8, 96, stream) != 0   # R % T
        assert f(*null, 0, 64, 1, 8, 8, 64, 8, 64, stream) == 0    # nothing
