"""Port xch kernels, plain path: ``singlespmv_tpu_torch.ops.xch`` on CPU
tensors against the Pallas xch kernels run in interpret mode, on layouts made
by the reference convert with plans forced through its ``*_fix`` keys.

``xch_mul`` is one product per slot, so the two agree to float32 rounding.
``xch_route4``'s plain version takes the row prefix with ``torch.cumsum``
and routes by ``index_add_`` where the TPU kernel uses triangle and one-hot
matmuls, so sums round in another order: outputs agree to rtol 1e-5 with
atol 1e-5·max|out|.  On the CPU the wrappers run their plain versions and
the launch counters do not move.
"""
import shutil

import numpy as np
import pytest
import torch

from singlespmv_tpu.config import Config
from singlespmv_tpu.core.types import COOMatrix
from singlespmv_tpu.formats import xch as ref_xch
from singlespmv_tpu.ops.pallas.xch import xch_mul as pallas_mul
from singlespmv_tpu.ops.pallas.xch import xch_route4 as pallas_route4
from singlespmv_tpu_torch.ops import _build
from singlespmv_tpu_torch.ops import xch as ops
from test_xch import _mix

F32 = Config(format="xch", dtype="float32")
RTOL = 1e-5


def _ref_state(coo, **fix):
    plan = ref_xch.estimate(coo, F32)
    plan.update(fix)
    return ref_xch.convert(coo, F32, plan=plan)


def long_rows_matrix():
    """8 rows of degree ~2000 over a hyper-sparse scatter: the planner
    splits them into a nested state (``tests/test_xch.py``'s long-row
    case)."""
    rng = np.random.default_rng(11)
    n = 20000
    rows = np.concatenate([rng.integers(0, n, 60000),
                           np.repeat(rng.choice(n, 8, replace=False), 2000)])
    cols = rng.integers(0, n, len(rows))
    return COOMatrix.from_triplets(n, n, rows, cols,
                                   rng.uniform(1, 2, len(rows)), sort=True)


def _mul_args(st, c=0):
    arrs = [np.asarray(getattr(st, f)[c])
            for f in ("win1", "lane1", "sub1", "val1")]
    return arrs, [torch.from_numpy(np.array(a)) for a in arrs]


def _route_args(st, c=0):
    arrs = [np.asarray(getattr(st, f)[c])
            for f in ("gids2", "off2", "cs2", "win2", "lane2", "sub2", "hm2",
                      "sig2", "idx2")]
    return arrs, [torch.from_numpy(np.array(a)) for a in arrs]


def _uniform(shape, seed):
    return np.random.default_rng(seed).uniform(-1.0, 1.0, shape).astype(
        np.float32)


def _assert_close(got, want):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


def _check_mul(st, seed):
    arrs, tens = _mul_args(st)
    x = _uniform((st.cb_pad, 128), seed)
    want = np.asarray(pallas_mul(*arrs, x, st.m1, st.t1))
    before = ops.xch_mul.launches
    got = ops.xch_mul(*tens, torch.from_numpy(x), st.m1, st.t1)
    assert ops.xch_mul.launches == before      # CPU: plain version
    assert got.shape == (st.n_slots1 // 128, 128)
    _assert_close(got.numpy(), want)


def _check_route(st, seed):
    arrs, tens = _route_args(st)
    prod3 = _uniform((st.n_chunks, st.p1, 128), seed)
    n_grp = st.chunk_ngrp[0]
    want = np.asarray(pallas_route4(*arrs, prod3, n_grp, st.gb, st.m2,
                                    st.m2, st.t2, st.p_oh))
    before = ops.xch_route4.launches
    got = ops.xch_route4(*tens, torch.from_numpy(prod3), n_grp, st.gb,
                         st.m2, st.t2, st.p_oh)
    assert ops.xch_route4.launches == before
    assert got.shape == (n_grp * st.gb, 128)
    _assert_close(got.numpy(), want)


@pytest.mark.parametrize("m1,t1", [(1, 64), (8, 128), (16, 64)])
def test_mul_matches_pallas(m1, t1):
    st = _ref_state(_mix(5000, 25000, 0), m1_fix=m1, t1_fix=t1)
    assert (st.m1, st.t1) == (m1, t1) and len(st.win1) == 1
    _check_mul(st, seed=m1)


ROUTES = [
    # m2, kblk, t2, p_oh
    (1, 1, 32, 8),
    (8, 4, 64, 16),
    (8, 16, 64, 24),
    (16, 16, 32, 32),
    (24, 4, 64, 64),
]


@pytest.mark.parametrize("m2,kblk,t2,p_oh", ROUTES)
def test_route4_matches_pallas(m2, kblk, t2, p_oh):
    st = _ref_state(_mix(5000, 25000, 0), m2_fix=m2, t2_fix=t2, kblk=kblk,
                    kblk_fix=True, p_oh_fix=p_oh)
    assert (st.m2, st.kblk, st.t2, st.p_oh) == (m2, kblk, t2, p_oh)
    assert len(st.gids2) == 1
    _check_route(st, seed=kblk)


def test_route4_several_source_chunks():
    """Small chunks: steps gather from several source chunks (cs)."""
    st = _ref_state(_mix(5000, 25000, 0), k_slots=128 * 32, t2_fix=32,
                    kblk=4, kblk_fix=True)
    assert st.n_chunks > 2 and len(np.unique(np.asarray(st.cs2[0]))) > 2
    _check_route(st, seed=5)


def test_nested_long_state_matches_pallas():
    """The nested long-row state: kblk 1 and an out group of 55 blocks."""
    st = ref_xch.convert(long_rows_matrix(), F32)
    sub = st.long
    assert sub is not None and sub.kblk == 1 and sub.gb % 8
    _check_mul(sub, seed=7)
    _check_route(sub, seed=8)
    _check_route(st, seed=9)                  # the main state: two chunks


def test_plain_versions_are_what_cpu_wrappers_run():
    st = _ref_state(_mix(3000, 15000, 3), t2_fix=32)
    _, mt = _mul_args(st)
    x = torch.from_numpy(_uniform((st.cb_pad, 128), 1))
    assert torch.equal(ops.xch_mul(*mt, x, st.m1, st.t1),
                       ops.xch_mul_ref(*mt, x, st.m1, st.t1))
    _, rt = _route_args(st)
    p3 = torch.from_numpy(_uniform((st.n_chunks, st.p1, 128), 2))
    a = (p3, st.chunk_ngrp[0], st.gb, st.m2, st.t2, st.p_oh)
    assert torch.equal(ops.xch_route4(*rt, *a), ops.xch_route4_ref(*rt, *a))


def test_wrappers_check_layout():
    st = _ref_state(_mix(3000, 15000, 3), t2_fix=32, m2_fix=8)
    _, mt = _mul_args(st)
    x = torch.from_numpy(_uniform((st.cb_pad, 128), 1))
    with pytest.raises(TypeError):
        ops.xch_mul(*mt[:3], mt[3].double(), x, st.m1, st.t1)
    with pytest.raises(ValueError):
        ops.xch_mul(*mt, x, st.m1, st.t1 + 1)           # H % T
    with pytest.raises(ValueError):
        ops.xch_mul(*mt, x, 121, st.t1)                 # window past int8
    with pytest.raises(ValueError, match="cuda"):
        ops.xch_mul(*[t.to("meta") for t in mt], x.to("meta"), st.m1, st.t1)
    _, rt = _route_args(st)
    p3 = torch.from_numpy(_uniform((st.n_chunks, st.p1, 128), 2))
    g = (st.chunk_ngrp[0], st.gb)
    ops.xch_route4(*rt, p3, *g, st.m2, st.t2, st.p_oh)
    with pytest.raises(ValueError):
        ops.xch_route4(*rt, p3, *g, st.m2, st.t2, 72)          # p_oh > 64
    with pytest.raises(ValueError):
        ops.xch_route4(*rt, p3, *g, st.m2, st.t2 + 1, st.p_oh)  # H % T
    with pytest.raises(ValueError):
        ops.xch_route4(*rt[:8], rt[8][:, :-1], p3, *g, st.m2, st.t2,
                       st.p_oh)                                 # idx shape
    with pytest.raises(ValueError):
        ops.xch_route4(*rt, p3.view(-1, 128), *g, st.m2, st.t2,
                       st.p_oh)                                 # prod3 rank


def test_sources_digest_covers_headers(tmp_path):
    """The build's name hashes every source and header under csrc/, so an
    edit to a header that both kernels' files include rebuilds them."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    assert {p.name for p in csrc.iterdir()} >= {"slab.cu", "xch.cu",
                                                 "bucket.cu",
                                                 "stream_row.cuh"}
    base = _build.sources_digest(str(csrc))
    assert base == _build.sources_digest()      # names are relative
    header = csrc / "stream_row.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    edited = _build.sources_digest(str(csrc))
    assert edited != base
    (csrc / "extra.h").write_text("#pragma once\n")
    with_extra = _build.sources_digest(str(csrc))
    assert with_extra not in (base, edited)
    (csrc / "notes.txt").write_text("not a source")
    assert _build.sources_digest(str(csrc)) == with_extra
    assert set(_build.SIGNATURES) == {
        "slab_spmv_f32", "slab_spmv_f64", "slab_spmv_blk_f32", "slab_spmm_f32",
        "slab_spmv_rows_f32", "slab_spmv_rows_f64",
        "xch_mul_f32", "xch_mul_f64", "xch_route4_f32", "xch_route4_f64",
        "xch_route4_rows_f32", "xch_route4_rows_f64", "xch_mul_panel_f32",
        "xch_route4_panel_f32",
        "block_gather_mul_f32", "bucket_reduce_f32", "bucket_rows_f32",
        "bucket_reduce_grouped_f32", "lane_unpermute_f32",
        "segmented_scan_tiles_f32", "segmented_scan_tiles_f64",
        "block_gather_scan_f32", "block_gather_scan_f64", "xch_route_f32",
        "probe_gather_f32", "probe_gather_bf16", "probe_onehot_f32",
        "probe_dynslice_f32", "probe_segscan_f32", "probe_transpose_f32",
        "probe_slab_f32",
        # the bfloat16 builds of the spmv path's kernels (ROADMAP A.10)
        "slab_spmv_rows_bf16", "xch_mul_bf16", "xch_route4_rows_bf16",
        "block_gather_mul_bf16", "bucket_rows_bf16",
        "segmented_scan_tiles_bf16", "block_gather_scan_bf16",
        # and of the SpMM panel kernels (ROADMAP A.10b)
        "slab_spmm_bf16", "xch_mul_panel_bf16", "xch_route4_panel_bf16",
        # the bucket engine's fused stage A + B and ellg's passes
        "bucket_fused_rows_f32", "bucket_fused_rows_bf16",
        "ellg_rows_f32", "ellg_rows_bf16",
        # xch's fused pass 1 + pass 2
        "xch_fused_rows_f32", "xch_fused_rows_f64", "xch_fused_rows_bf16",
        # the v3 σ-plane route on a bfloat16 grid
        "xch_route_bf16"}
