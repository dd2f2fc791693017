"""The parallel layer on the card: DistXch, DistSpMV and HaloSpMV on a local
mesh on the card against the same operators on a local mesh on the CPU
(the kernels' plain versions), call by call, each y through the float64
oracle; CUDA graphs of a DistXch and a HaloSpMV step; the scaling
harness's graph-timed points; and the ``dist`` backend on NCCL
at world size 1 in a rank process (``tests/torch_dist_workers.py``).

Needs an NVIDIA GPU and skips without one, but for the check that a mesh
on the card refuses to run without one.  This file imports no jax:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_parallel.py

The card's y and the plain versions' agree within 1e-5·max|y| (float32)
and 1e-12·max|y| (float64): the kernels add run totals in warp order
(ROADMAP C.7).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from singlespmv_tpu_torch import Config
from singlespmv_tpu_torch.core import COOMatrix, verify_result
from singlespmv_tpu_torch.data.generators import generate, powerlaw
from singlespmv_tpu_torch.harness.driver import make_chained_runner
from singlespmv_tpu_torch.ops import segscan, xch as xops
from singlespmv_tpu_torch.parallel import (DistSpMV, DistXch, HaloSpMV,
                                           make_mesh)

import torch_dist_workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = {np.float32: 1e-5, np.float64: 1e-12}
XCH = Config(format="xch", dtype="float32")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def test_a_card_mesh_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh((("row", 2),), **kw)


def _pair(convert, coo, shape, cfg, **kw):
    """The operator on a card mesh and on a CPU mesh."""
    return (convert(coo, cfg, make_mesh(shape, device="cuda"), **kw),
            convert(coo, cfg, make_mesh(shape, device="cpu"), **kw))


def _held(coo, card, plain, x, dtype):
    """The card's y against the plain versions' and the oracle."""
    y = card(x).cpu().numpy()
    want = plain(x).numpy()
    assert np.abs(y - want).max() <= REL[dtype] * np.abs(want).max()
    ok, det = verify_result(coo, x, y, dtype=dtype)
    assert ok, det
    return y


def _x(coo, dtype):
    return np.random.default_rng(5).uniform(-1, 1, coo.n_col).astype(dtype)


def _scattered(n, nnz, seed):
    rng = np.random.default_rng(seed)
    return COOMatrix.from_triplets(n, n, rng.integers(0, n, nnz),
                                   rng.integers(0, n, nnz),
                                   rng.uniform(-1, 1, nnz),
                                   sum_duplicates=True)


@pytest.mark.cuda
@pytest.mark.parametrize("coo_of,R,mode", [
    (lambda: powerlaw(20000, 240000, seed=4), 8, "allgather"),
    (lambda: generate("band", 65536, 9, seed=2), 8, "ring"),
    (lambda: _scattered(60000, 500000, 1), 4, "allgather")])
def test_dist_xch_on_the_card(cuda, coo_of, R, mode):
    coo = coo_of()
    card, plain = _pair(DistXch.convert, coo, (("row", R),), XCH)
    assert card.x_mode == mode
    before = (xops.xch_fused_rows.launches, xops.xch_mul.launches,
              xops.xch_route4_rows.launches)
    _held(coo, card, plain, _x(coo, np.float32), np.float32)
    # the step runs the fused route, one launch a pass-2 call of a shard
    assert xops.xch_fused_rows.launches == before[0] + sum(
        len(st.base2) for st in card.states)
    assert (xops.xch_mul.launches, xops.xch_route4_rows.launches) == \
        before[1:]


@pytest.mark.cuda
@pytest.mark.parametrize("n_cols", [8, 20])
def test_dist_xch_spmm_on_the_card(cuda, n_cols):
    coo = powerlaw(20000, 240000, seed=6)
    card, plain = _pair(DistXch.convert, coo, (("row", 4),), XCH)
    X = np.random.default_rng(2).uniform(-1, 1, (coo.n_col, n_cols)).astype(
        np.float32)
    panels = xops.xch_mul_panel.launches
    Y, want = card.spmm(X).cpu().numpy(), plain.spmm(X).numpy()
    assert (xops.xch_mul_panel.launches > panels) == (n_cols <= 16)
    assert np.abs(Y - want).max() <= REL[np.float32] * np.abs(want).max()
    for b in range(n_cols):
        ok, det = verify_result(coo, X[:, b], Y[:, b], dtype=np.float32)
        assert ok, det


@pytest.mark.cuda
def test_dist_xch_multi_call_shards_on_the_card(cuda, monkeypatch):
    from singlespmv_tpu_torch.formats import xch as xch_fmt

    monkeypatch.setattr(xch_fmt, "CHUNK_ROWS", 9 * 64)
    monkeypatch.setattr(xch_fmt, "PASS1_CALL_ROWS", 512)
    coo = _scattered(40000, 200000, 3)
    card, plain = _pair(DistXch.convert, coo, (("row", 2),), XCH)
    assert all(len(st.win1) > 1 and len(st.gids2) > 1 for st in card.states)
    _held(coo, card, plain, _x(coo, np.float32), np.float32)


@pytest.mark.cuda
def test_a_dist_xch_step_captured_as_a_graph(cuda):
    coo = generate("band", 65536, 9, seed=2)
    op = DistXch.convert(coo, XCH, make_mesh((("row", 8),), device="cuda"))
    x = torch.from_numpy(_x(coo, np.float32)).to(cuda)
    run_n = make_chained_runner(lambda o, a: o.step(a), op, x, name="distxch")
    y = run_n(3).cpu().numpy()
    ok, det = verify_result(coo, x.cpu().numpy(), y, dtype=np.float32)
    assert ok, det


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape,kw", [
    ((("row", 2), ("col", 2)), {}),
    ((("row", 4),), {"col_axis": None, "gather_x": True})])
def test_dist_spmv_on_the_card(cuda, dtype, shape, kw):
    coo = powerlaw(30000, 400000, seed=7)
    cfg = Config(format="ss", dtype=np.dtype(dtype).name)
    card, plain = _pair(DistSpMV.convert, coo, shape, cfg, **kw)
    scans = segscan.segmented_scan_tiles.launches + \
        segscan.segmented_scan_tiles.launches_f64
    _held(coo, card, plain, _x(coo, dtype), dtype)
    assert segscan.segmented_scan_tiles.launches + \
        segscan.segmented_scan_tiles.launches_f64 == scans + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("coo_of,mode", [
    (lambda: generate("band", 20000, 9, seed=2), "rounds"),
    (lambda: powerlaw(20000, 200000, seed=3), "boundary")])
def test_halo_spmv_on_the_card(cuda, dtype, coo_of, mode):
    coo = coo_of()
    cfg = Config(format="ss", dtype=np.dtype(dtype).name)
    card, plain = _pair(HaloSpMV.convert, coo, (("row", 4),), cfg,
                        mode=mode)
    assert card.mode == mode
    assert (card.exchange_elems, card.n_collectives) == (
        plain.exchange_elems, plain.n_collectives)
    _held(coo, card, plain, _x(coo, dtype), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("coo_of,mode", [
    (lambda: generate("band", 65536, 9, seed=2), "rounds"),
    (lambda: powerlaw(20000, 200000, seed=3), "boundary")])
def test_a_halo_spmv_step_captured_as_a_graph(cuda, coo_of, mode):
    # the exchange on a second stream is forked from and joined to the
    # captured one, so the chain is one graph and its y the eager step's
    coo = coo_of()
    op = HaloSpMV.convert(coo, Config(format="ss", dtype="float32"),
                          make_mesh((("row", 4),), device="cuda"), mode=mode)
    x = torch.from_numpy(_x(coo, np.float32)).to(cuda)
    run_n = make_chained_runner(lambda o, a: o.step(a), op, x, name="halo")
    y, want = run_n(3).cpu().numpy(), op.step(x).cpu().numpy()
    assert np.abs(y - want).max() <= REL[np.float32] * np.abs(want).max()
    ok, det = verify_result(coo, x.cpu().numpy(), y, dtype=np.float32)
    assert ok, det


@pytest.mark.cuda
def test_scaling_points_timed_on_the_card(cuda):
    from singlespmv_tpu_torch.parallel.bench import strong_scaling

    pts = strong_scaling(generate("band", 65536, 9, seed=4), limit=4,
                         device="cuda")
    assert [p.n_devices for p in pts] == [1, 2, 4]
    assert all(0 < p.seconds < 1e-2 and np.isfinite(p.efficiency)
               for p in pts)


@pytest.mark.cuda
def test_nccl_at_world_size_one(cuda, tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, NCCL_SOCKET_IFNAME="lo",
               NCCL_IB_DISABLE="1")
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "tests", "torch_dist_workers.py"),
         "0", "1", str(tmp_path / "init"), str(tmp_path), "nccl"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    got = np.load(tmp_path / "rank0.npz")
    assert bool(got["size_refused"])
    for name, make in torch_dist_workers.cases(1).items():
        op, x = make(lambda s: make_mesh(s, device="cpu"))
        want = op(x).numpy()
        dtype = want.dtype.type
        assert np.abs(got[name] - want).max() <= \
            REL[dtype] * np.abs(want).max(), name
