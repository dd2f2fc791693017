"""The port's parallel layer (``singlespmv_tpu_torch/parallel/``) against the
reference's (``singlespmv_tpu/parallel/``) on the CPU.

Each case converts one COO, made with numpy from a seed, with the
reference's operator on its 8 virtual CPU devices (Pallas in interpret
mode) and with the port's on a ``local`` mesh on the CPU (the kernels'
plain versions): the same partitions, plans, stacked streams, layout
arrays and exchange volumes, and y within 2e-5·max|y| (float32) or
1e-12·max|y| (float64) of the reference's and through the oracle's
``verify_result``.  The reference's interpret-mode DistXch costs seconds a
run, so its y is taken on a few cases and its layout on the rest.  The
``dist`` backend runs in gloo rank processes (``tests/torch_dist_workers.py``,
which import only the port), at world sizes 2 and 4, and each of their y
equals the local mesh's bit for bit, but where a ``psum`` adds more than
two shards (all_reduce's order is the backend's).
"""
import contextlib
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from singlespmv_tpu.config import Config
from singlespmv_tpu.core.types import COOMatrix
from singlespmv_tpu.data.fixtures import fixture_10x10
from singlespmv_tpu.data.generators import generate, powerlaw
from singlespmv_tpu.parallel import DistSpMV as RefDistSpMV
from singlespmv_tpu.parallel import DistXch as RefDistXch
from singlespmv_tpu.parallel import HaloSpMV as RefHaloSpMV
from singlespmv_tpu.parallel import make_mesh as ref_mesh
from singlespmv_tpu.parallel import partition_rows_balanced as ref_partition
from singlespmv_tpu_torch.core import verify_result
from singlespmv_tpu_torch.parallel import (DistSpMV, DistXch, HaloSpMV,
                                           make_mesh, partition_rows_balanced)
from singlespmv_tpu_torch.parallel.bench import (mesh_sizes, report,
                                                 strong_scaling, weak_scaling)
from singlespmv_tpu_torch.parallel.dryrun import dryrun_multichip
from torch_parity import port_cfg, port_coo

import torch_dist_workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SS64 = Config(format="ss", dtype="float64", segment_width=128)
SS32 = Config(format="ss", dtype="float32", segment_width=128)
XCH = Config(format="xch", dtype="float32")
REL = {np.float32: 2e-5, np.float64: 1e-12}
SPAWN_TIMEOUT_S = 120


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


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """torch on one thread in each test, put back after it: the suite's
    workers share the machine's cores, and the plain versions' many small
    operations, each a parallel region on every core, then wait on each
    other (DistXch's ring case took 49 s instead of 3 against 6 busy
    processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def pmesh(shape):
    return make_mesh(shape, device="cpu")


def x_for(coo, dtype, seed=5):
    return np.random.default_rng(seed).uniform(-1, 1, coo.n_col).astype(
        dtype)


def held(coo, x, y, dtype, y_ref=None):
    """y (the port's, a tensor) within REL of the reference's y and through
    the oracle's verify_result."""
    y = y.numpy()
    assert y.shape == (coo.n_row,) and y.dtype == dtype
    if y_ref is not None:
        y_ref = np.asarray(y_ref)
        scale = max(float(np.abs(y_ref).max()), 1e-30)
        assert np.abs(y - y_ref).max() <= REL[dtype] * scale
    ok, det = verify_result(port_coo(coo), x, y, dtype=dtype)
    assert ok, det
    return y


def rand_coo(n_row, n_col, nnz, seed):
    rng = np.random.default_rng(seed)
    return COOMatrix.from_triplets(
        n_row, n_col, rng.integers(0, n_row, nnz), rng.integers(0, n_col, nnz),
        rng.uniform(-1, 1, nnz), sum_duplicates=True)


# ------------------------------------------------------------------- mesh

def test_local_collectives():
    mesh = pmesh((("row", 2), ("col", 2)))
    parts = [torch.full((2,), float(s)) for s in range(4)]
    g = mesh.all_gather(parts, "row")
    assert [t.tolist() for t in g] == [[0, 0, 2, 2], [1, 1, 3, 3],
                                       [0, 0, 2, 2], [1, 1, 3, 3]]
    assert [t.tolist() for t in mesh.psum(parts, "col")] == [[1, 1], [1, 1],
                                                            [5, 5], [5, 5]]
    # a partial permutation along "col": shard (i, 1) gets (i, 0)'s part,
    # (i, 0) receives nothing and gets zeros
    p = mesh.ppermute(parts, [(0, 1)], "col")
    assert [t.tolist() for t in p] == [[0, 0], [0, 0], [0, 0], [2, 2]]
    assert mesh.all_gather(parts, "depth") == parts


def test_make_mesh_refuses_what_it_cannot_hold():
    with pytest.raises(ValueError):
        make_mesh((("row", 16),), device="cpu")
    with pytest.raises(RuntimeError):
        make_mesh((("row", 2),), device="cpu", backend="dist")
    with pytest.raises(ValueError):
        pmesh((("row", 2),)).ppermute([torch.zeros(1)] * 2,
                                      [(0, 1), (1, 1)], "row")


# ----------------------------------------------------------------- DistSpMV

@pytest.mark.parametrize("coo,n", [
    (powerlaw(100, 1500, seed=3), 4), (powerlaw(256, 8000, seed=4), 8),
    (fixture_10x10(), 3)], ids=["pl100-4", "pl256-8", "10x10-3"])
def test_partition_rows_balanced_is_the_references(coo, n):
    np.testing.assert_array_equal(partition_rows_balanced(port_coo(coo), n),
                                  ref_partition(coo, n))


SPMV_CASES = {
    "row": (lambda: powerlaw(200, 3000, seed=6), (("row", 8),),
            dict(col_axis=None)),
    "row_col": (lambda: powerlaw(200, 3000, seed=7),
                (("row", 4), ("col", 2)), {}),
    "col_only": (lambda: generate("unbalance", 64, seed=8),
                 (("row", 1), ("col", 8)), {}),
    "gather_x": (lambda: generate("band", 96, 5, seed=9), (("row", 8),),
                 dict(col_axis=None, gather_x=True)),
    "fixture": (fixture_10x10, (("row", 2), ("col", 2)), {}),
    "rectangular": (lambda: rand_coo(60, 150, 900, 0),
                    (("row", 4), ("col", 2)), {}),
    # the default col axis on a 1-D row mesh: no col axis, no psum
    "default_col_axis": (lambda: powerlaw(300, 5000, seed=31),
                         (("row", 8),), {}),
}


@pytest.mark.parametrize("dtype,case", [(np.float64, c) for c in SPMV_CASES]
                         + [(np.float32, "row_col"),
                            (np.float32, "gather_x")])
def test_dist_spmv(case, dtype):
    make, shape, kw = SPMV_CASES[case]
    coo = make()
    cfg = SS64 if dtype == np.float64 else SS32
    ref = RefDistSpMV.convert(coo, cfg, ref_mesh(shape), **kw)
    op = DistSpMV.convert(port_coo(coo), port_cfg(cfg), pmesh(shape), **kw)
    assert (op.R, op.C, op.rows_per, op.cols_per) == (
        ref.R, ref.C, ref.rows_per, ref.cols_per)
    np.testing.assert_array_equal(op.perm.reshape(-1), np.asarray(ref.perm))
    for f in ("col", "val", "heads"):
        np.testing.assert_array_equal(
            getattr(op.streams, f).numpy(),
            np.asarray(getattr(ref, f)).astype(
                getattr(op.streams, f).numpy().dtype), err_msg=f)
    x = x_for(coo, dtype)
    held(coo, x, op(x), dtype, ref(x))


def test_gather_x_needs_a_row_mesh():
    coo = powerlaw(64, 400, seed=1)
    with pytest.raises(ValueError, match="gather_x"):
        RefDistSpMV.convert(coo, SS64, ref_mesh((("row", 4), ("col", 2))),
                            gather_x=True)
    with pytest.raises(ValueError, match="gather_x"):
        DistSpMV.convert(port_coo(coo), port_cfg(SS64),
                         pmesh((("row", 4), ("col", 2))), gather_x=True)


def test_dist_spmm_columns_are_the_spmv():
    coo = powerlaw(200, 3000, seed=6)
    shape = (("row", 4), ("col", 2))
    op = DistSpMV.convert(port_coo(coo), port_cfg(SS64), pmesh(shape))
    X = np.random.default_rng(2).uniform(-1, 1, (coo.n_col, 3))
    Y = op.spmm(X).numpy()
    Y_ref = np.asarray(RefDistSpMV.convert(coo, SS64, ref_mesh(shape)).spmm(X))
    for b in range(3):
        np.testing.assert_array_equal(Y[:, b], op(X[:, b]).numpy())
        held(coo, X[:, b], torch.from_numpy(Y[:, b]), np.float64, Y_ref[:, b])


def test_dist_spmv_from_reference():
    coo = powerlaw(200, 3000, seed=7)
    shape = (("row", 2), ("col", 2))
    ref = RefDistSpMV.convert(coo, SS32, ref_mesh(shape))
    arrays = {f: np.asarray(getattr(ref, f)) for f in (
        "col", "val", "heads", "end_pos", "rank_rows", "perm")}
    arrays.update({f: getattr(ref, f) for f in (
        "n_row", "n_col", "nnz", "rows_per", "cols_per", "gather_x")})
    op = DistSpMV.from_reference(arrays, port_cfg(SS32), pmesh(shape))
    own = DistSpMV.convert(port_coo(coo), port_cfg(SS32), pmesh(shape))
    x = x_for(coo, np.float32)
    y = held(coo, x, op(x), np.float32, ref(x))
    np.testing.assert_array_equal(y, own(x).numpy())


# ----------------------------------------------------------------- HaloSpMV

def _block_diagonal():
    n, rng = 512, np.random.default_rng(7)
    rows = np.repeat(np.arange(n), 8)
    cols = (rows // 64) * 64 + rng.integers(0, 64, rows.size)
    return COOMatrix.from_triplets(n, n, rows, cols,
                                   rng.uniform(-1, 1, rows.size),
                                   sum_duplicates=True)


HALO_CASES = {
    "band_auto": (lambda: generate("band", 512, 8, seed=2), "auto"),
    "scattered_merged": (lambda: powerlaw(500, 9000, seed=3), "auto"),
    "fully_local": (_block_diagonal, "auto"),
    "rectangular": (lambda: rand_coo(300, 700, 5000, 11), "auto"),
    "random_rounds": (lambda: generate("random", 512, 8, seed=9), "rounds"),
    "band_boundary": (lambda: generate("band", 512, 8, seed=2), "boundary"),
}


@pytest.mark.parametrize("case", list(HALO_CASES))
def test_halo_spmv(case):
    make, mode = HALO_CASES[case]
    coo = make()
    mesh = (("row", 8),)
    ref = RefHaloSpMV.convert(coo, SS64, ref_mesh(mesh), mode=mode)
    op = HaloSpMV.convert(port_coo(coo), port_cfg(SS64), pmesh(mesh),
                          mode=mode)
    for f in ("mode", "rounds", "bnd_len", "balanced", "merged", "rows_per",
              "xs", "local_nnz", "halo_nnz", "exchange_elems",
              "n_collectives"):
        assert getattr(op, f) == getattr(ref, f), f
    for mine, theirs in ((op.local, ref.local_state),
                         (op.halo, ref.halo_state)):
        for f in ("col", "val", "heads"):
            np.testing.assert_array_equal(
                getattr(mine, f).numpy(),
                np.asarray(theirs[f]).astype(getattr(mine, f).numpy().dtype))
    for mine, theirs in zip(op.send_idx, ref.send_idx):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    x = x_for(coo, np.float64)
    held(coo, x, op(x), np.float64, ref(x))


def test_halo_modes_all_occur():
    modes = {HaloSpMV.convert(port_coo(make()), port_cfg(SS64),
                              pmesh((("row", 8),)), mode=m).mode
             for make, m in HALO_CASES.values()}
    assert modes == {"rounds", "boundary", "none"}


def test_halo_spmv_from_reference():
    coo = generate("band", 512, 8, seed=2)
    mesh = (("row", 8),)
    ref = RefHaloSpMV.convert(coo, SS64, ref_mesh(mesh), mode="rounds")
    arrays = {f: getattr(ref, f) for f in (
        "n_row", "n_col", "nnz", "rows_per", "xs", "mode", "balanced",
        "merged", "rounds", "bnd_len", "local_nnz", "halo_nnz")}
    arrays.update(
        local_state={k: np.asarray(v) for k, v in ref.local_state.items()},
        halo_state={k: np.asarray(v) for k, v in ref.halo_state.items()},
        send_idx=tuple(np.asarray(a) for a in ref.send_idx),
        perm=np.asarray(ref.perm))
    op = HaloSpMV.from_reference(arrays, port_cfg(SS64), pmesh(mesh))
    own = HaloSpMV.convert(port_coo(coo), port_cfg(SS64), pmesh(mesh),
                           mode="rounds")
    x = x_for(coo, np.float64)
    y = held(coo, x, op(x), np.float64, ref(x))
    np.testing.assert_array_equal(y, own(x).numpy())
    assert (op.exchange_elems, op.n_collectives) == (
        ref.exchange_elems, ref.n_collectives)


# ------------------------------------------------------------------ DistXch

XCH_SCALARS = ("row0s", "rows_per", "ng", "m1", "m2", "t1", "t2", "kblk",
               "p_oh", "gb", "cb_pad", "x_mode", "n_rounds")
XCH_ARRAYS = ("win1", "lane1", "sub1", "val1", "gids", "off", "win2",
              "lane2", "sub2", "hm2", "sig2", "idx2", "vis")


def shard_arrays(st):
    """A port shard's layout under the reference's stacked names."""
    return dict(win1=st.win1[0], lane1=st.lane1[0], sub1=st.sub1[0],
                val1=st.val1[0], gids=st.gids2[0], off=st.off2[0],
                win2=st.win2[0], lane2=st.lane2[0], sub2=st.sub2[0],
                hm2=st.hm2[0], sig2=st.sig2[0], idx2=st.idx2[0],
                vis=st.vis_gids)


def xch_pair(coo, R):
    """The reference's and the port's DistXch on ``coo`` at R shards, the
    layout scalars equal and every port shard's arrays the unpadded prefix
    of the reference's stacked ones."""
    ref = RefDistXch.convert(coo, XCH, ref_mesh((("row", R),)))
    op = DistXch.convert(port_coo(coo), port_cfg(XCH), pmesh((("row", R),)))
    for k in XCH_SCALARS:
        assert getattr(op, k) == getattr(ref, k), k
    assert len(op.states) == R
    for r, st in enumerate(op.states):
        assert (len(st.win1), len(st.gids2)) == (1, 1)
        for name, a in shard_arrays(st).items():
            a, want = a.numpy(), np.asarray(ref.arrays[name][r])
            want = want[:, : a.shape[1]] if name == "idx2" \
                else want[: a.shape[0]]
            np.testing.assert_array_equal(a, want, err_msg=f"{r} {name}")
    return ref, op


@pytest.mark.parametrize("R,run_ref", [(1, False), (2, False), (8, True)])
def test_dist_xch_layout_and_y(R, run_ref):
    # at R 8 the 20,000 rows hold 3 out-group grains: 5 shards are empty
    coo = powerlaw(6000, 40000, seed=4) if R < 8 else \
        powerlaw(20000, 60000, seed=4)
    ref, op = xch_pair(coo, R)
    if R == 8:
        assert op.sub_nnz[3:] == (0,) * 5
    x = x_for(coo, np.float32)
    held(coo, x, op(x), np.float32, ref(x) if run_ref else None)


def test_dist_xch_empty_shards():
    # rows concentrated in the first tenth: the upper shards hold nothing
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 3000, 40000)
    coo = COOMatrix.from_triplets(30000, 30000, rows,
                                  rng.integers(0, 30000, 40000),
                                  rng.uniform(1, 2, 40000), sort=True)
    ref, op = xch_pair(coo, 4)
    assert 0 in op.sub_nnz
    x = x_for(coo, np.float32)
    held(coo, x, op(x), np.float32)


def test_dist_xch_skewed_cuts():
    # the dense head gets a narrower span than the sparse tail
    rng = np.random.default_rng(1)
    n = 65536
    rows = np.concatenate([rng.integers(0, n // 8, 60000),
                           rng.integers(n // 8, n, 20000)])
    coo = COOMatrix.from_triplets(n, n, rows, rng.integers(0, n, rows.size),
                                  rng.uniform(1, 2, rows.size),
                                  sum_duplicates=True)
    ref, op = xch_pair(coo, 4)
    spans = np.diff(list(op.row0s) + [coo.n_row])
    assert spans[0] < spans[-1]
    x = x_for(coo, np.float32)
    held(coo, x, op(x), np.float32)


def test_dist_xch_ring_equals_allgather_bit_for_bit():
    coo = generate("band", 40000, 5, seed=2)
    ref, op = xch_pair(coo, 8)
    assert op.x_mode == "ring" and sum(op.n_rounds) <= 3
    x = x_for(coo, np.float32)
    y = held(coo, x, op(x), np.float32)
    gathered = dataclasses.replace(op, x_mode="allgather")
    np.testing.assert_array_equal(gathered(x).numpy(), y)
    X = np.random.default_rng(3).uniform(-1, 1, (coo.n_col, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(gathered.spmm(X).numpy(),
                                  op.spmm(X).numpy())


def test_dist_xch_scattered_takes_allgather():
    coo = powerlaw(20000, 60000, seed=4)
    ref = RefDistXch.convert(coo, XCH, ref_mesh((("row", 8),)))
    op = DistXch.convert(port_coo(coo), port_cfg(XCH), pmesh((("row", 8),)))
    assert op.x_mode == ref.x_mode == "allgather"


@pytest.mark.parametrize("n_cols", [2, 20])
def test_dist_xch_spmm(n_cols):
    """B 2 through the panel kernels' plain versions (against the
    reference's spmm), B 20 through the column loop."""
    coo = powerlaw(6000, 40000, seed=6)
    op = DistXch.convert(port_coo(coo), port_cfg(XCH), pmesh((("row", 4),)))
    X = np.random.default_rng(2).uniform(-1, 1, (coo.n_col, n_cols)).astype(
        np.float32)
    Y = op.spmm(X).numpy()
    Y_ref = None
    if n_cols == 2:
        ref = RefDistXch.convert(coo, XCH, ref_mesh((("row", 4),)))
        Y_ref = np.asarray(ref.spmm(X))
    for b in range(n_cols):
        held(coo, X[:, b], torch.from_numpy(Y[:, b]), np.float32,
             None if Y_ref is None else Y_ref[:, b])


def test_dist_xch_multi_call_shard_the_reference_refuses(monkeypatch):
    """Kernel calls capped at 9 pass-2 steps and 512 pass-1 rows: the
    reference refuses the shards, the port runs their several calls."""
    import singlespmv_tpu.formats.xch as ref_xch_fmt
    import singlespmv_tpu_torch.formats.xch as xch_fmt

    coo = rand_coo(40000, 40000, 200000, 3)
    monkeypatch.setattr(ref_xch_fmt, "CHUNK_ROWS", 9 * 64)
    monkeypatch.setattr(xch_fmt, "CHUNK_ROWS", 9 * 64)
    monkeypatch.setattr(xch_fmt, "PASS1_CALL_ROWS", 512)
    with pytest.raises(ValueError, match="multiple pallas calls"):
        RefDistXch.convert(coo, XCH, ref_mesh((("row", 2),)))
    op = DistXch.convert(port_coo(coo), port_cfg(XCH), pmesh((("row", 2),)))
    assert all(len(st.win1) > 1 and len(st.gids2) > 1 for st in op.states)
    x = x_for(coo, np.float32)
    held(coo, x, op(x), np.float32)


def test_dist_xch_runs_float32_only():
    coo = powerlaw(2000, 9000, seed=1)
    with pytest.raises(ValueError, match="float32"):
        DistXch.convert(port_coo(coo), port_cfg(XCH.replace(dtype="float64")),
                        pmesh((("row", 2),)))


# --------------------------------------------------- scaling and the dryrun

def test_mesh_sizes():
    assert mesh_sizes(8) == [1, 2, 4, 8]
    assert mesh_sizes(1) == [1]


def test_weak_scaling_runs():
    pts = weak_scaling(lambda n: port_coo(powerlaw(64 * n, 900 * n, seed=n)),
                       port_cfg(SS64), loop=2, limit=4, device="cpu")
    assert [p.n_devices for p in pts] == [1, 2, 4]
    assert pts[0].efficiency == 1.0
    assert all(p.nnz_per_s > 0 for p in pts)
    txt = report(pts)
    assert "eff%" in txt and len(txt.splitlines()) == 4


def test_strong_scaling_runs():
    pts = strong_scaling(port_coo(powerlaw(256, 4000, seed=3)),
                         port_cfg(SS64), loop=2, limit=2, device="cpu")
    assert [p.n_devices for p in pts] == [1, 2]
    assert pts[0].efficiency == 1.0


def test_dryrun_multichip():
    dryrun_multichip(8, device="cpu")


# ------------------------------------------------ the dist backend on gloo

@pytest.fixture(scope="module")
def gloo_runs(tmp_path_factory):
    """{world: [each rank's results]} of the gloo ranks at world sizes 2
    and 4, all started at once; each spawn has its own timeout."""
    env = dict(os.environ, PYTHONPATH=REPO, GLOO_SOCKET_IFNAME="lo",
               OMP_NUM_THREADS="1")
    procs = {}
    for world in (2, 4):
        out = tmp_path_factory.mktemp(f"gloo{world}")
        procs[world] = (out, [subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests",
                                          "torch_dist_workers.py"),
             str(r), str(world), str(out / "init"), str(out)],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(world)])
    res = {}
    try:
        for world, (out, ps) in procs.items():
            for r, p in enumerate(ps):
                try:
                    _, err = p.communicate(timeout=SPAWN_TIMEOUT_S)
                except subprocess.TimeoutExpired:
                    pytest.fail(f"gloo rank {r} of {world} hung")
                assert p.returncode == 0, err[-3000:]
            res[world] = [dict(np.load(out / f"rank{r}.npz"))
                          for r in range(world)]
    finally:
        for _, ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return res


GLOO_CASES = [(w, c) for w in (2, 4) for c in torch_dist_workers.cases(w)]


@pytest.mark.parametrize("world,case", GLOO_CASES,
                         ids=[f"{w}-{c}" for w, c in GLOO_CASES])
def test_gloo_ranks_equal_the_local_mesh(gloo_runs, world, case):
    op, x = torch_dist_workers.cases(world)[case](pmesh)
    y = op(x).numpy()
    if case == "xch_ring":
        assert op.x_mode == "ring"
    ranks = gloo_runs[world]
    for r in ranks:
        if case == "spmv_col" and world > 2:
            # a psum of four shards adds in all_reduce's order
            np.testing.assert_allclose(r[case], y, rtol=0,
                                       atol=1e-12 * np.abs(y).max())
        else:
            np.testing.assert_array_equal(r[case], y)
    if case == "xch_ring":
        assert all(str(r["xch_ring_mode"]) == "ring" for r in ranks)


@pytest.mark.parametrize("world", [2, 4])
def test_gloo_ranks_refuse_a_mesh_of_another_size_and_stay_alone(gloo_runs,
                                                                 world):
    for r in gloo_runs[world]:
        assert bool(r["size_refused"])
        assert str(r["foreign_modules"]) == ""
