"""The unit routes' plain versions and the host side of their kernels'
schedule, on the CPU: ``ops.probes.slab_step`` and ``ops.xch.xch_route``
against the reference's Pallas kernels (``scripts/probe_slab.py:make_call``
and ``ops/pallas/xch.py:xch_route``, in interpret mode) at inputs that the
lane-owned unit kernels (``csrc/unit_acc.cuh``) treat apart: a long tail
unit, uids with gaps, one-step and one-unit streams, uids that start above
0, sg0/sg1 that change between the steps of a unit, plane counts past 16.
Where the Pallas result is defined: the TPU kernels zero an out block when
its unit (group) first comes and leave blocks no step visits unwritten, so
those are left out of the comparison.

Then the host side: ``probes.unit_chunk_rows`` (R, the rows a block takes),
``xch.active_plane_range`` (the plane range each step routes, as the
kernel computes it) against the plain predicate ``xch._active_planes``, and
a model of the kernels' walk (ranges of C·R rows, C blocks of a cluster in
``harness/route_ab.py``'s variants; segments of one unit, each added into
out, or stored where the range holds the whole unit, as the A/B's plain
store variant does) against the plain version.  Plain versions sum in another order than the TPU's
matmul prefix: outputs agree to 1e-5·max|out|.
"""
import importlib.util
import os

import jax.experimental.pallas as jpl
import numpy as np
import pytest
import torch

from singlespmv_tpu.ops.pallas.xch import xch_route as pallas_route
from singlespmv_tpu_torch.harness import calibrate, probe_slab
from singlespmv_tpu_torch.ops import probes
from singlespmv_tpu_torch.ops import xch as ops

TOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _close(got, want):
    assert got.shape == want.shape
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * np.abs(want).max())


def _ref_probe_slab():
    """The reference's ``scripts/probe_slab.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        "ref_probe_slab", os.path.join(REPO, "scripts", "probe_slab.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _slab_uids(kind, n_steps):
    """Non-decreasing uids in [0, n_steps) of ``kind``."""
    if kind == "tail":          # make_inputs: the leftover steps to the last
        return np.concatenate([np.repeat(np.arange(4), 2),
                               np.full(n_steps - 8, 4)])
    if kind == "gaps":
        return np.sort(np.random.default_rng(1).choice([0, 2, 3, 6],
                                                       n_steps))
    if kind == "one unit":
        return np.full(n_steps, 4)
    return np.arange(n_steps)             # "singles": a unit a step


SLAB_CASES = [(k, st) for k in ("tail", "gaps", "one unit", "singles")
              for st in ("all", "prefix")]


@pytest.mark.parametrize("kind,stage", SLAB_CASES)
def test_slab_step_matches_pallas_at_segment_edges(monkeypatch, kind, stage):
    ref = _ref_probe_slab()
    real = jpl.pallas_call
    monkeypatch.setattr(jpl, "pallas_call",
                        lambda *a, **kw: real(*a, **(kw | {"interpret": True})))
    n_steps, T, CB, NU, s8 = 12, 8, 40, 25, 3
    arrs = list(probe_slab.make_inputs(np.random.default_rng(3), n_steps, T,
                                       s8, CB, NU))
    arrs[0] = _slab_uids(kind, n_steps).astype(np.int32)
    call, _ = ref.make_call(n_steps, T, s8, CB, NU, np.float32, stage=stage)
    want = np.asarray(call(*arrs))
    got = probes.slab_step(*map(torch.from_numpy, arrs), NU, T,
                           stage).numpy()
    visited = np.repeat(np.isin(np.arange(NU), arrs[0]), 8)
    _close(got[visited], want[visited])
    assert not got[~visited].any()


def _route_case(planes, m, T, H, g_grp, uid0, seed):
    args, _ = calibrate._route_args(np.random.default_rng(seed), H, planes,
                                    m, T)
    arrs = [a.numpy() for a in args]
    arrs[0] = arrs[0] + uid0
    arrs[1] = (arrs[0] // g_grp).astype(np.int32)
    return arrs, int(arrs[1][-1]) + 1


ROUTE_CASES = {   # name → (planes, pg, m, T, g_grp, uid0, sg0/sg1 drawn)
    "sg0/sg1 change within a unit": (16, 4, 4, 16, 2, 0, True),
    "uids start above 0": (8, 8, 1, 16, 2, 3, False),
    "17 planes, two register groups": (17, 8, 1, 16, 1, 1, True),
    "5 planes, pg 3": (5, 3, 2, 16, 4, 2, True),
}


@pytest.mark.parametrize("name", list(ROUTE_CASES))
def test_xch_route_matches_pallas_at_segment_edges(name):
    planes, pg, m, T, g_grp, uid0, draw = ROUTE_CASES[name]
    arrs, ngb = _route_case(planes, m, T, 256, g_grp, uid0, 1)
    n_steps = len(arrs[0])
    if draw:
        rng = np.random.default_rng(planes)
        arrs[3] = rng.integers(-2, planes + 2, n_steps).astype(np.int32)
        arrs[4] = rng.integers(-2, planes + 2, n_steps).astype(np.int32)
        assert len(set(arrs[3][:8])) > 1          # within unit 0's steps
    want = np.asarray(pallas_route(*arrs, ngb, m, planes, T, g_grp, pg))
    got = ops.xch_route(*map(torch.from_numpy, arrs), ngb, m, planes, T,
                        g_grp, pg).numpy()
    rows = g_grp * planes                          # a group's out block
    seen = np.repeat(np.isin(np.arange(ngb), arrs[1]), rows)
    _close(got[seen], want[seen])
    assert not got[~seen].any()


@pytest.mark.parametrize("planes,pg", [(16, 8), (16, 4), (17, 8), (5, 3),
                                       (64, 8), (1, 1)])
def test_active_plane_range_is_the_group_predicate(planes, pg):
    """The kernel's contiguous range against the TPU kernel's predicate on
    every (sg0, sg1) around [0, planes), sg1 < sg0 among them."""
    span = torch.arange(-3, planes + 3, dtype=torch.int32)
    sg0, sg1 = torch.meshgrid(span, span, indexing="ij")
    act = ops._active_planes(sg0.reshape(-1), sg1.reshape(-1), planes, pg)
    for (s0, s1), row in zip(zip(sg0.reshape(-1).tolist(),
                                 sg1.reshape(-1).tolist()), act):
        lo, hi = ops.active_plane_range(s0, s1, planes, pg)
        want = torch.zeros(planes, dtype=torch.bool)
        want[lo:hi + 1] = True
        assert torch.equal(row, want), (s0, s1)


@pytest.mark.parametrize("h,T,per_sm,want", [
    (25_600, 32, probes.UNIT_BLOCKS_PER_SM, 32),   # the probe: 800 chunks
    (25_600, 16, probes.UNIT_BLOCKS_PER_SM, 32),
    (25_600, 64, probes.UNIT_BLOCKS_PER_SM, 64),
    (16_384, 64, probes.UNIT_BLOCKS_PER_SM, 64),   # calibrate's route
    (25_600, 32, 1, 192),        # 134 chunks, a chunk an SM
    (16_384, 64, 1, 128),
    (64, 64, 1, 64),             # never below T
    (0, 8, 1, 8)])
def test_unit_chunk_rows(h, T, per_sm, want):
    R = probes.unit_chunk_rows(h, T, 132, per_sm)
    assert R == want and R % T == 0 and R >= T


def test_unit_chunk_rows_refuses_bad_sizes():
    with pytest.raises(ValueError):
        probes.unit_chunk_rows(64, 0, 132)
    with pytest.raises(ValueError):
        probes.unit_chunk_rows(64, 8, 0)


def _segments(uids, T, R, C):
    """The kernels' walk: for each range of C·R rows, the runs of steps of
    one unit inside it, (t0, t1, whole)."""
    n, span, out = len(uids), C * R // T, []
    for c0 in range(0, n, span):
        t, t1 = c0, min(c0 + span, n)
        while t < t1:
            e = t + 1
            while e < t1 and uids[e] == uids[t]:
                e += 1
            whole = ((t == 0 or uids[t - 1] != uids[t])
                     and (e == n or uids[e] != uids[t]))
            out.append((t, e, whole))
            t = e
    return out


@pytest.mark.parametrize("R,C", [(8, 1), (24, 1), (16, 2), (8, 4), (64, 8)])
@pytest.mark.parametrize("kind", ["tail", "gaps", "singles"])
def test_segment_walk_is_the_plain_version(R, C, kind):
    """The segments cover every step once; adding each segment's sums, or
    writing them by a plain store where its range holds the whole unit and
    by an add elsewhere, gives the plain version; a stored unit is stored
    once and by no other segment.  Units outside [0, NU) are dropped."""
    n_steps, T, CB, NU, s8 = 24, 8, 40, 25, 2
    arrs = list(probe_slab.make_inputs(np.random.default_rng(5), n_steps, T,
                                       s8, CB, NU))
    uids = _slab_uids(kind, n_steps)
    uids[-2:] = NU                                # dropped
    arrs[0] = uids.astype(np.int32)
    tens = list(map(torch.from_numpy, arrs))
    want = probes.slab_step_ref(*tens, NU, T, "all")
    segs = _segments(uids, T, R, C)
    assert [t for t0, t1, _ in segs for t in range(t0, t1)] == list(
        range(n_steps))
    out, added, stored = torch.zeros_like(want), torch.zeros_like(want), []
    for t0, t1, whole in segs:
        u = int(uids[t0])
        if not 0 <= u < NU:
            continue
        rows = slice(t0 * T, t1 * T)
        part = probes.slab_step_ref(
            tens[0][t0:t1], tens[1][rows], *(a[rows] for a in tens[2:6]),
            tens[6][:, rows], tens[7], NU, T, "all")[8 * u:8 * u + 8]
        added[8 * u:8 * u + 8] += part
        if whole:
            assert u not in stored and not out[8 * u:8 * u + 8].any()
            out[8 * u:8 * u + 8] = part
            stored.append(u)
        else:
            assert u not in stored
            out[8 * u:8 * u + 8] += part
    _close(added.numpy(), want.numpy())
    _close(out.numpy(), want.numpy())
