"""xch's v3 σ-plane engine (ROADMAP B.15): the port against the JAX package
on the CPU.

The same seeded COO goes through the reference's ``_convert_v3`` (under
``plan=estimate_v3(coo, cfg) | {"route_v": 3}``) and the port's, whose
arrays must be equal element for element, across planes 8, 16 and 32,
span 1 and 2, windows of one block and of several, and several pass-2
calls (``CHUNK_ROWS`` patched on both modules).  The reference's phases
(its Pallas ``xch_mul`` and ``xch_route`` in interpret mode) run once a
matrix, in module-scoped fixtures; the port's wrappers run their plain
versions on CPU tensors.  The tolerances:

- pass 1's product grid: bit for bit (one rounded multiply a slot);
- float32 y: each row within 1e-6 abs-or-rel of the reference's, or
  within twice the proven bound of ``torch_bounds.accuracy_bound`` at
  float32.  Both engines take a run's total as the difference of two
  prefix sums of its 128-slot stream row, in another order (the TPU's
  triangular matmul against a serial and shuffle scan), so a row's error
  follows its stream rows' prefix mass, not its own sum: on
  ``_mix(2000, 9000, 3)`` about a third of the rows differ by more than
  1e-6 abs-or-rel, and each stays within that bound;
- bfloat16 y: within ``accuracy_bound`` of the oracle of the stored values
  (the reference keeps its grid and out rows in bfloat16 and is held to
  the oracle's bound, as ``tests/test_torch_bf16.py`` holds it);
- v3 against v4 (the reference's ``test_xch_v3_v4_agree``): both verify,
  agree to rtol 1e-4 and atol 1e-5 as there, and each row within the sum
  of both layouts' proven bounds.

Torch runs on one thread in this file (see ``tests/test_torch_parallel.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from singlespmv_tpu.config import Config
from singlespmv_tpu.core import verify_result
from singlespmv_tpu.core.types import COOMatrix
from singlespmv_tpu.formats import xch as ref_xch
from singlespmv_tpu_torch import formats
from singlespmv_tpu_torch.core.dtypes import round_values, to_host, \
    value_tensor
from singlespmv_tpu_torch.core.oracle import reference_spmv as port_oracle
from singlespmv_tpu_torch.formats import xch
from singlespmv_tpu_torch.formats.base import phases_fn
from singlespmv_tpu_torch.ops import xch as xops
from test_torch_bf16 import _bounds
from test_xch import _mix
from torch_bounds import accuracy_bound, stored
from torch_parity import port_cfg, port_coo

F32 = Config(format="xch", dtype="float32")
BF16 = "bfloat16"
TOL = 1e-6
CHUNK = 512       # CHUNK_ROWS for several pass-2 calls (16 steps at t2 32:
#                   20 steps at span 2 split 16 + 4; at span 1, 24 steps
#                   split 19 + 5 under 640)

# name → (matrix, plan overrides, CHUNK_ROWS or None)
MATS = {
    "mix2000": (lambda: _mix(2000, 9000, 3), {}, None),
    "mix5000": (lambda: _mix(5000, 25000, 0), {}, None),
    # m1 8, m2 8; planes 8 and span 2 over 20 buckets: two G-groups, two
    # pass-2 calls, the overlap-add
    "scatter": (lambda: _mix(20000, 60000, 7, local_frac=0.0),
                {"planes": 8, "span_fix": 2}, CHUNK),
}
# convert parity: (matrix, plan overrides, CHUNK_ROWS or None)
PLANS = {
    "mix2000": ("mix2000", {}, None),
    "mix5000": ("mix5000", {}, None),
    "tall m1 m2 8": (lambda: _mix(9000, 18000, 5), {}, None),
    "planes 8": ("mix5000", {"planes": 8}, None),
    "planes 16": ("mix5000", {"planes": 16}, None),
    "planes 32": ("mix5000", {"planes": 32}, None),
    "span 1": ("scatter", {"planes": 8, "span_fix": 1}, None),
    "span 2": ("scatter", {"planes": 8, "span_fix": 2}, None),
    "m1 m2 1": ("mix5000", {"m1_fix": 1, "m2_fix": 1}, None),
    "m1 16 m2 24": ("mix5000", {"m1_fix": 16, "m2_fix": 24}, None),
    "t1 32 t2 64": ("mix2000", {"t1_fix": 32, "t2_fix": 64}, None),
    "k_slots": ("mix5000", {"k_slots": 128 * 24}, None),
    "calls span 1": ("scatter", {"planes": 8, "span_fix": 1}, 640),
    "calls span 2": ("scatter", {"planes": 8, "span_fix": 2}, CHUNK),
}


@pytest.fixture(autouse=True)
def one_thread():
    """Torch on one thread a test: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _coo(make):
    return MATS[make][0]() if isinstance(make, str) else make()


def _convert_both(coo, extra, chunk_rows, cfg=F32):
    """(the reference's v3 state, the port's) under the same plan."""
    with pytest.MonkeyPatch.context() as mp:
        if chunk_rows:
            for mod in (ref_xch, xch):
                mp.setattr(mod, "CHUNK_ROWS", chunk_rows)
        plan = ref_xch.estimate_v3(coo, cfg) | {"route_v": 3} | extra
        ref = ref_xch.convert(coo, cfg, plan=plan)
        port = xch.convert(port_coo(coo), port_cfg(cfg), plan=dict(plan))
    assert isinstance(ref, ref_xch.XchState)
    assert isinstance(port, xch.XchState)
    return ref, port


def _host(obj):
    """A reference state as numpy arrays and scalars, as
    ``state_from_reference`` takes it."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _host(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, tuple):
        return tuple(_host(v) for v in obj)
    return np.asarray(obj) if hasattr(obj, "shape") else obj


def _assert_same_state(ref, port):
    for f in dataclasses.fields(port):
        a, b = getattr(ref, f.name), getattr(port, f.name)
        if isinstance(b, tuple) and b and isinstance(b[0], torch.Tensor):
            assert len(a) == len(b), f.name
            pairs = zip(a, b)
        elif isinstance(b, torch.Tensor):
            pairs = [(a, b)]
        else:
            assert a == b, (f.name, a, b)
            continue
        for u, v in pairs:
            u = np.asarray(u)
            if u.dtype.name == "bfloat16":
                u = u.astype(np.float32)
            assert u.shape == tuple(v.shape), f.name
            assert np.array_equal(u, to_host(v)), f.name
            if v.dtype != torch.bfloat16:
                assert u.dtype == v.numpy().dtype, f.name


def _x(coo, seed=5):
    return np.random.default_rng(seed).uniform(-1, 1, coo.n_col).astype(
        np.float32)


def _f32_bound(coo, state, x):
    """The proven float32 bound of ``state``'s spmv against the oracle."""
    pc = port_coo(coo)
    return accuracy_bound(pc, x.astype(np.float64), state, "xch",
                          torch.from_numpy(x), dtype="float32")


@pytest.fixture(scope="module")
def ref_runs():
    """name → (coo, x, the reference's state, its Mul grid, its Sum y, the
    port's state): the reference's phases once a matrix, jitted, in
    interpret mode."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    try:
        for name, (make, extra, chunk_rows) in MATS.items():
            coo = make()
            ref, port = _convert_both(coo, extra, chunk_rows)
            x = _x(coo)
            grid = jax.jit(ref_xch._mul_phase)(ref, x)
            y = jax.jit(ref_xch._route_phase)(ref, grid)
            out[name] = (coo, x, ref, np.asarray(grid), np.asarray(y), port)
    finally:
        torch.set_num_threads(n)
    return out


# ------------------------------------------------------------------ layout ---

@pytest.mark.parametrize("name", ["mix2000", "mix5000", "scatter", "empty"])
def test_estimate_v3_matches_reference(name):
    coo = (COOMatrix.from_triplets(8, 8, [], [], [], sort=True)
           if name == "empty" else MATS[name][0]())
    for dtype in ("float32", "bfloat16"):
        cfg = F32.replace(dtype=dtype)
        assert xch.estimate_v3(port_coo(coo), port_cfg(cfg)) \
            == ref_xch.estimate_v3(coo, cfg)


@pytest.mark.parametrize("case", list(PLANS))
def test_convert_v3_matches_reference(case):
    """Every array of the port's ``_convert_v3`` equals the reference's;
    the layout inverts to the reference's COO, reports as the reference's,
    and its spmv (plain versions) passes the oracle."""
    make, extra, chunk_rows = PLANS[case]
    coo = _coo(make)
    ref, port = _convert_both(coo, extra, chunk_rows)
    _assert_same_state(ref, port)
    if "planes" in extra:
        assert port.planes == extra["planes"]
    if "span_fix" in extra:
        assert port.span == extra["span_fix"]
    if "m1_fix" in extra:
        assert (port.m1, port.m2) == (extra["m1_fix"], extra["m2_fix"])
    if chunk_rows:
        assert len(port.uids2) > 1
    if case == "tall m1 m2 8":
        assert port.m1 > 1 and port.m2 > 1
    back, want = xch.to_coo(port), ref_xch.to_coo(ref)
    assert back.nnz == coo.nnz
    for f in ("row", "col", "val"):
        np.testing.assert_array_equal(getattr(back, f), getattr(want, f))
    pcfg = port_cfg(F32)
    assert formats.report_fields(port, pcfg) == ref_xch.report_fields(ref,
                                                                      F32)
    assert formats.traffic_bytes(port, pcfg) == ref_xch.traffic_bytes(ref,
                                                                      F32)
    assert xch.attainable_seconds(port, pcfg) == \
        ref_xch.attainable_seconds(ref, F32) == 0.0
    # one add into y a σ-plane run end, each row's run ends counted
    adds = formats.adds_per_row(port, pcfg)
    assert adds.sum() == sum(int((to_host(i) >= 0).sum())
                             for i in port.idx2)
    x = _x(coo)
    ok, det = verify_result(coo, x, to_host(xch.spmv(port, torch.from_numpy(
        x))), dtype=np.float32)
    assert ok, det


def test_convert_dispatches_on_route_v():
    coo = _mix(2000, 9000, 3)
    pc, pcfg = port_coo(coo), port_cfg(F32)
    assert isinstance(xch.convert(pc, pcfg), xch.Xch4State)
    st = xch.convert(pc, pcfg, plan=xch.estimate_v3(pc, pcfg)
                     | {"route_v": 3})
    assert isinstance(st, xch.XchState)
    assert formats.report_fields(st, pcfg)["RouteV"] == 3


# -------------------------------------------------------------------- spmv ---

@pytest.mark.parametrize("name", list(MATS))
def test_spmv_f32_matches_reference(name, ref_runs):
    """The port's v3 spmv, on its own layout and on the reference's carried
    across, against the reference's phases: pass 1's grid bit for bit, y
    within 1e-6 abs-or-rel or twice the proven bound."""
    coo, x, ref, grid, y_ref, port = ref_runs[name]
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(to_host(xch._mul_phase(port, xt)), grid)
    y = xch.spmv(port, xt)
    assert y.dtype == torch.float32 and y.shape == (coo.n_row,)
    y = to_host(y).astype(np.float64)
    b = _f32_bound(coo, port, x)
    r = port_oracle(port_coo(coo), x.astype(np.float64))
    assert (np.abs(y - r) <= b).all()
    d = np.abs(y - y_ref)
    close = (d <= TOL) | (d <= TOL * np.abs(y_ref)) | (d <= 2 * b)
    assert close.all(), float(np.max(d / np.maximum(2 * b, 1e-300)))
    for got in (y, y_ref):
        ok, det = verify_result(coo, x, got, dtype=np.float32)
        assert ok, det
    carried = xch.state_from_reference(_host(ref))
    assert isinstance(carried, xch.XchState)
    _assert_same_state(ref, carried)
    np.testing.assert_array_equal(to_host(xch.spmv(carried, xt)), y)


def test_phases_match_reference(ref_runs):
    """``phases`` is the reference's Mul/Sum split: Mul the product grid,
    Sum the routed y from the reference's own grid."""
    coo, x, ref, grid, y_ref, port = ref_runs["scatter"]
    ph = phases_fn(port_cfg(F32))(port)
    assert set(ph) == {"Mul", "Sum"}
    prod3 = ph["Mul"](port, torch.from_numpy(x))
    np.testing.assert_array_equal(to_host(prod3), grid)
    y = to_host(ph["Sum"](port, torch.from_numpy(grid.copy()))).astype(
        np.float64)
    d = np.abs(y - y_ref)
    b = _f32_bound(coo, port, x)
    assert ((d <= TOL) | (d <= TOL * np.abs(y_ref)) | (d <= 2 * b)).all()
    np.testing.assert_array_equal(
        y, to_host(xch.spmv(port, torch.from_numpy(x))))


@pytest.fixture(scope="module")
def bf16_run():
    """The reference's bfloat16 v3 spmv on mix5000 (its Pallas kernels in
    interpret mode) beside the port's state."""
    coo = _mix(5000, 25000, 0)
    cfg = F32.replace(dtype=BF16)
    ref, port = _convert_both(coo, {}, None, cfg)
    x = np.random.default_rng(5).uniform(-1, 1, coo.n_col)
    y_ref = jax.jit(ref_xch.spmv)(ref, jnp.asarray(
        x.astype(ml_dtypes.bfloat16)))
    assert y_ref.dtype == ml_dtypes.bfloat16
    return coo, x, ref, np.asarray(y_ref).astype(np.float64), port


def test_spmv_bfloat16(bf16_run):
    """bfloat16 storage, float32 sums, y rounded once: within
    ``accuracy_bound`` of the oracle of the stored values; the reference
    within its oracle bound; the two within both and the oracles' gap."""
    coo, x, ref, y_ref, port = bf16_run
    assert port.val1[0].dtype == torch.bfloat16
    _assert_same_state(ref, port)
    xb = value_tensor(x, BF16)
    grid = xch._mul_phase(port, xb)
    assert grid.dtype == torch.bfloat16
    y = xch.spmv(port, xb)
    assert y.dtype == torch.bfloat16 and y.shape == (coo.n_row,)
    y = to_host(y).astype(np.float64)
    sc = stored(port_coo(coo))
    xh = round_values(x, BF16).astype(np.float64)
    r = port_oracle(sc, xh)
    b = accuracy_bound(sc, xh, port, "xch", xb)
    assert (np.abs(y - r) <= b).all(), float(np.max(np.abs(y - r) / b))
    ref_b = _bounds(coo, x)
    from singlespmv_tpu.core.oracle import reference_spmv
    r64 = reference_spmv(coo, x)
    assert (np.abs(y_ref - r64) <= ref_b).all()
    assert (np.abs(y - y_ref) <= b + ref_b + np.abs(r - r64)).all()
    for got in (y, y_ref):
        ok, det = verify_result(coo, x, got, dtype=ml_dtypes.bfloat16)
        assert ok, det
    carried = xch.state_from_reference(_host(ref))
    np.testing.assert_array_equal(
        to_host(xch.spmv(carried, xb)).astype(np.float64), y)


@pytest.mark.parametrize("name", list(MATS))
def test_v3_v4_agree(name):
    """The reference's ``test_xch_v3_v4_agree`` on the port: both engines
    verify and agree to rtol 1e-4, atol 1e-5, and each row lies within the
    sum of both layouts' proven bounds."""
    make, extra, chunk_rows = MATS[name]
    coo = make()
    x = np.random.default_rng(5).uniform(size=coo.n_col).astype(np.float32)
    pc, pcfg = port_coo(coo), port_cfg(F32)
    _, v3 = _convert_both(coo, extra, chunk_rows)
    v4 = xch.convert(pc, pcfg)
    ys, bs = [], []
    for st in (v3, v4):
        y = to_host(xch.spmv(st, torch.from_numpy(x))).astype(np.float64)
        ok, det = verify_result(coo, x, y, dtype=np.float32)
        assert ok, det
        ys.append(y)
        bs.append(_f32_bound(coo, st, x))
    np.testing.assert_allclose(ys[0], ys[1], rtol=1e-4, atol=1e-5)
    assert (np.abs(ys[0] - ys[1]) <= bs[0] + bs[1]).all()


@pytest.mark.parametrize("dtype", ["float32", BF16])
def test_spmm_is_the_column_loop(dtype):
    """spmm at B = 3: each column the spmv of that column (the reference's
    ``vmap``), rounded once."""
    coo = _mix(2000, 9000, 3)
    _, st = _convert_both(coo, {"planes": 8, "span_fix": 2}, None,
                          F32.replace(dtype=dtype))
    X = value_tensor(np.random.default_rng(2).uniform(
        -1, 1, (coo.n_col, 3)), dtype)
    Y = xch.spmm(st, X)
    assert Y.dtype == X.dtype and Y.shape == (coo.n_row, 3)
    for b in range(3):
        assert torch.equal(Y[:, b], xch.spmv(st, X[:, b].contiguous()))
    assert torch.equal(formats.spmm_fn(port_cfg(F32))(st, X), Y)


def test_float64_is_refused_as_the_reference_does():
    """A float64 v3 state converts and inverts, but its spmv and spmm raise
    ``TypeError``, as the reference's do on its chip (no df64 build)."""
    coo = _mix(2000, 9000, 3)
    cfg = port_cfg(F32.replace(dtype="float64"))
    st = xch.convert(port_coo(coo), cfg,
                     plan=xch.estimate_v3(port_coo(coo), cfg)
                     | {"route_v": 3})
    assert isinstance(st, xch.XchState)
    assert st.val1[0].dtype == torch.float64
    back = xch.to_coo(st)
    np.testing.assert_array_equal(back.val, coo.val)
    x = torch.zeros(coo.n_col, dtype=torch.float64)
    with pytest.raises(TypeError, match="v3"):
        xch.spmv(st, x)
    with pytest.raises(TypeError, match="v3"):
        xch.spmm(st, torch.zeros(coo.n_col, 2, dtype=torch.float64))
    with pytest.raises(TypeError, match="float64"):
        xch.spmv(xch.convert(port_coo(coo), port_cfg(F32),
                             plan=xch.estimate_v3(port_coo(coo), cfg)
                             | {"route_v": 3}), x)


def test_empty_matrix():
    """An empty COO: ``convert`` gives the empty v4 state, as the
    reference's; ``_convert_v3`` the empty v3 state, whose spmv is zeros
    and whose reports and inverse are the reference's."""
    coo = COOMatrix.from_triplets(8, 8, [], [], [], sort=True)
    pc, pcfg = port_coo(coo), port_cfg(F32)
    plan = xch.estimate_v3(pc, pcfg) | {"route_v": 3}
    assert isinstance(xch.convert(pc, pcfg, plan=plan), xch.Xch4State)
    st, ref = xch._convert_v3(pc, pcfg, plan), ref_xch._convert_v3(coo, F32)
    assert isinstance(st, xch.XchState)
    _assert_same_state(ref, st)
    y = xch.spmv(st, torch.ones(8))
    assert torch.equal(y, torch.zeros(8))
    assert xch.to_coo(st).nnz == 0
    assert formats.report_fields(st, pcfg) == ref_xch.report_fields(ref, F32)
    assert formats.traffic_bytes(st, pcfg) == ref_xch.traffic_bytes(ref, F32)
    assert formats.adds_per_row(st, pcfg).sum() == 0


def test_state_moves_its_call_tuples():
    _, st = _convert_both(_mix(20000, 60000, 7, local_frac=0.0),
                          {"planes": 8, "span_fix": 2}, CHUNK)
    meta = st.to("meta")
    assert len(meta.uids2) == len(st.uids2) > 1
    for name in ("val1", "uids2", "idx2", "sg0_2", "gids2"):
        assert all(t.device.type == "meta" for t in getattr(meta, name))
    assert meta.bucket_ids.device.type == "meta"
    assert meta.chunk_nb == st.chunk_nb
    assert st.val1[0].device.type == "cpu"


# --------------------------------------------------------------- the route ---

def test_route_reads_a_bfloat16_grid():
    """``xch_route``'s plain version on a bfloat16 product grid equals the
    float32 route of the same rounded products (float32 sums, float32 out);
    the wrapper takes either type and returns float32."""
    coo = _mix(20000, 60000, 7, local_frac=0.0)
    _, st = _convert_both(coo, {"planes": 8, "span_fix": 2}, CHUNK,
                          F32.replace(dtype=BF16))
    xb = value_tensor(_x(coo), BF16)
    grid = xch._mul_phase(st, xb)
    assert grid.dtype == torch.bfloat16
    op = st.span * st.planes
    for i in range(len(st.uids2)):
        args = (st.uids2[i], st.gids2[i], st.cs2[i], st.sg0_2[i],
                st.sg1_2[i], st.win2[i], st.lane2[i], st.sub2[i], st.hm2[i],
                st.idx2[i])
        rest = (st.chunk_nb[i], st.m2, op, st.t2, xch.G_GRP)
        got = xops.xch_route_ref(*args, grid, *rest)
        want = xops.xch_route_ref(*args, grid.float(), *rest)
        assert got.dtype == torch.float32
        assert torch.equal(got, want)
        assert torch.equal(xops.xch_route(*args, grid, *rest), got)
    with pytest.raises(TypeError):
        xops.xch_route(*args, grid.double(), *rest)
