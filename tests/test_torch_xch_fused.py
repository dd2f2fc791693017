"""xch's fused spmv route, plain path: ``xch_fused_rows`` (pass 1's
products made in registers from the pass-2-ordered streams ``val2`` and
``col2``, consumed by pass 2's route in the same launch) on CPU tensors,
against the JAX package.

- ``xch_fused_rows_ref`` on the port's state carried from the reference's
  (``state_from_reference``) against the reference's Pallas ``xch_mul``
  then ``xch_route4`` in interpret mode (at float64 their df64 builds
  ``xch_mul_df`` and ``xch_route4_df``), the out groups placed into y as
  ``tests/test_torch_xch_rows.py`` places them: each y_i within 1e-6 of
  the Pallas y_i, relative to it or to max|y| (a tenth of that file's
  tolerance), over the five route
  plans of ``tests/test_torch_xch_ops.py``, several pass-1 and pass-2
  calls, several source chunks, the merge span and none, an outer and a
  nested long-row state, a state with a peel, float64 and bfloat16 (the
  Pallas products, each rounded once to bfloat16, routed in float32, as
  the port sums them: the reference's route sums in bfloat16).
- The fused plain version against the pair's, ``xch_mul_ref`` then
  ``xch_route4_rows_ref``: the same products in the same order, so the
  same y bit for bit; at bfloat16 each product rounded once.
- ``val2`` and ``col2`` from the port's convert equal those that
  ``state_from_reference`` derives on six layouts; every ``col2`` lies
  below n_col, and a nonzero value in the x table's zero padding is
  refused.
- ``xch.spmv`` (and DistXch's step) makes one ``xch_fused_rows`` call a
  pass-2 call, nested states included, and no ``xch_mul`` or
  ``xch_route4_rows`` call; the profiling phases and ``pair_spmv_acc``
  keep the pair; the wrapper refuses what it cannot take; a cached state
  of the old ``STATE_REV`` is converted again.

Torch runs on one thread in each test.  The reference's float64 convert
turns ``jax_enable_x64`` on for good; every test here puts the flag back.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from singlespmv_tpu.config import Config
from singlespmv_tpu.core.types import COOMatrix
from singlespmv_tpu.formats import xch as ref_xch
from singlespmv_tpu.ops.pallas.xch import xch_mul as pallas_mul
from singlespmv_tpu.ops.pallas.xch import xch_mul_df as pallas_mul_df
from singlespmv_tpu_torch.core.dtypes import round_values, value_tensor
from singlespmv_tpu_torch.formats import cache
from singlespmv_tpu_torch.formats import xch
from singlespmv_tpu_torch.ops import xch as ops
from singlespmv_tpu_torch.parallel import DistXch, make_mesh
from test_torch_xch_ops import ROUTES
from test_torch_xch_rows import FIXTURES, _host, _pallas_y
from test_xch import _mix
from torch_parity import port_cfg, port_coo

F32 = Config(format="xch", dtype="float32")
TOL = 1e-6          # the oracle's abs-or-rel bound, element by element
LANES = 128


@contextlib.contextmanager
def x64_restored():
    """Puts ``jax_enable_x64`` back as it was on entry."""
    saved = jax.config.jax_enable_x64
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", saved)


@pytest.fixture(autouse=True)
def _scope():
    """torch on one thread and ``jax_enable_x64`` as it was, put back after
    each test: the suite's workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with x64_restored():
            yield
    finally:
        torch.set_num_threads(n)


def _ref(coo, dtype="float32", **fix):
    cfg = F32.replace(dtype=dtype)
    return ref_xch.convert(coo, cfg, plan=ref_xch.estimate(coo, cfg) | fix)


def _x(n_col, dtype, seed=3):
    """x as float64 values of the type (rounded at bfloat16)."""
    return round_values(np.random.default_rng(seed).uniform(-1, 1, n_col),
                        dtype).astype(np.float64)


def _pallas_pair(ref, x):
    """The reference's Pallas pass 1 on every call, then its Pallas route
    placed into y: float64 y."""
    dtype = np.asarray(ref.val1[0]).dtype
    if ref.val1_lo is not None:                  # df64: (hi, lo) planes
        xp = np.zeros(ref.cb_pad * LANES)
        xp[: len(x)] = x
        xh = xp.astype(np.float32)
        xl = (xp - xh.astype(np.float64)).astype(np.float32)
        parts = []
        for w, la, su, vh, vl in zip(ref.win1, ref.lane1, ref.sub1,
                                     ref.val1, ref.val1_lo):
            hi, lo = pallas_mul_df(w, la, su, vh, vl, xh.reshape(-1, LANES),
                                   xl.reshape(-1, LANES), ref.m1, ref.t1)
            parts.append(np.asarray(hi, np.float64)
                         + np.asarray(lo, np.float64))
    else:
        xp = np.zeros(ref.cb_pad * LANES, dtype)
        xp[: len(x)] = x.astype(dtype)
        table = jnp.asarray(xp).reshape(-1, LANES)
        parts = [np.asarray(pallas_mul(w, la, su, v, table, ref.m1, ref.t1))
                 for w, la, su, v in zip(ref.win1, ref.lane1, ref.sub1,
                                         ref.val1)]
    prod = np.concatenate(parts).reshape(ref.n_chunks, ref.p1, LANES)
    if prod.dtype == ml_dtypes.bfloat16:
        # the reference's route sums bfloat16 in bfloat16; the port's sums
        # the same products in float32: route them widened
        prod = prod.astype(np.float32)
    return _pallas_y(ref, prod).astype(np.float64)


def _fused_y(port, x, span=None):
    """``xch_fused_rows`` (the CPU wrapper: its plain version) of every
    pass-2 call, adding into one zeroed y: float64 y."""
    vt = port.val1[0].dtype
    xt = value_tensor(x, {torch.float64: "float64", torch.float32: "float32",
                          torch.bfloat16: "bfloat16"}[vt])
    y = torch.zeros(port.n_row, dtype=ops.acc_dtype(vt))
    for b, v, c, h2, d in zip(port.base2, port.val2, port.col2, port.hm2,
                              port.dest2):
        ops.xch_fused_rows(b, v, c, h2, d, xt, y, port.t2,
                           port.merge2 if span is None else span)
    return y.double().numpy()


def _within(got, want):
    """Each y_i within 1e-6 of the Pallas y_i, relative to y_i or to
    max|y|: both take a run's total as the difference of two prefix sums of
    its stream row (a scan against a triangle matmul), so a small total
    carries a rounding of the prefix, of the row's scale."""
    err = np.abs(got - want)
    scale = np.abs(want).max()
    assert scale > 0
    bad = ~((err <= TOL * scale) | (err <= TOL * np.abs(want)))
    assert not bad.any(), (int(bad.sum()), float(err.max()), scale)


_PALLAS = {}


def _check(ref, seed=3, span=None, key=None):
    """The fused plain version on the carried state against the Pallas
    pair on the reference's (kept under ``key``: a case that differs only
    in the port's kernel reads it again); returns the port's state."""
    port = xch.state_from_reference(_host(ref))
    x = _x(ref.n_col, _dtype_name(port), seed)
    want = _PALLAS.get(key) if key is not None else None
    if want is None:
        want = _pallas_pair(ref, x)
        if key is not None:
            _PALLAS[key] = want
    _within(_fused_y(port, x, span), want)
    return port


def _route_case(m2, kblk, t2, p_oh):
    key = ("route", m2, kblk, t2, p_oh)
    if key not in _REFS:
        _REFS[key] = _ref(_mix(2000, 8000, 0), m2_fix=m2, t2_fix=t2,
                          kblk=kblk, kblk_fix=True, p_oh_fix=p_oh)
    return _REFS[key], key


_REFS = {}


def long_rows(n=8000, seed=11):
    """8 rows of degree 1,000 over a hyper-sparse scatter: the planner
    splits them into a nested state (``long_rows_matrix`` of
    ``tests/test_torch_xch_ops.py`` at a third of its size)."""
    rng = np.random.default_rng(seed)
    rows = np.concatenate([rng.integers(0, n, 16000),
                           np.repeat(rng.choice(n, 8, replace=False), 1000)])
    return COOMatrix.from_triplets(n, n, rows, rng.integers(0, n, len(rows)),
                                   rng.uniform(1, 2, len(rows)), sort=True)


def _long_ref(dtype="float32"):
    if ("long", dtype) not in _REFS:
        _REFS["long", dtype] = _ref(long_rows(), dtype)
    return _REFS["long", dtype]


def _dtype_name(port):
    return {torch.float64: "float64", torch.float32: "float32",
            torch.bfloat16: "bfloat16"}[port.val1[0].dtype]


# ------------------------------------------- against the Pallas pair ---

@pytest.mark.parametrize("m2,kblk,t2,p_oh", ROUTES)
def test_fused_matches_pallas_pair(m2, kblk, t2, p_oh):
    ref, key = _route_case(m2, kblk, t2, p_oh)
    assert (ref.m2, ref.kblk, ref.t2, ref.p_oh) == (m2, kblk, t2, p_oh)
    _check(ref, key=key)


def test_fused_several_source_chunks():
    ref = _ref(_mix(2000, 8000, 0), k_slots=128 * 16, t2_fix=32, kblk=4,
               kblk_fix=True, m1_fix=8)
    assert ref.n_chunks > 2 and len(np.unique(np.asarray(ref.cs2[0]))) > 2
    _check(ref, seed=5)


def test_fused_several_calls_per_pass(monkeypatch):
    """Several pass-2 calls from the reference's convert (its call cap cut
    down), and the carried state's pass 1 cut into three calls at
    multiples of t1 (the reference cuts pass 1 at 160,000 rows only)."""
    monkeypatch.setattr(ref_xch, "CHUNK_ROWS", 4 * 32)
    ref = _ref(_mix(8000, 24000, 0), gb=16, t2_fix=32, t1_fix=32)
    assert len(ref.gids2) > 1
    h1 = np.asarray(ref.win1[0]).shape[0]
    cuts = [0, 32, 64, h1]
    assert len(ref.win1) == 1 and ref.t1 == 32 and h1 > 64
    host = _host(ref)
    for f in ("win1", "lane1", "sub1", "val1"):
        host[f] = tuple(host[f][0][a:b] for a, b in zip(cuts, cuts[1:]))
    port = xch.state_from_reference(host)
    assert len(port.win1) == 3 and len(port.val2) == len(ref.gids2)
    x = _x(ref.n_col, "float32", 6)
    _within(_fused_y(port, x), _pallas_pair(ref, x))


@pytest.mark.parametrize("level", ["outer", "nested"])
def test_fused_long_row_states(level):
    ref = _long_ref()
    assert ref.long is not None
    _check(ref if level == "outer" else ref.long, seed=8)


@pytest.mark.parametrize("merge", [False, True])
def test_fused_merge_span_or_none(merge):
    """The merge span picks a kernel, not a function: on one state, y at
    span 0 and at p_oh · 128 both hold to the Pallas y."""
    ref, key = _route_case(*ROUTES[1])
    _check(ref, span=ref.p_oh * LANES if merge else 0, key=key)


def test_fused_on_a_peeled_state():
    coo = _mix(2500, 7500, 1, local_frac=0.2)
    ref = _ref(coo)
    assert ref.dia_offs, "no band peeled"
    _check(ref, seed=10)


@pytest.mark.parametrize("fix", [
    dict(kblk=2, kblk_fix=True, m2_fix=8, t2_fix=32, p_oh_fix=8, t1_fix=32),
    dict(kblk=1, kblk_fix=True, m2_fix=16, t2_fix=32, p_oh_fix=8, m1_fix=8,
         t1_fix=32)])   # the df64 Pallas traces grow with T, kblk and p_oh
def test_fused_float64_matches_pallas_df64(fix):
    ref = _ref(_mix(1200, 5000, 1), "float64", **fix)
    assert ref.val1_lo is not None
    port = _check(ref, seed=11)
    assert port.val2[0].dtype == torch.float64


@pytest.mark.parametrize("level", ["mix", "nested"])
def test_fused_bfloat16_matches_pallas(level):
    ref = _ref(_mix(2000, 8000, 4), "bfloat16") if level == "mix" \
        else _long_ref("bfloat16").long
    port = _check(ref, seed=12)
    assert port.val2[0].dtype == torch.bfloat16


# ----------------------------------------------- against the port's pair ---

def _pair_y(port, x):
    """``xch_mul_ref`` on every pass-1 call, then ``xch_route4_rows_ref``
    of every pass-2 call on the grid, into one zeroed y."""
    xt = xch.x_table(port, x)
    prod = torch.cat([ops.xch_mul_ref(w, la, su, v, xt, port.m1, port.t1)
                      for w, la, su, v in zip(port.win1, port.lane1,
                                              port.sub1, port.val1)])
    prod3 = prod.view(port.n_chunks, port.p1, LANES)
    y = torch.zeros(port.n_row, dtype=ops.acc_dtype(x.dtype))
    for a in zip(port.base2, port.cs2, port.win2, port.lane2, port.sub2,
                 port.hm2, port.dest2):
        ops.xch_route4_rows_ref(*a, prod3, y, port.m2, port.t2)
    return y, prod3


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
def test_fused_is_the_pair_product_for_product(dtype):
    """Each val2 · x[col2] is the grid's product that the pair's route
    gathers at the slot, so both plain versions give the same y bitwise."""
    coo = _mix(3000, 15000, 5)
    cfg = port_cfg(F32.replace(dtype=dtype))
    port = xch.convert(port_coo(coo), cfg,
                       plan=xch.estimate(port_coo(coo), cfg) | dict(
                           m1_fix=8, m2_fix=8, kblk=4, kblk_fix=True))
    x = value_tensor(_x(coo.n_col, dtype), dtype)
    want, prod3 = _pair_y(port, x)
    y = torch.zeros(port.n_row, dtype=want.dtype)
    for b, v, c, h2, d, cs, w, la, su in zip(
            port.base2, port.val2, port.col2, port.hm2, port.dest2,
            port.cs2, port.win2, port.lane2, port.sub2):
        ops.xch_fused_rows_ref(b, v, c, h2, d, x, y, port.t2)
        step = torch.arange(la.shape[0]) // port.t2
        gathered = ops._gather(cs.long()[step] * port.p1 + w.long(), la, su,
                               prod3, port.m2)
        made = (ops.acc(v) * ops.acc(x[c.long()])).to(v.dtype)
        assert torch.equal(made, gathered)
    assert torch.equal(y, want)


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
def test_pair_spmv_is_the_fused_spmv(dtype):
    """``pair_spmv_acc`` (the phases' two passes, the long rows, the
    bands) and ``spmv_acc`` (the fused route) give the same y bit for bit
    on the CPU, on a state with a nested long-row state."""
    coo = long_rows()
    cfg = port_cfg(F32.replace(dtype=dtype))
    st = xch.convert(port_coo(coo), cfg)
    assert st.long is not None
    x = value_tensor(_x(coo.n_col, dtype, 5), dtype)
    want = xch.pair_spmv_acc(st, x)
    assert want.dtype == ops.acc_dtype(x.dtype)
    assert torch.equal(xch.spmv_acc(st, x), want)


def test_bfloat16_products_rounded_once():
    """At bfloat16 a product is the float32 product of the two bfloat16
    values (exact) rounded once to bfloat16, not the product of float32
    values nor a float32 product kept."""
    coo = _mix(2000, 8000, 6)
    cfg = port_cfg(F32.replace(dtype="bfloat16"))
    port = xch.convert(port_coo(coo), cfg)
    x = value_tensor(_x(coo.n_col, "bfloat16", 7), "bfloat16")
    b, v, c, h2, d = (f[0] for f in (port.base2, port.val2, port.col2,
                                     port.hm2, port.dest2))
    exact = v.double() * x[c.long()].double()        # exact in float64
    once = exact.to(torch.bfloat16)
    prod = (v.float() * x[c.long()].float()).to(torch.bfloat16)
    assert torch.equal(prod, once)
    assert not torch.equal(prod.double(), exact)     # a rounding happened
    y = ops.xch_fused_rows_ref(b, v, c, h2, d, x, torch.zeros(port.n_row),
                               port.t2)
    want = ops._add_runs(ops._totals(once.float(), h2), b, d,
                         torch.zeros(port.n_row), port.t2)
    assert torch.equal(y, want)


# ---------------------------------------------------- the streams ---

@pytest.mark.parametrize("label,make,fix", FIXTURES,
                         ids=[f[0] for f in FIXTURES])
def test_convert_and_reference_give_one_stream(label, make, fix):
    """``val2`` and ``col2`` of the port's convert equal those that
    ``state_from_reference`` derives from the reference's arrays, nested
    states included; every col2 lies below n_col."""
    coo = make()
    ref = ref_xch.convert(coo, F32, plan=ref_xch.estimate(coo, F32) | fix)
    port = xch.convert(port_coo(coo), port_cfg(F32),
                       plan=xch.estimate(port_coo(coo), port_cfg(F32)) | fix)
    carried = xch.state_from_reference(_host(ref))
    while port is not None:
        assert len(port.val2) == len(carried.val2) == len(port.lane2)
        for f in ("val2", "col2"):
            for a, b in zip(getattr(port, f), getattr(carried, f)):
                assert a.dtype == b.dtype and torch.equal(a, b), f
        for c, la in zip(port.col2, port.lane2):
            assert c.shape == la.shape and c.dtype == torch.int32
            assert int(c.min()) >= 0 and int(c.max()) < port.n_col
        port, carried = port.long, carried.long


def _small():
    return xch.convert(port_coo(_mix(3000, 15000, 3)), port_cfg(F32))


def test_stream_refuses_a_value_in_the_padding():
    """A nonzero value whose x position lies in the x table's zero padding
    (at or past n_col) would drop its product: refused.  A zero value there
    is a padding slot: col2 0, val2 0."""
    st = _small()
    assert st.n_col % LANES                     # the table pads the last row
    lane1 = st.lane1[0].clone()
    val1 = st.val1[0].clone()
    win1 = st.win1[0]
    last = (st.n_col - 1) // LANES
    r, l_ = (int(v[0]) for v in torch.nonzero(
        (win1[:, None] == last) & (val1 != 0), as_tuple=True))
    lane1[r, l_] = LANES - 1                    # position past n_col
    assert last * LANES + LANES - 1 >= st.n_col
    with pytest.raises(ValueError, match="padding"):
        xch.stream_rows(dataclasses.replace(st, lane1=(lane1,)))
    val1[r, l_] = 0
    moved = xch.stream_rows(dataclasses.replace(st, lane1=(lane1,),
                                                val1=(val1,)))
    hit = [(v == 0) & (c == 0) for v, c in zip(moved["val2"],
                                               moved["col2"])]
    assert any(bool(h.any()) for h in hit)
    for c in moved["col2"]:
        assert int(c.max()) < st.n_col


def test_stream_refuses_a_slot_outside_the_grid():
    st = _small()
    win2 = st.win2[0].clone()
    win2[0] = st.n_chunks * st.p1
    with pytest.raises(ValueError, match="product grid"):
        xch.stream_rows(dataclasses.replace(st, win2=(win2,)))


# ------------------------------------------------------- the spmv path ---

@pytest.fixture
def calls(monkeypatch):
    """Counts the spmv's fused calls; the pair may not run."""
    seen = []

    def fused(*a, **k):
        seen.append(a[1].shape[0])
        return ops.xch_fused_rows(*a, **k)

    def refuse(*a, **k):
        raise AssertionError("the spmv ran the pair")

    monkeypatch.setattr(xch, "xch_fused_rows", fused)
    monkeypatch.setattr(xch, "xch_mul", refuse)
    monkeypatch.setattr(xch, "xch_route4_rows", refuse)
    return seen


def _pass2_calls(st):
    return len(st.base2) + (_pass2_calls(st.long) if st.long is not None
                            else 0)


@pytest.mark.parametrize("coo_of", [lambda: _mix(5000, 20000, 7),
                                    long_rows],
                         ids=["plain", "nested"])
def test_spmv_is_one_fused_call_a_pass2_call(calls, coo_of):
    from singlespmv_tpu_torch.core import verify_result

    coo = coo_of()
    st = xch.convert(port_coo(coo), port_cfg(F32))
    assert (st.long is not None) == (coo_of is long_rows)
    x = np.random.default_rng(1).uniform(-1, 1, coo.n_col).astype(np.float32)
    y = xch.spmv(st, torch.from_numpy(x))
    assert len(calls) == _pass2_calls(st) > 0
    ok, det = verify_result(port_coo(coo), x, y.numpy(), dtype=np.float32)
    assert ok, det


def test_dist_xch_step_is_the_fused_route(calls):
    from singlespmv_tpu_torch.core import verify_result

    coo = port_coo(_mix(6000, 24000, 8))
    op = DistXch.convert(coo, port_cfg(F32),
                         make_mesh((("row", 2),), device="cpu"))
    x = np.random.default_rng(2).uniform(-1, 1, coo.n_col).astype(np.float32)
    y = op(x).numpy()
    assert len(calls) == sum(len(st.base2) for st in op.states) > 0
    ok, det = verify_result(coo, x, y, dtype=np.float32)
    assert ok, det


def test_phases_keep_the_pair():
    """The profiling phases run the reference's two passes: Mul writes the
    product grid, Sum routes it; their y is the fused spmv's."""
    coo = _mix(3000, 15000, 9, diag=False)
    st = xch.convert(port_coo(coo), port_cfg(F32))
    assert st.long is None and not st.dia_offs
    x = torch.from_numpy(_x(coo.n_col, "float32").astype(np.float32))
    ph = xch.phases(st)
    prod3 = ph["Mul"](st, x)
    assert prod3.shape == (st.n_chunks, st.p1, LANES)
    assert torch.equal(ph["Sum"](st, prod3), xch.spmv_acc(st, x))


# ------------------------------------------------------- the wrapper ---

def test_wrapper_is_its_plain_version_and_refuses():
    st = _small()
    x = torch.from_numpy(_x(st.n_col, "float32").astype(np.float32))
    a = (st.base2[0], st.val2[0], st.col2[0], st.hm2[0], st.dest2[0])
    before = (ops.xch_fused_rows.launches, ops.xch_fused_rows.launches_f64,
              ops.xch_fused_rows.launches_bf16)
    y = torch.zeros(st.n_row)
    assert ops.xch_fused_rows(*a, x, y, st.t2) is y
    assert (ops.xch_fused_rows.launches, ops.xch_fused_rows.launches_f64,
            ops.xch_fused_rows.launches_bf16) == before     # CPU: plain
    assert torch.equal(y, ops.xch_fused_rows_ref(*a, x, torch.zeros(
        st.n_row), st.t2))
    b, v, c, h2, d = a
    with pytest.raises(TypeError):
        ops.xch_fused_rows(b, v, c, h2, d.int(), x, y, st.t2)    # dest type
    with pytest.raises(TypeError):
        ops.xch_fused_rows(b, v, c.long(), h2, d, x, y, st.t2)   # col2 type
    with pytest.raises(TypeError):
        ops.xch_fused_rows(*a, x.double(), y, st.t2)             # x type
    with pytest.raises(TypeError):
        ops.xch_fused_rows(*a, x, y.double(), st.t2)             # y type
    with pytest.raises(TypeError):
        ops.xch_fused_rows(b, v.half(), c, h2, d, x.half(), y, st.t2)
    with pytest.raises(ValueError):
        ops.xch_fused_rows(*a, x, y, st.t2 + 1)                  # H % T
    with pytest.raises(ValueError):
        ops.xch_fused_rows(*a, x.view(1, -1), y, st.t2)          # x rank
    with pytest.raises(ValueError):
        ops.xch_fused_rows(b, v[:-1], c, h2, d, x, y, st.t2)     # shape
    with pytest.raises(ValueError):
        ops.xch_fused_rows(b[:-1], v, c, h2, d, x, y, st.t2)     # base
    with pytest.raises(ValueError, match="col2"):
        ops.xch_fused_rows(*a, x[: int(c.max())], y, st.t2)      # range
    neg = c.clone()
    neg[0, 0] = -1
    with pytest.raises(ValueError, match="col2"):
        ops.xch_fused_rows(b, v, neg, h2, d, x, y, st.t2)
    for span in (100, -128, 65 * 128):         # not a multiple, < 0, > max
        with pytest.raises(ValueError, match="merge span"):
            ops.xch_fused_rows(*a, x, y, st.t2, span)
    with pytest.raises(ValueError, match="shared memory"):
        ops.xch_fused_rows(b, v.double(), c, h2, d, x.double(), y.double(),
                           st.t2, 24 * 128)            # 8 spans of 24 KB
    with pytest.raises(ValueError, match="cuda"):
        ops.xch_fused_rows(*(t.to("meta") for t in a), x.to("meta"),
                           y.to("meta"), st.t2)


def test_wrapper_reads_col2_range_again_after_an_edit():
    """The range of col2 is read once a tensor and version: an edit in
    place is seen."""
    st = _small()
    x = torch.zeros(st.n_col)
    b, v, c, h2, d = (st.base2[0], st.val2[0], st.col2[0].clone(), st.hm2[0],
                      st.dest2[0])
    ops.xch_fused_rows(b, v, c, h2, d, x, torch.zeros(st.n_row), st.t2)
    c[0, 0] = st.n_col
    with pytest.raises(ValueError, match="col2"):
        ops.xch_fused_rows(b, v, c, h2, d, x, torch.zeros(st.n_row), st.t2)


# ------------------------------------------------------- the cache ---

def test_cached_state_of_the_old_rev_is_converted_again(tmp_path,
                                                        monkeypatch):
    """A state cached before the fused stream (``STATE_REV`` 1, no val2 or
    col2) does not load: ``convert_cached`` converts again, and the state
    it returns and saves has the stream."""
    coo = port_coo(_mix(2000, 8000, 10))
    cfg = port_cfg(F32)
    old = dataclasses.replace(xch.convert(coo, cfg), val2=(), col2=())
    with monkeypatch.context() as m:
        m.setattr(xch, "STATE_REV", 1)
        cache.save_state(str(tmp_path / "m-xch"), old, coo, cfg)
        assert cache.load_state(str(tmp_path / "m-xch"), coo, cfg) \
            is not None
    assert xch.STATE_REV == 2
    assert cache.load_state(str(tmp_path / "m-xch"), coo, cfg) is None
    st = cache.convert_cached(coo, cfg, str(tmp_path), "m")
    assert len(st.val2) == len(st.base2) > 0
    again = cache.load_state(str(tmp_path / "m-xch"), coo, cfg)
    assert again is not None
    for a, b in zip(st.col2, again.col2):
        assert torch.equal(a, b)
