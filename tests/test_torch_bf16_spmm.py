"""bfloat16 SpMM (ROADMAP A.10b): the port against the JAX package on the CPU.

Seeded numpy panels X go through the reference's ``spmm_fn`` at
``Config(dtype="bfloat16")`` (its Pallas panels in interpret mode, as its
own tests run them) and through the port's ``spmm_fn``, whose wrappers run
their plain versions on CPU tensors: bfloat16 values and X, products and
sums in float32, each column of Y rounded once.  The tolerances are those
of ``tests/test_torch_bf16.py``, column by column:

- the port: within ``torch_bounds.accuracy_bound`` of the float64 oracle
  of the stored values (the bfloat16-rounded values and column), at every
  B of ``WIDTHS``; a product dropped from the matrix fails it
  (``test_a_dropped_product_fails``);
- the reference: within the bfloat16 oracle's bound that its own tests
  hold it to (``test_torch_bf16._bounds``), since it rounds products,
  prefixes and planes to bfloat16 where the port keeps float32;
- the two agree within the sum of those bounds and the difference of the
  two oracles.  The reference runs at one B a format: its Pallas panels in
  interpret mode take seconds a column.

Both packages take the same branch, panel or column loop, for one state
and B (``test_gate_parity``, the x-table cap included).  At the ops level
the three plain versions are held against the Pallas panel kernels on
bfloat16 streams at windows m 1 and 8: ``xch_mul_panel``'s products bit
for bit (both round the exact product once); the two routes, which sum in
float32 where the Pallas kernels round to bfloat16, each within its proven
bound of the float64 plain version on the same inputs
(``torch_bounds.route_entry_bound``),
and so within the sum of both bounds of each other.
"""
import functools

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from singlespmv_tpu.config import Config
from singlespmv_tpu.core import verify_result
from singlespmv_tpu.core.oracle import reference_spmv
from singlespmv_tpu.core.types import COOMatrix
from singlespmv_tpu.data.generators import generate, powerlaw
from singlespmv_tpu.formats import base as ref_base
from singlespmv_tpu.formats import slab as ref_slab
from singlespmv_tpu.formats import xch as ref_xch
from singlespmv_tpu.ops.pallas import slab as ref_pallas_slab
from singlespmv_tpu.ops.pallas.slab import slab_spmm as pallas_spmm
from singlespmv_tpu.ops.pallas.xch import xch_mul_panel as pallas_mul
from singlespmv_tpu.ops.pallas.xch import xch_route4_panel as pallas_route
from singlespmv_tpu_torch import formats
from singlespmv_tpu_torch.core.dtypes import (from_numpy, round_values,
                                              to_host, value_tensor)
from singlespmv_tpu_torch.core.oracle import reference_spmv as port_oracle
from singlespmv_tpu_torch.core.types import COOMatrix as PortCOO
from singlespmv_tpu_torch.formats import slab, xch
from singlespmv_tpu_torch.ops import slab as sops
from singlespmv_tpu_torch.ops import xch as xops
from test_torch_bf16 import _bounds
from test_torch_dia_hyb import _mixed
from torch_bounds import accuracy_bound, route_entry_bound, stored
from torch_parity import port_cfg, port_coo

BF16 = "bfloat16"
WIDTHS = (2, 5, 8, 16, 32)          # the panels the port is held at
U_BF16 = 2.0 ** -8


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """torch on one thread in each test, put back after it: the suite's
    workers share the machine's cores, and the plain versions' many small
    operations, each a parallel region on every core, then wait on each
    other (a B 32 slab panel took 18 s instead of 0.05 on 8 threads
    against 5 busy processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _peel_long(n=3000, seed=11):
    """A band of 3 diagonals (xch peels it), scatter, and 3 rows of degree
    600 (a nested long-row state)."""
    rng = np.random.default_rng(seed)
    band = generate("band", n, 3, seed=4)
    rows = np.concatenate([band.row, rng.integers(0, n, 6000),
                           np.repeat(rng.choice(n, 3, replace=False), 600)])
    cols = np.concatenate([band.col, rng.integers(0, n, 7800)])
    vals = np.concatenate([band.val, rng.uniform(1, 2, 7800)])
    return COOMatrix.from_triplets(n, n, rows, cols, vals, sort=True,
                                   sum_duplicates=True)


def _unit_plans(coo, planes, m=8):
    """Each package's unit-mode slab plan at ``planes`` (16: pair
    blocks)."""
    fixed = {"mode": "unit", "kblk": 1, "m": m, "t": 32, "planes": planes}
    rows, cols = coo.row.astype(np.int64), coo.col.astype(np.int64)
    plans = []
    for mod in (ref_slab, slab):
        p = mod._estimate_cols(rows, cols, coo.nnz, fixed=fixed)
        assert p["feasible"]
        p.update(hub_cols=None, cols_eff=None, hub_off=0)
        plans.append(p)
    return plans


def _xch_plans(coo, cfg):
    """Each package's xch plan at T 32 for both passes."""
    fix = {"t1_fix": 32, "t2_fix": 32}
    return (ref_xch.estimate(coo, cfg) | fix,
            xch.estimate(port_coo(coo), port_cfg(cfg)) | fix)


SCATTERED = lambda: powerlaw(1500, 8000, seed=2)             # noqa: E731
BAND = lambda: generate("band", 512, 5, seed=1)             # noqa: E731
# case → (format, matrix, Config fields, plans (reference, port) or None,
#         the B the reference runs at)
CASES = {
    "csr": ("csr", BAND, {}, None, 32),
    "ell": ("ell", BAND, {}, None, 16),
    "dense": ("dense", BAND, {}, None, 8),
    "bsr-ell": ("bsr", lambda: generate("band", 2000, 8, seed=1), {}, None,
                5),
    "bsr-chunked": ("bsr", lambda: generate("unbalance", 2000, seed=1), {},
                    None, 32),
    "slab-unit8": ("slab", SCATTERED, {},
                   lambda c: _unit_plans(c, 8), 2),
    "slab-unit16": ("slab", SCATTERED, {},
                    lambda c: _unit_plans(c, 16), 2),
    "slab-blk": ("slab", lambda: powerlaw(1500, 8000, seed=3), {}, None, 2),
    "xch-peel-long": ("xch", _peel_long, {},
                      lambda c: _xch_plans(c, Config(format="xch",
                                                     dtype=BF16)), 2),
    "hyb": ("hyb", lambda: _mixed(1500, 7, 6, 3), {}, None, 2),
    "ellg": ("ellg", lambda: generate("band", 2048, 3, seed=5), {}, None, 2),
    "css": ("css", lambda: powerlaw(1500, 9000, seed=2),
            {"segment_width": 256}, None, 2),
    "auto": ("auto", lambda: powerlaw(1500, 9000, seed=2), {"spmm_b": 8},
             None, 8),
}


def _cfg(case):
    fmt, _, extra, _, _ = CASES[case]
    return Config(format=fmt, dtype=BF16, **extra)


@functools.lru_cache(maxsize=None)
def _coo(case):
    return CASES[case][1]()


@functools.lru_cache(maxsize=None)
def _plans(case):
    make = CASES[case][3]
    return make(_coo(case)) if make else (None, None)


@functools.lru_cache(maxsize=None)
def _port_state(case):
    kw = {"plan": _plans(case)[1]} if _plans(case)[1] else {}
    return formats.get_format(CASES[case][0]).convert(
        port_coo(_coo(case)), port_cfg(_cfg(case)), **kw)


def _panel(n_col, n_cols, seed):
    """(X as float32, X rounded to bfloat16 as float32)."""
    X = np.random.default_rng(seed).uniform(-1.0, 1.0, (n_col, n_cols)
                                            ).astype(np.float32)
    return X, round_values(X, BF16)


def _port_bounds(coo, st, fmt, Xh):
    """Per column b: (the float64 oracle of the stored values, the port's
    bound b_i), each (n_row, B)."""
    sc = stored(port_coo(coo))
    r, b = [], []
    for j in range(Xh.shape[1]):
        xh = Xh[:, j].astype(np.float64)
        r.append(port_oracle(sc, xh))
        b.append(accuracy_bound(sc, xh, st, fmt, value_tensor(Xh[:, j],
                                                              BF16)))
    return np.stack(r, 1), np.stack(b, 1)


def _check_port(case, n_cols, seed):
    coo, st = _coo(case), _port_state(case)
    fmt = CASES[case][0]
    X, Xh = _panel(coo.n_col, n_cols, seed)
    Y = formats.spmm_fn(port_cfg(_cfg(case)))(st, value_tensor(Xh, BF16))
    assert Y.dtype == torch.bfloat16 and Y.shape == (coo.n_row, n_cols)
    y = to_host(Y).astype(np.float64)
    r, bound = _port_bounds(coo, st, fmt, Xh)
    err = np.abs(y - r)
    assert (err <= bound).all(), (case, n_cols, float(np.max(err / bound)))
    for j in range(n_cols):
        ok, det = verify_result(coo, Xh[:, j], y[:, j],
                                dtype=ml_dtypes.bfloat16)
        assert ok, (case, j, det)
    return X, Xh, y, r, bound


@pytest.mark.parametrize("n_cols", WIDTHS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_port_spmm_within_its_bound(case, n_cols):
    """Every column of the port's bfloat16 Y within the accuracy bound of
    the oracle of the stored values, and passing the bfloat16 Verify."""
    _check_port(case, n_cols, seed=n_cols)


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_and_reference_agree_at_bfloat16(case):
    fmt, _, _, _, n_cols = CASES[case]
    coo, cfg = _coo(case), _cfg(case)
    X, Xh, y, r, bound = _check_port(case, n_cols, seed=100 + n_cols)
    kw = {"plan": _plans(case)[0]} if _plans(case)[0] else {}
    ref_state = ref_base.get_format(fmt).convert(coo, cfg, **kw)
    if case == "auto":
        assert _port_state(case).chosen == ref_state.chosen
    y_ref = np.asarray(ref_base.spmm_fn(cfg)(
        ref_state, jnp.asarray(X.astype(ml_dtypes.bfloat16))))
    assert y_ref.dtype == ml_dtypes.bfloat16
    y_ref = y_ref.astype(np.float64)
    for j in range(n_cols):
        ok, det = verify_result(coo, X[:, j], y_ref[:, j],
                                dtype=ml_dtypes.bfloat16)
        assert ok, (case, j, det)
        ref_bound = _bounds(coo, X[:, j])
        r_ref = reference_spmv(coo, X[:, j])
        assert (np.abs(y_ref[:, j] - r_ref) <= ref_bound).all(), (case, j)
        assert (np.abs(y[:, j] - y_ref[:, j]) <= bound[:, j] + ref_bound
                + np.abs(r[:, j] - r_ref)).all(), (case, j)


class _Panel(Exception):
    pass


class _Loop(Exception):
    pass


def _raise(exc):
    def fn(*a, **k):
        raise exc()
    return fn


@functools.lru_cache(maxsize=None)
def _gate_states(fmt):
    """(the reference's state, the port's) at bfloat16, one plan."""
    if fmt == "slab":
        coo = SCATTERED()
        ref_plan, plan = _unit_plans(coo, 8)
    else:
        coo = _peel_long()
        ref_plan, plan = _xch_plans(coo, Config(format="xch", dtype=BF16))
    cfg = Config(format=fmt, dtype=BF16)
    return (ref_base.get_format(fmt).convert(coo, cfg, plan=ref_plan),
            formats.get_format(fmt).convert(port_coo(coo), port_cfg(cfg),
                                            plan=plan))


def _branch(fn, *args):
    try:
        fn(*args)
    except _Panel:
        return "panel"
    except _Loop:
        return "loop"
    raise AssertionError("neither branch was taken")


@pytest.mark.parametrize("n_cols", [1, 2, 16, 17, 32, 33, "cap"])
@pytest.mark.parametrize("fmt", ["slab", "xch"])
def test_gate_parity(fmt, n_cols, monkeypatch):
    """For one state and B both packages take the same branch at
    bfloat16, panel or column loop; "cap": B = 2 with the x-table cap
    lowered, in both packages, to one byte under the panel's two tables
    of 2-byte values."""
    ref_st, st = _gate_states(fmt)
    if n_cols == "cap":
        n_cols = 2
        cap = 2 * st.cb_pad * 128 * 2 - 1
        for mod in (ref_slab, ref_xch, slab, xch):
            monkeypatch.setattr(mod, "X_TABLE_CAP", cap)
    if fmt == "slab":
        monkeypatch.setattr(ref_pallas_slab, "slab_spmm", _raise(_Panel))
        monkeypatch.setattr(ref_slab, "spmv", _raise(_Loop))
        monkeypatch.setattr(slab, "slab_spmm", _raise(_Panel))
        monkeypatch.setattr(slab, "column_loop", _raise(_Loop))
        ref_fn, fn = ref_slab.spmm, slab.spmm
    else:
        monkeypatch.setattr(ref_xch, "_spmm_panel_v4", _raise(_Panel))
        monkeypatch.setattr(ref_xch, "spmv", _raise(_Loop))
        monkeypatch.setattr(xch, "_spmm_panel_v4", _raise(_Panel))
        monkeypatch.setattr(xch, "column_loop", _raise(_Loop))
        ref_fn, fn = ref_xch.spmm, xch.spmm
    X = np.ones((st.n_col, n_cols), np.float32)
    want = _branch(ref_fn, ref_st, jnp.asarray(X.astype(ml_dtypes.bfloat16)))
    got = _branch(fn, st, value_tensor(X, BF16))
    assert got == want
    panel_b = slab.PANEL_B_MAX if fmt == "slab" else xch.PANEL_B_MAX
    capped = st.cb_pad * 128 * 2 * n_cols > (slab.X_TABLE_CAP if fmt ==
                                            "slab" else xch.X_TABLE_CAP)
    assert got == ("panel" if 2 <= n_cols <= panel_b and not capped
                   else "loop")


# ------------------------------------------------------------- ops level ---

SLAB_NAMES = ("uids", "sg0", "sg1", "win", "lane", "sub", "val", "hm1",
              "idx")
MUL_NAMES = ("win1", "lane1", "sub1", "val1")
ROUTE_NAMES = ("gids2", "off2", "cs2", "win2", "lane2", "sub2", "hm2", "sig2",
               "idx2")
OPS_B = 2


def _stream_args(st, names, c=0):
    """Call ``c`` of a reference state's streams, values rounded to
    bfloat16: (numpy for Pallas, torch for the port)."""
    arrs = []
    for n in names:
        a = np.asarray(getattr(st, n)[c])
        if a.dtype.kind == "f":
            a = a.astype(ml_dtypes.bfloat16)
        arrs.append(a)
    return arrs, [from_numpy(np.array(a)) for a in arrs]


def _bf16_panel(shape, seed):
    """A (B, ...) bfloat16 panel of the reference's layout, and the port's
    interleaved (..., B) one."""
    a = np.random.default_rng(seed).uniform(-1.0, 1.0, shape).astype(
        ml_dtypes.bfloat16)
    return a, from_numpy(np.ascontiguousarray(np.moveaxis(a, 0, -1)))


def _by_column(t):
    return np.moveaxis(to_host(t).astype(np.float64), -1, 0)


def _ref_out_bound(s_and_mass):
    """The Pallas kernels' bfloat16 rounding of products, prefixes and
    planes: 64 bfloat16 eps of the entry's Σ|p| and prefix mass, the
    backward term of the reference's own bfloat16 bound."""
    return 64.0 * U_BF16 * s_and_mass


def _slab_ops_state(m):
    coo = powerlaw(800, 4000, seed=2)
    ref_plan, _ = _unit_plans(coo, 16, m)
    st = ref_slab.convert(coo, Config(format="slab"), plan=ref_plan)
    assert (st.mode, st.m, len(st.uids)) == ("unit", m, 1)
    return st


def _xch_ops_state(m):
    from test_xch import _mix

    plan = ref_xch.estimate(_mix(2000, 8000, 0), Config(format="xch"))
    plan.update(m1_fix=m, t1_fix=32, m2_fix=m, t2_fix=32, kblk=4,
                kblk_fix=True, p_oh_fix=16)
    st = ref_xch.convert(_mix(2000, 8000, 0), Config(format="xch"),
                         plan=plan)
    assert (st.m1, st.m2) == (m, m)
    return st


@pytest.mark.parametrize("m", [1, 8])
def test_slab_spmm_plain_version_matches_pallas(m):
    st = _slab_ops_state(m)
    arrs, tens = _stream_args(st, SLAB_NAMES)
    xp, xpt = _bf16_panel((OPS_B, st.cb_pad, 128), seed=m)
    nu = st.chunk_nu[0]
    no_sg = [a for n, a in zip(SLAB_NAMES, arrs) if n not in ("sg0", "sg1")]
    want = np.asarray(pallas_spmm(*no_sg, xp, nu, st.m, st.t_step))
    assert want.dtype == ml_dtypes.bfloat16
    got = sops.slab_spmm(*tens, xpt, nu, st.m, st.t_step)
    assert got.dtype == torch.float32
    assert torch.equal(got, sops.slab_spmm_ref(*tens, xpt, nu, st.m,
                                               st.t_step))
    rest = (nu, st.m, st.t_step)
    exact, bound, s_abs = route_entry_bound(sops.slab_spmm_ref, tens, xpt,
                                            7, rest, val_at=6)
    keep = np.asarray(st.lo_mask)[:, 0] > 0       # the owned unit blocks
    planes = st.planes
    want = np.moveaxis(want.astype(np.float64).reshape(
        nu, OPS_B, planes, 128), 1, -1).reshape(exact.shape)
    got = got.numpy().astype(np.float64)
    blk = lambda a: a.reshape(nu, planes * 128, OPS_B)[keep]   # noqa: E731
    assert (np.abs(got - exact) <= bound).all()
    ref_b = _ref_out_bound(s_abs)
    assert (blk(np.abs(want - exact)) <= blk(ref_b)).all()
    assert (blk(np.abs(got - want)) <= blk(bound + ref_b)).all()


@pytest.mark.parametrize("m", [1, 8])
def test_xch_mul_panel_plain_version_matches_pallas_bit_for_bit(m):
    st = _xch_ops_state(m)
    arrs, tens = _stream_args(st, MUL_NAMES)
    xp, xpt = _bf16_panel((OPS_B, st.cb_pad, 128), seed=m)
    want = np.asarray(pallas_mul(*arrs, xp, st.m1, st.t1))
    got = xops.xch_mul_panel(*tens, xpt, st.m1, st.t1)
    assert want.dtype == ml_dtypes.bfloat16 and got.dtype == torch.bfloat16
    assert got.shape == (st.n_slots1 // 128, 128, OPS_B)
    assert np.array_equal(np.moveaxis(got.view(torch.int16).numpy(), -1, 0),
                          want.view(np.int16))
    # one rounding of the float32 product, as xch_mul rounds it
    assert torch.equal(got[..., 1], xops.xch_mul_ref(
        *tens, xpt[..., 1].contiguous(), st.m1, st.t1))


@pytest.mark.parametrize("m", [1, 8])
def test_xch_route4_panel_plain_version_matches_pallas(m):
    st = _xch_ops_state(m)
    arrs, tens = _stream_args(st, ROUTE_NAMES)
    prod, prodt = _bf16_panel((OPS_B, st.n_chunks, st.p1, 128), seed=10 + m)
    g = (st.chunk_ngrp[0], st.gb, st.m2, st.t2, st.p_oh)
    want = np.asarray(pallas_route(*arrs, prod, *g))
    assert want.dtype == ml_dtypes.bfloat16
    want = want.astype(np.float64)
    got = xops.xch_route4_panel(*tens, prodt, *g)
    assert got.dtype == torch.float32
    assert torch.equal(got, xops.xch_route4_panel_ref(*tens, prodt, *g))
    exact, bound, s_abs = route_entry_bound(xops.xch_route4_panel_ref,
                                            tens, prodt, 6, g)
    exact, bound, s_abs = (np.moveaxis(a, -1, 0) for a in (exact, bound,
                                                            s_abs))
    got = _by_column(got)
    ref_b = _ref_out_bound(s_abs)
    assert (np.abs(got - exact) <= bound).all()
    assert (np.abs(want - exact) <= ref_b).all()
    assert (np.abs(got - want) <= bound + ref_b).all()


# ------------------------------------------------------- a dropped product -

@pytest.mark.parametrize("case", ["slab-unit16", "xch-peel-long", "csr"])
def test_a_dropped_product_fails(case):
    """A port that loses one product fails its bound: of the products the
    reference's oracle bound cannot see (|p| within 2× that bound of its
    row), the one largest against the port's bound is zeroed in the matrix
    the port converts (under the same plan), and the column that reads it
    leaves the bound."""
    coo, st = _coo(case), _port_state(case)
    fmt = CASES[case][0]
    X, Xh = _panel(coo.n_col, 8, seed=21)
    r, bound = _port_bounds(coo, st, fmt, Xh)
    sc = stored(port_coo(coo))
    p = np.abs(sc.val[:, None] * Xh[sc.col].astype(np.float64))  # (nnz, B)
    ref_b = np.stack([_bounds(coo, X[:, j]) for j in range(8)], 1)
    hidden = p <= 2.0 * ref_b[sc.row]
    assert hidden.any()
    j, b = np.unravel_index(
        int(np.argmax(np.where(hidden, p / bound[sc.row], -1.0))), p.shape)
    val = coo.val.copy()
    val[j] = 0.0
    bad = PortCOO(coo.n_row, coo.n_col, coo.row, coo.col, val)
    kw = {"plan": _plans(case)[1]} if _plans(case)[1] else {}
    bst = formats.get_format(fmt).convert(bad, port_cfg(_cfg(case)), **kw)
    Y = formats.spmm_fn(port_cfg(_cfg(case)))(bst, value_tensor(Xh, BF16))
    i = int(sc.row[j])
    got = float(to_host(Y)[i, b])
    assert abs(got - r[i, b]) > bound[i, b], (case, i, b, p[j, b])
