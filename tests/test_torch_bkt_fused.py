"""The bucket engine's fused kernels, plain path: ``bucket_fused_rows`` (bkt
and bkt_g: stage A's products made in registers and consumed by stage B in
the same launch) and ``ellg_rows`` (every ellg pass in one launch: the
products, each matrix row's t-slot sum and its add into y) on CPU tensors,
against the JAX package.

- ``bucket_fused_rows_ref`` on the port's state carried from the
  reference's (``state_from_reference``) against the reference's Pallas
  ``block_gather_mul`` in interpret mode followed by the port's stage B,
  ``bucket_rows_ref``, on the reference's layout, for every layout of
  ``tests/test_torch_bkt_ops.py`` (128-row and 1024-row buckets, balanced
  and not, m = 1 and m > 1), at float32 and bfloat16 (each product rounded
  once to bfloat16, as the reference's are ``val.dtype``), in each design
  of stage B (a warp a row; the merge kernel at ``MERGE_ROWS`` rows a warp
  and at one block a unit: ``parts`` picks a kernel, not a function): the
  products are the same, so y agrees to 1e-5·max|y| (the tolerance of
  ``tests/test_torch_bkt_rows.py``); and y against the float64 oracle
  (float32: ``verify_result``; bfloat16: ``torch_bounds.accuracy_bound`` of
  the oracle of the stored values).
- ``ellg_rows_ref`` against the reference's ellg spmv (its Pallas
  ``block_gather_mul`` at gran 128 in interpret mode, then its row sums
  and y-table adds) on the reference's state with its rest taken away, on
  ``tests/test_torch_ellg.py``'s spmv cases, a two-panel case (that
  file's cut of the x panel to 4 col-blocks) and a scattered case: full
  and non-full passes, t of 1, 2, 4, 8 and 32, m of 1, 2, 4 and 8, to
  1e-6·max|y| (that file's tolerance).
- The wrappers refuse what either stage refuses, run their plain versions
  on the CPU without moving a launch counter, and bkt's and ellg's spmv
  call them once a spmv (ellg: once for its passes, once more for a bkt_g
  rest).

Torch runs on one thread in each test.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from singlespmv_tpu import formats as ref_formats
from singlespmv_tpu.config import Config
from singlespmv_tpu.core import verify_result
from singlespmv_tpu.formats import bkt as ref_bkt
from singlespmv_tpu.formats import ellg as ref_ellg
from singlespmv_tpu.ops.pallas import bucket as pallas
from singlespmv_tpu_torch import formats
from singlespmv_tpu_torch.core.dtypes import round_values, value_tensor
from singlespmv_tpu_torch.core.oracle import reference_spmv as port_oracle
from singlespmv_tpu_torch.formats import bkt, ellg
from singlespmv_tpu_torch.ops import bucket as ops
from test_torch_bkt_ops import CASES as LAYOUTS
from test_torch_bkt_ops import IDS, _scattered
from test_torch_ellg import CASES as ELLG_CASES
from test_torch_ellg import local_rows
from torch_bounds import accuracy_bound, stored
from torch_parity import port_cfg, port_coo

TOL = 1e-5          # bkt: tests/test_torch_bkt_rows.py's, of max|y|
ELLG_TOL = 1e-6     # ellg: tests/test_torch_ellg.py's, of max|y|
LANES = 128
DTYPES = ("float32", "bfloat16")
DESIGNS = ("direct", "merge", "one-block")
# the Pallas stage A, jitted once a layout and value type
_gather_mul = jax.jit(pallas.block_gather_mul, static_argnums=(5, 6))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """torch on one thread in each test, put back after it: the suite's
    workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _host(obj):
    """A reference state as numpy arrays and scalars, as
    ``state_from_reference`` takes it."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _host(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, tuple):
        return tuple(_host(v) for v in obj)
    return np.asarray(obj) if hasattr(obj, "shape") else obj


_BKT = {}


def _bkt_case(label, dtype):
    """(coo, the reference's state, the port's state carried from it, x as
    float64 values of the type, the reference's products) of a layout."""
    key = (label, dtype)
    if key not in _BKT:
        _, make, rg, bal = next(c for c in LAYOUTS if c[0] == label)
        coo = make()
        ref = ref_bkt.convert(coo, Config(format="bkt", dtype=dtype,
                                          bkt_row_group=rg, bkt_balance=bal))
        port = bkt.state_from_reference(_host(ref))
        x = round_values(np.random.default_rng(4).uniform(-1, 1, coo.n_col),
                         dtype).astype(np.float64)
        np_type = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
        xp = np.zeros(ref.cb * LANES, np_type)
        xp[: coo.n_col] = x.astype(np_type)
        prod = np.asarray(_gather_mul(ref.members, ref.lane, ref.src,
                                      ref.val, jnp.asarray(xp).reshape(
                                          -1, LANES), ref.m, None))
        _BKT[key] = (coo, ref, port, x, prod)
    return _BKT[key]


def _parts(port, design):
    g = bkt._unit_rows(port)[2]
    return {"direct": 0, "merge": -(-g // (8 * bkt.MERGE_ROWS)),
            "one-block": 1}[design]


def _fused_args(port, x, dtype):
    """bucket_fused_rows' arguments for the port's state and x, y zeroed;
    ``parts`` and ``gran`` left to the caller."""
    nu_pad, sh = bkt._unit_rows(port)[:2]
    xt = bkt.x_table(port, value_tensor(x, dtype))
    return (port.members, port.lane, port.src, port.val, xt, port.m,
            port.hm1r, port.dest, port.yrow, torch.zeros(port.n_row), sh,
            nu_pad)


def test_layouts_cover_the_cases():
    seen = {(_bkt_case(c, "float32")[2].row_group,
             _bkt_case(c, "float32")[2].balanced,
             _bkt_case(c, "float32")[2].m > 1) for c in IDS}
    assert seen == {(128, True, False), (128, False, False),
                    (1024, True, False), (1024, False, True),
                    (1024, True, True)}


@pytest.mark.parametrize("design", DESIGNS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("label", IDS)
def test_fused_rows_ref_matches_pallas_stage_a_then_stage_b(label, dtype,
                                                            design):
    coo, ref, port, x, prod = _bkt_case(label, dtype)
    parts = _parts(port, design)
    args = _fused_args(port, x, dtype)
    assert args[3].dtype == getattr(torch, dtype)
    nu_pad, sh, _, h = bkt._unit_rows(port)
    counters = (ops.bucket_fused_rows.launches,
                ops.bucket_fused_rows.launches_bf16)
    got = ops.bucket_fused_rows(*args, parts)           # CPU: plain version
    assert (ops.bucket_fused_rows.launches,
            ops.bucket_fused_rows.launches_bf16) == counters
    assert got is args[9] and got.dtype == torch.float32
    assert torch.equal(got, ops.bucket_fused_rows_ref(
        *args[:9], torch.zeros(port.n_row), sh, nu_pad, parts))
    # the reference's products, then the port's stage B
    want = ops.bucket_rows_ref(
        value_tensor(prod.astype(np.float32), dtype).view(h, LANES),
        port.hm1r, port.dest, port.yrow, torch.zeros(port.n_row), sh,
        nu_pad, parts).numpy()
    y = got.numpy()
    assert np.abs(y - want).max() <= TOL * np.abs(want).max()
    if dtype == "float32":
        ok, det = verify_result(coo, x.astype(np.float32), y,
                                dtype=np.float32)
        assert ok, det
    else:
        sc = stored(port_coo(coo))
        bound = accuracy_bound(sc, x, port, "bkt_g" if port.row_group == 1024
                               else "bkt", value_tensor(x, dtype))
        assert (np.abs(y - port_oracle(sc, x)) <= bound).all()


@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_rows_ref_rounds_each_product_once(dtype):
    """At bfloat16 the plain version sums the products as stage A stores
    them, rounded once: the float32 sums of the unrounded products differ."""
    coo, ref, port, x, prod = _bkt_case("ru8-balanced-m4", dtype)
    args = _fused_args(port, x, dtype)
    got = ops.bucket_fused_rows_ref(*args)
    wide = [a.float() if isinstance(a, torch.Tensor) and a.is_floating_point()
            else a for a in args]
    wide[9] = torch.zeros(port.n_row)
    unrounded = ops.bucket_fused_rows_ref(*wide)
    assert torch.equal(got, unrounded) == (dtype == "float32")


# a refused call: (its error, {argument of _fused_args: replacement})
REFUSALS = {
    "float64": (TypeError, lambda a: {3: a[3].double(), 4: a[4].double()}),
    "mixed values": (TypeError, lambda a: {4: a[4].to(torch.bfloat16)}),
    "no src at m > 1": (ValueError, lambda a: {2: None}),
    "short members": (ValueError, lambda a: {0: a[0][:-1]}),
    "hm1r of another shape": (ValueError, lambda a: {6: a[6][:-1]}),
    "dest of another type": (TypeError, lambda a: {7: a[7].to(torch.int8)}),
    "yrow of no row group": (ValueError,
                             lambda a: {8: a[8][: a[11] * 512]}),
    "a float64 y": (TypeError, lambda a: {9: a[9].double()}),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_fused_rows_refuse(name):
    _, _, port, x, _ = _bkt_case("ru8-unbalanced-m4", "float32")
    assert port.m > 1 and port.row_group == 1024
    err, edits = REFUSALS[name]
    args = list(_fused_args(port, x, "float32"))
    for i, v in edits(args).items():
        args[i] = v
    with pytest.raises(err):
        ops.bucket_fused_rows(*args)


def test_fused_rows_refuse_a_gran_off_the_stream():
    _, _, port, x, _ = _bkt_case("ru8-unbalanced-m4", "float32")
    args = _fused_args(port, x, "float32")
    assert ops.bucket_fused_rows(*args, gran=1024) is args[9]
    for gran in (100, 3 * LANES, 0):
        with pytest.raises(ValueError):
            ops.bucket_fused_rows(*args, gran=gran)
    with pytest.raises(ValueError):                   # negative parts
        ops.bucket_fused_rows(*args, -1)
    with pytest.raises(ValueError, match="cuda"):
        ops.bucket_fused_rows(*(a.to("meta") if isinstance(a, torch.Tensor)
                                else a for a in args))


def test_bkt_spmv_is_one_fused_call(monkeypatch):
    _, _, port, x, _ = _bkt_case("ru1-balanced", "float32")
    calls = []
    real = bkt.bucket_fused_rows
    monkeypatch.setattr(bkt, "bucket_fused_rows",
                        lambda *a, **k: calls.append(a) or real(*a, **k))
    for name in ("block_gather_mul", "bucket_rows"):
        monkeypatch.setattr(ops, name, None)           # no pair on the path
    y = bkt.spmv(port, torch.from_numpy(x.astype(np.float32)))
    assert len(calls) == 1 and y.shape == (port.n_row,)


# ------------------------------------------------------------------ ellg ---

ELLG_PASS_CASES = {"tail": ELLG_CASES["tail"], "band": ELLG_CASES["band"],
                   # two panels under that file's cut, at half its size
                   "panels": lambda: local_rows(1000, 5, 200, seed=3),
                   "scattered": lambda: _scattered(1000, 6000, 2)}
_ELLG = {}


def _ellg_case(label):
    """(coo, the reference's state, the port's state carried from it) of
    an ellg case ("panels" converts with the x panel cut to 4 col-blocks in
    both packages)."""
    if label not in _ELLG:
        coo = ELLG_PASS_CASES[label]()
        with pytest.MonkeyPatch.context() as mp:
            if label == "panels":
                mp.setattr(ref_ellg, "X_BLOCKS", 4)
                mp.setattr(ellg, "X_BLOCKS", 4)
            ref = ref_formats.convert(coo, Config(format="ellg"))
        _ELLG[label] = (coo, ref, ellg.state_from_reference(_host(ref)))
    return _ELLG[label]


def _xp(coo, x, dtype=torch.float32):
    xp = torch.zeros(-(-coo.n_col // LANES) * LANES, dtype=dtype)
    xp[: coo.n_col] = torch.from_numpy(x).to(dtype)
    return xp


def test_ellg_cases_cover_the_passes():
    passes = [p for k in ELLG_PASS_CASES
              for p in _ellg_case(k)[2].passes]
    assert {p.t for p in passes} >= {1, 2, 4, 8, 32}
    assert {p.m for p in passes} >= {1, 2, 4, 8}
    assert {p.full for p in passes} == {True, False}
    assert len({p.panel_base for p in _ellg_case("panels")[2].passes}) > 1


@pytest.mark.parametrize("label", sorted(ELLG_PASS_CASES))
def test_ellg_rows_ref_matches_reference_passes(label):
    coo, ref, port = _ellg_case(label)
    x = np.random.default_rng(3).uniform(-1, 1, coo.n_col).astype(
        np.float32)
    # the reference's spmv of its passes alone
    no_rest = dataclasses.replace(ref, rest_fmt="", rest_state=None)
    want = np.asarray(jax.jit(ref_formats.spmv_fn(Config(format="ellg")))(
        no_rest, x))
    before = (ops.ellg_rows.launches, ops.ellg_rows.launches_bf16)
    y = torch.zeros(port.n_row)
    table = ellg.row_passes(port.passes)
    got = ops.ellg_rows(table, _xp(coo, x), y)    # CPU: plain version
    assert (ops.ellg_rows.launches, ops.ellg_rows.launches_bf16) == before
    assert got is y
    assert torch.equal(got, ops.ellg_rows_ref(table, _xp(coo, x),
                                              torch.zeros(port.n_row)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=ELLG_TOL * np.abs(want).max())


def test_ellg_adds_per_row():
    """One add a pass that reaches a row, then the rest's own count (bkt_g:
    its run ends; csr: one); ``formats.adds_per_row`` reads it."""
    _, _, port = _ellg_case("tail")
    assert port.rest_fmt == "bkt_g"
    rb = -(-port.n_row // LANES)
    reach = np.zeros(rb, np.int64)
    for p in port.passes:
        b = np.arange(p.n_blocks) if p.full else np.unique(p.blocks.numpy())
        reach[b[b < rb]] += 1
    want = np.repeat(reach, LANES)[: port.n_row] \
        + bkt.adds_per_row(port.rest_state)
    got = formats.adds_per_row(port, port_cfg(Config(format="ellg")))
    np.testing.assert_array_equal(got, want)
    csr_rest = dataclasses.replace(port, rest_fmt="csr")
    np.testing.assert_array_equal(
        ellg.adds_per_row(csr_rest), np.repeat(reach, LANES)[: port.n_row]
        + 1)


def test_ellg_spmv_is_one_pass_call_and_the_rest(monkeypatch):
    coo, _, port = _ellg_case("tail")
    calls = []
    for mod, name in ((ellg, "ellg_rows"), (bkt, "bucket_fused_rows")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, real=real, name=name, **k:
                            calls.append(name) or real(*a, **k))
    monkeypatch.setattr(ops, "block_gather_mul", None)  # no stage A alone
    x = torch.linspace(-1, 1, coo.n_col)
    ellg.spmv(port, x)
    assert calls == ["ellg_rows", "bucket_fused_rows"]


PASS_EDITS = ("float64", "t not a power of two", "no src at m > 1",
              "no blocks off a full pass", "a panel past x", "short members")


@pytest.mark.parametrize("edit", PASS_EDITS)
def test_ellg_rows_refuse(edit):
    coo, _, port = _ellg_case("tail")
    fits = {"no src at m > 1": lambda q: q.m > 1,
            "no blocks off a full pass": lambda q: not q.full}
    p = next(q for q in port.passes if fits.get(edit, bool)(q))
    bad = dataclasses.replace(p, **{
        "float64": dict(val=p.val.double()),
        "t not a power of two": dict(t=3),
        "no src at m > 1": dict(src=None),
        "no blocks off a full pass": dict(blocks=None),
        "a panel past x": dict(panel_base=10 ** 6),
        "short members": dict(members=p.members[:-1]),
    }[edit])
    xp = _xp(coo, np.zeros(coo.n_col, np.float32))
    assert ops.ellg_rows(ellg.row_passes([p]), xp,
                         torch.zeros(port.n_row)).shape == (port.n_row,)
    with pytest.raises(TypeError if edit == "float64" else ValueError):
        ops.ellg_rows(ellg.row_passes([bad]), xp, torch.zeros(port.n_row))
