"""Port bkt stage B on the run-end stream, plain path: ``bkt.route_rows`` and
``ops.bucket.bucket_rows_ref`` against the reference's stage B.

``route_rows`` turns the reference's idx planes into a destination stream
in stage A's row order (``hm1r``, ``dest``) and a y-row table (``yrow``)
that folds in the inverse of the balance permutation.  Every routed idx
entry must land exactly once, where stage B's row order (the relayout
that ``stage_b_input`` makes) puts it.  ``bucket_rows_ref`` fed stage A's
products in place must equal the reference's stage B: its Pallas
``bucket_reduce`` (128-row buckets) or ``bucket_reduce_grouped`` (1024-row
buckets) in interpret mode, then, where balanced, ``lane_unpermute``, cut
to ``n_row``, on layouts of the reference's ``convert``: row groups 128 and
1024, balanced and not, one col-block a group (m = 1) and several, K from
1 to 4, S of one and of three stream rows, and the stream edited to mask
entries and to route runs to rows past ``n_row``.  Sums round in another
order (``torch.cumsum`` and ``index_add_`` against a triangle matmul and
per-σ sums): 1e-5·max|y|.  ``bkt.spmv`` still matches the reference's
spmv, composed of its Pallas kernels, and the float64 oracle
(``tests/test_torch_bkt_format.py`` holds it against the reference's
jitted ``spmv`` itself).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from singlespmv_tpu.config import Config
from singlespmv_tpu.core import verify_result
from singlespmv_tpu.data.generators import generate, powerlaw
from singlespmv_tpu.formats import bkt as ref_bkt
from singlespmv_tpu.ops.pallas import bucket as pallas
from singlespmv_tpu_torch.formats import bkt
from singlespmv_tpu_torch.ops import bucket as ops
from test_torch_bkt_ops import _scattered
from torch_parity import port_cfg, port_coo

TOL = 1e-5
LANES = 128
# the reference's kernels, jitted once so that a layout traces them once
_gather_mul = jax.jit(pallas.block_gather_mul, static_argnums=(5,))
_reduce = jax.jit(pallas.bucket_reduce, static_argnums=(3,))
_reduce_grouped = jax.jit(pallas.bucket_reduce_grouped, static_argnums=(3, 4))
_unpermute = jax.jit(pallas.lane_unpermute)

CASES = [
    # label, matrix, bkt_row_group, bkt_balance: (K, m, S) in the label
    ("g-K1-m1", lambda: generate("band", 2500, 8, seed=1), 1024, False),
    ("g-K1-m2", lambda: generate("band", 1100, 1, seed=1), 1024, False),
    ("g-K2-m1-bal", lambda: generate("band", 1500, 3, seed=1), 1024, True),
    ("g-K2-m2-bal", lambda: generate("band", 1100, 1, seed=1), 1024, True),
    ("g-K3-m1-bal", lambda: powerlaw(1500, 9000, seed=4), 1024, True),
    ("g-K4-m1", lambda: _scattered(1300, 2600, 3), 1024, False),
    ("g-K4-m2-bal", lambda: _scattered(5000, 10000, 12), 1024, True),
    ("b-S128-bal", lambda: _scattered(2000, 4000, 3), 128, True),
    ("b-S128", lambda: powerlaw(1500, 9000, seed=4), 128, False),
    ("b-S384", lambda: _scattered(2000, 60000, 9), 128, False),
    ("b-S128-band-bal", lambda: generate("band", 1500, 3, seed=1), 128,
     True),
]
IDS = [c[0] for c in CASES]
# the stream edited: entries masked, runs routed to rows past n_row
EDITED = [("g-K2-m1-bal", "masked"), ("g-K4-m1", "masked"),
          ("b-S128-bal", "masked"), ("b-S384", "masked"),
          ("g-K3-m1-bal", "past n_row"), ("g-K4-m1", "past n_row"),
          ("b-S128", "past n_row"), ("b-S128-band-bal", "past n_row")]

_COO, _STATES = {}, {}


def _coo(label):
    if label not in _COO:
        _COO[label] = next(c for c in CASES if c[0] == label)[1]()
    return _COO[label]


def _cfg(label):
    _, _, rg, bal = next(c for c in CASES if c[0] == label)
    return Config(format="bkt", bkt_row_group=rg, bkt_balance=bal)


def _ref_state(label):
    """The reference's bkt state of case ``label`` (converted once)."""
    if label not in _STATES:
        _STATES[label] = ref_bkt.convert(_coo(label), _cfg(label))
    return _STATES[label]


def _arrays(st, **edits):
    """The fields of a reference state as host arrays, with ``edits``."""
    out = {f.name: getattr(st, f.name) for f in dataclasses.fields(st)}
    out = {k: np.asarray(v) if hasattr(v, "shape") else v
           for k, v in out.items()}
    return out | edits


def _geometry(a):
    ru = a["row_group"] // LANES
    nu_pad = a["rb_pad"] // ru
    return ru, nu_pad, a["s"] // LANES, a["n_slots"] // LANES


def _row_a_of_b(port):
    """Stage A's row of each stage-B row: the relayout the first port's
    glue makes (``stage_b_input``) applied to the slot numbers."""
    slots = torch.arange(port.n_slots, dtype=torch.int64)
    b = bkt.stage_b_input(port, slots)
    if port.row_group == 1024:                      # (G_tot, NU_pad, 128)
        b = b.permute(1, 0, 2).reshape(-1, LANES)   # unit-major, as hm1
    return (b[:, 0] // LANES).numpy()


def _mask(a, seed=5):
    """A copy of the idx planes with a quarter of the routed entries -1."""
    idx = a["idx"].copy()
    on = np.flatnonzero(idx.reshape(-1) >= 0)
    pick = np.random.default_rng(seed).choice(on, len(on) // 4,
                                              replace=False)
    idx.reshape(-1)[pick] = -1
    return idx


def _past(a):
    """A copy of the idx planes routing runs to rows past n_row: bkt_g
    moves the last row unit's entries to σ 7 (a row-block past the matrix);
    bkt names end lanes in a row-unit past the matrix."""
    ru, nu_pad, sh, _ = _geometry(a)
    idx = a["idx"].copy()
    rb = -(-a["n_row"] // LANES)
    if ru == 8:
        n = (rb - 1) // 8                           # the last unit of rows
        assert 8 * n + 7 >= rb                      # σ 7 lies past n_row
        last = idx[n]
        on = last >= 0
        assert on.any()
        last[on] = 7 * LANES + (last[on] & (LANES - 1))
    else:
        assert nu_pad > rb                          # a unit past the matrix
        g = a["g"]
        n = nu_pad - 1                              # its rows: all -1
        rows = (n // 8) * idx.shape[0] // (nu_pad // 8) + np.arange(g) * 8 \
            + n % 8
        assert (idx[rows] < 0).all()
        idx[rows, 5] = 17
        idx[rows, 90] = 3
    return idx


def _reference_y(a, prod):
    """The reference's stage B on the products ``prod`` (stage A's order):
    the Pallas reduce in interpret mode, then lane_unpermute, cut to
    n_row, as ``singlespmv_tpu/formats/bkt.py:spmv`` composes them."""
    ru, nu_pad, sh, _ = _geometry(a)
    if ru == 8:
        y_tab = _reduce_grouped(prod.reshape(a["g_tot"], nu_pad, a["s"]),
                                a["hm1"], a["idx"], nu_pad, a["n_chunks"])
    else:
        p = (prod.reshape(a["g_tot"], nu_pad // 8, 8, sh, LANES)
             .transpose(1, 0, 3, 2, 4).reshape(nu_pad * a["g"], LANES))
        y_tab = _reduce(p, a["hm1"], a["idx"], nu_pad)
    y_tab = np.asarray(y_tab)
    if a["balanced"]:
        rbu = a["src_lane"].shape[1]
        y_t = np.zeros((LANES, rbu), np.float32)
        y_t[:, : a["rb_pad"]] = y_tab.T
        y_tab = np.asarray(_unpermute(y_t, a["src_lane"], a["src_chunk"])
                           )[:, : a["rb_pad"]].T
    return y_tab.reshape(-1)[: a["n_row"]]


def _port_y(port, prod):
    nu_pad, sh, _, h = bkt._unit_rows(port)
    y = torch.zeros(port.n_row)
    got = ops.bucket_rows(torch.from_numpy(prod).view(h, LANES), port.hm1r,
                          port.dest, port.yrow, y, sh, nu_pad)
    assert got is y
    return y.numpy()


def _close(got, want):
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def test_cases_cover_the_layouts():
    seen = {(st.row_group, st.balanced, st.m > 1, st.k, st.s)
            for st in map(_ref_state, IDS)}
    assert {k for rg, _, _, k, _ in seen if rg == 1024} == {1, 2, 3, 4}
    assert {(rg, bal) for rg, bal, *_ in seen} == {
        (128, True), (128, False), (1024, True), (1024, False)}
    assert {m for rg, _, m, _, _ in seen if rg == 1024} == {True, False}
    assert {s for *_, s in seen} == {128, 384}
    assert all(st.n_row % LANES for st in map(_ref_state, IDS)
               if st.row_group == 128)


@pytest.mark.parametrize("label", IDS)
def test_route_rows_routes_every_entry_once(label):
    st = _ref_state(label)
    a = _arrays(st)
    port = bkt.state_from_reference(a)
    ru, nu_pad, sh, h = _geometry(a)
    row_a = _row_a_of_b(port)
    hm1 = a["hm1"].reshape(-1, LANES)
    np.testing.assert_array_equal(port.hm1r.numpy()[row_a], hm1)
    dest = port.dest.numpy()
    assert dest.dtype == (np.int16 if ru == 8 else np.int8)
    want = np.full((h, LANES), -1, np.int64)
    idx = a["idx"]
    if ru == 8:
        g = a["g"]
        for n, k, c, lane in zip(*np.nonzero(idx >= 0)):
            v = int(idx[n, k, c, lane])
            r = row_a[n * g + c]
            assert want[r, v & 127] == -1               # named once
            want[r, v & 127] = (v >> 7) * LANES + lane
    else:
        blk = 8 * a["g"]                    # K planes of blk rows a block
        per_block = idx.shape[0] // (nu_pad // 8)
        for q, lane in zip(*np.nonzero(idx >= 0)):
            r = row_a[(q // per_block) * blk + q % blk]
            assert want[r, idx[q, lane]] == -1           # named once
            want[r, idx[q, lane]] = lane
    np.testing.assert_array_equal(dest, want)
    assert int((dest >= 0).sum()) == int((idx >= 0).sum())
    yrow = port.yrow.numpy()
    assert yrow.shape == (a["rb_pad"] * LANES,) and yrow.dtype == np.int32
    kept = np.sort(yrow[yrow >= 0])
    np.testing.assert_array_equal(kept, np.arange(a["n_row"]))   # a bijection
    if not a["balanced"]:
        np.testing.assert_array_equal(
            yrow, np.where(np.arange(len(yrow)) < a["n_row"],
                           np.arange(len(yrow)), -1))


@pytest.mark.parametrize("label", IDS)
def test_route_rows_merges_where_rows_end_many_runs(label):
    port = bkt.state_from_reference(_arrays(_ref_state(label)))
    _, _, g, h = bkt._unit_rows(port)
    many = int((port.dest >= 0).sum()) >= bkt.MERGE_ENDS * h
    assert port.parts == (-(-g // (8 * bkt.MERGE_ROWS)) if many else 0)


def test_route_rows_merges_no_row_that_names_a_unit_row_twice():
    a = _arrays(_ref_state("g-K4-m1"))
    assert bkt.state_from_reference(a).parts > 0
    # σ 7 for every entry of the last unit: entries of one bin lane in
    # one row now name the same unit row, which the merge kernel's plain
    # adds cannot take
    port = bkt.state_from_reference(a | {"idx": _past(a)})
    assert port.parts == 0


@pytest.mark.parametrize("rg", [128, 1024])
def test_route_rows_refuses_an_end_lane_named_twice(rg):
    label = "g-K4-m1" if rg == 1024 else "b-S128"
    a = _arrays(_ref_state(label))
    idx = a["idx"].copy()
    if rg == 1024:
        n, k, c, lane = (int(i[0]) for i in np.nonzero(idx >= 0))
        k2, lane2 = (int(i[0]) for i in np.nonzero(idx[n, :, c] < 0))
        # another plane or bin and another σ, the same end lane
        idx[n, k2, c, lane2] = (idx[n, k, c, lane] & 127) + LANES
    else:
        q, lane = (int(i[0]) for i in np.nonzero(idx >= 0))
        other = int(np.flatnonzero(idx[q] < 0)[0])
        idx[q, other] = idx[q, lane]   # another bin, the same end lane
    with pytest.raises(ValueError, match="named twice"):
        bkt.state_from_reference(a | {"idx": idx})


@pytest.mark.parametrize("label", IDS)
def test_bucket_rows_ref_matches_reference_stage_b(label):
    a = _arrays(_ref_state(label))
    prod = np.random.default_rng(2).uniform(
        -1, 1, a["n_slots"]).astype(np.float32)
    port = bkt.state_from_reference(a)
    before = ops.bucket_rows.launches
    _close(_port_y(port, prod), _reference_y(a, prod))
    assert ops.bucket_rows.launches == before           # CPU: plain version


@pytest.mark.parametrize("label,edit", EDITED,
                         ids=[f"{lb}-{e}" for lb, e in EDITED])
def test_bucket_rows_ref_matches_reference_on_edited_streams(label, edit):
    a = _arrays(_ref_state(label))
    idx = _mask(a) if edit == "masked" else _past(a)
    a = a | {"idx": idx}
    port = bkt.state_from_reference(a)
    assert int((port.dest >= 0).sum()) == int((idx >= 0).sum())
    if edit == "past n_row":     # some runs land on dropped rows
        nu_pad, sh, _, h = bkt._unit_rows(port)
        unit = (np.arange(h) // sh) % nu_pad
        d = port.dest.numpy().astype(np.int64)
        ends = np.nonzero(d >= 0)
        y_of = port.yrow.numpy()[unit[ends[0]] * port.row_group + d[ends]]
        assert (y_of < 0).any()
    prod = np.random.default_rng(3).uniform(
        -1, 1, a["n_slots"]).astype(np.float32)
    _close(_port_y(port, prod), _reference_y(a, prod))


@pytest.mark.parametrize("label", IDS)
def test_spmv_matches_reference_and_oracle(label):
    coo = _coo(label)
    port = bkt.convert(port_coo(coo), port_cfg(_cfg(label)))
    x = np.random.default_rng(4).uniform(-1, 1, coo.n_col).astype(
        np.float32)
    y = bkt.spmv(port, torch.from_numpy(x)).numpy()
    # the reference's spmv, composed of its Pallas kernels as its
    # formats/bkt.py:spmv composes them
    a = _arrays(_ref_state(label))
    xp = np.zeros(a["cb"] * LANES, np.float32)
    xp[: coo.n_col] = x
    prod = np.asarray(_gather_mul(a["members"], a["lane"], a["src"],
                                  a["val"], xp.reshape(-1, LANES), a["m"]))
    _close(y, _reference_y(a, prod.reshape(-1)))
    ok, det = verify_result(coo, x, y, dtype=np.float32)
    assert ok, det


@pytest.mark.parametrize("label", IDS)
def test_state_from_reference_derives_the_convert_stream(label):
    port = bkt.convert(port_coo(_coo(label)), port_cfg(_cfg(label)))
    carried = bkt.state_from_reference(_arrays(_ref_state(label)))
    for name in bkt.ROUTE_FIELDS:
        got, want = getattr(carried, name), getattr(port, name)
        if isinstance(want, torch.Tensor):
            assert got.dtype == want.dtype, name
            assert torch.equal(got, want), name
        else:
            assert got == want, name


def test_bucket_rows_checks_its_arguments():
    port = bkt.state_from_reference(_arrays(_ref_state("g-K4-m1")))
    nu_pad, sh, _, h = bkt._unit_rows(port)
    prod = torch.zeros(h, LANES)
    y = torch.zeros(port.n_row)
    args = (prod, port.hm1r, port.dest, port.yrow, y, sh, nu_pad)
    assert ops.bucket_rows(*args) is y
    with pytest.raises(TypeError, match="float32"):
        ops.bucket_rows(prod.double(), *args[1:])
    with pytest.raises(TypeError):                  # bkt_g's dest is int16
        ops.bucket_rows(prod, port.hm1r, port.dest.to(torch.int8),
                        *args[3:])
    with pytest.raises(ValueError):                 # not whole units
        ops.bucket_rows(prod[:-1], *args[1:])
    with pytest.raises(ValueError):                 # no row group of 512
        ops.bucket_rows(*args[:3], port.yrow[: nu_pad * 512], *args[4:])
    with pytest.raises(ValueError):                 # negative parts
        ops.bucket_rows(*args, -1)
    with pytest.raises(ValueError, match="cuda"):
        ops.bucket_rows(*(t.to("meta") for t in args[:5]), sh, nu_pad)
    # the designs compute the same function
    w = torch.from_numpy(np.random.default_rng(6).uniform(
        -1, 1, (h, LANES)).astype(np.float32))
    want = ops.bucket_rows(w, *args[1:4], torch.zeros(port.n_row), sh,
                           nu_pad).clone()
    for parts in (1, 3):
        got = ops.bucket_rows(w, *args[1:4], torch.zeros(port.n_row), sh,
                              nu_pad, parts)
        assert torch.equal(got, want)
