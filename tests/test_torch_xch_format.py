"""Port xch format: the host layout builder against the reference convert
(recursively into the nested long-row state), the torch spmv glue against the
reference spmv and the float64 oracle, reports, round trip and the driver.

Convert is the same numpy code in both packages, so its arrays must be equal.
The spmv outputs agree to rtol 1e-5 with atol 1e-5·max|y|: the port takes
row prefixes and routes in another summation order.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from singlespmv_tpu.config import Config
from singlespmv_tpu.core import verify_result
from singlespmv_tpu.core.types import COOMatrix
from singlespmv_tpu.data.generators import generate
from singlespmv_tpu.formats import xch as ref_xch
from singlespmv_tpu_torch import formats
from singlespmv_tpu_torch.formats import xch
from singlespmv_tpu_torch.harness import run_benchmark
from test_torch_xch_ops import long_rows_matrix
from torch_parity import port_cfg, port_coo
from test_xch import _mix

F32 = Config(format="xch", dtype="float32")
RTOL = 1e-5


def _rect():
    rng = np.random.default_rng(2)
    return COOMatrix.from_triplets(
        600, 3000, rng.integers(0, 600, 4000), rng.integers(0, 3000, 4000),
        rng.uniform(1, 2, 4000), sort=True)


MATS = [
    ("circuit-mix", lambda: _mix(5000, 25000, 0)),
    ("web-hubs", lambda: _mix(4096, 16384, 1, local_frac=0.0, hub_cols=40)),
    ("dense-rows", lambda: _mix(3000, 20000, 2, dense_rows=4)),
    ("banded", lambda: _mix(2048, 14000, 4, local_frac=0.95)),
    ("tall", lambda: _mix(9000, 18000, 5)),
    ("rectangular", _rect),
    ("empty", lambda: COOMatrix.from_triplets(8, 8, [], [], [], sort=True)),
    ("long-rows", long_rows_matrix),
]


def _assert_same_state(ref, port, path=""):
    """Every field equal to the reference's; the spmv route's stream, which
    the reference lacks, equal to ``route_rows`` of the reference's own
    arrays."""
    routes = xch.route_rows(ref)
    for f in dataclasses.fields(port):
        a = routes[f.name] if f.name in routes else getattr(ref, f.name)
        b = getattr(port, f.name)
        name = path + f.name
        if isinstance(b, xch.Xch4State):
            _assert_same_state(a, b, name + ".")
            continue
        if isinstance(b, tuple) and b and isinstance(b[0], torch.Tensor):
            assert len(a) == len(b), name
            pairs = zip(a, b)
        elif isinstance(b, torch.Tensor):
            pairs = [(a, b)]
        else:
            assert a == b, (name, a, b)
            continue
        for x, y in pairs:
            x = np.asarray(x)
            assert x.dtype == y.numpy().dtype, name
            assert np.array_equal(x, y.numpy()), name


def _reference_arrays(st):
    """The reference state's fields on the host, as state_from_reference
    takes them; the nested state as such a dict in turn."""
    out = {}
    for f in dataclasses.fields(st):
        v = getattr(st, f.name)
        if isinstance(v, ref_xch.Xch4State):
            v = _reference_arrays(v)
        elif isinstance(v, tuple) and v and hasattr(v[0], "shape"):
            v = tuple(np.asarray(a) for a in v)
        elif hasattr(v, "shape"):
            v = np.asarray(v)
        out[f.name] = v
    return out


def _x(coo, seed=3):
    return np.random.default_rng(seed).uniform(-1, 1, coo.n_col).astype(
        np.float32)


def _y_port(state, x):
    return xch.spmv(state, torch.from_numpy(x)).numpy()


def _y_ref(state, x):
    return np.asarray(jax.jit(ref_xch.spmv)(state, x))


def _assert_y_close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("label,make", MATS, ids=[m[0] for m in MATS])
def test_convert_parity_with_reference(label, make):
    coo = make()
    ref, port = ref_xch.convert(coo, F32), xch.convert(port_coo(coo),
                                                       port_cfg(F32))
    _assert_same_state(ref, port)
    if label == "banded":
        assert len(port.dia_offs) > 1 and port.dia_vals is not None
    if label in ("dense-rows", "long-rows"):
        assert port.long is not None and port.long_n == len(port.long_rows)
    if label == "empty":
        assert port.n_slots1 == 0
    if coo.nnz:
        ok, det = verify_result(coo, _x(coo), _y_port(port, _x(coo)),
                                dtype=np.float32)
        assert ok, f"{label}: {det}"


@pytest.mark.parametrize("label,make", MATS[:6], ids=[m[0] for m in MATS[:6]])
def test_estimate_parity(label, make):
    coo = make()
    a, b = ref_xch.estimate(coo, F32), xch.estimate(port_coo(coo),
                                                    port_cfg(F32))
    assert a == b


def test_forced_plan_parity():
    coo = _mix(5000, 25000, 0)
    fix = dict(m1_fix=16, t1_fix=64, m2_fix=24, t2_fix=32, kblk=16,
               kblk_fix=True, p_oh_fix=40, k_slots=128 * 48)
    plans = []
    for mod in (ref_xch, xch):
        plans.append(mod.estimate(coo, F32) | fix)
    ref = ref_xch.convert(coo, F32, plan=plans[0])
    port = xch.convert(port_coo(coo), port_cfg(F32), plan=plans[1])
    assert (port.m1, port.m2, port.kblk, port.p_oh) == (16, 24, 16, 40)
    _assert_same_state(ref, port)


def test_chunked_streams(monkeypatch):
    """Pass 2 split into several calls gives the reference's arrays; pass 1
    split into several calls gives the same y as one call."""
    coo = _mix(60000, 150000, 0)
    x = _x(coo, 1)
    whole = xch.convert(port_coo(coo), port_cfg(F32))
    y_whole = _y_port(whole, x)
    assert len(whole.gids2) == 1 and len(whole.win1) == 1
    with monkeypatch.context() as mp:
        for mod in (ref_xch, xch):
            mp.setattr(mod, "CHUNK_ROWS", 8 * 64)
        ref = ref_xch.convert(coo, F32)
        port = xch.convert(port_coo(coo), port_cfg(F32))
    assert len(port.gids2) > 1
    assert sum(port.chunk_ngrp) == len(port.vis_gids)
    _assert_same_state(ref, port)
    _assert_y_close(_y_port(port, x), y_whole)
    with monkeypatch.context() as mp:
        mp.setattr(xch, "PASS1_CALL_ROWS", 300)
        split1 = xch.convert(port_coo(coo), port_cfg(F32))
    assert len(split1.win1) > 2
    assert sum(w.shape[0] for w in split1.win1) == split1.n_slots1 // 128
    y1 = _y_port(split1, x)
    np.testing.assert_array_equal(y1, y_whole)
    _assert_y_close(y1, _y_ref(ref_xch.convert(coo, F32), x))
    ok, det = verify_result(coo, x, y1, dtype=np.float32)
    assert ok, det


SPMV = ["circuit-mix", "banded", "long-rows"]


@pytest.mark.parametrize("label", SPMV)
def test_spmv_matches_reference_and_oracle(label):
    coo = dict(MATS)[label]()
    ref, port = ref_xch.convert(coo, F32), xch.convert(port_coo(coo),
                                                       port_cfg(F32))
    x = _x(coo)
    y = _y_port(port, x)
    assert y.shape == (coo.n_row,) and y.dtype == np.float32
    _assert_y_close(y, _y_ref(ref, x))
    ok, det = verify_result(coo, x, y, dtype=np.float32)
    assert ok, f"{label}: {det}"
    # state_from_reference carries the reference's layout across
    carried = xch.state_from_reference(_reference_arrays(ref))
    _assert_same_state(ref, carried)
    assert np.array_equal(_y_port(carried, x), y)


@pytest.mark.parametrize("label", ["circuit-mix", "banded", "long-rows"])
def test_round_trip_and_reports(label):
    coo = dict(MATS)[label]()
    ref, port = ref_xch.convert(coo, F32), xch.convert(port_coo(coo),
                                                       port_cfg(F32))
    back = formats.to_coo(port, port_cfg(F32))
    want = ref_xch.to_coo(ref)
    assert back.nnz == coo.nnz
    np.testing.assert_array_equal(back.row, want.row)
    np.testing.assert_array_equal(back.col, want.col)
    np.testing.assert_array_equal(back.val, want.val)
    pcfg = port_cfg(F32)
    assert formats.report_fields(port, pcfg) == ref_xch.report_fields(ref,
                                                                      F32)
    assert formats.traffic_bytes(port, pcfg) == ref_xch.traffic_bytes(ref,
                                                                      F32)
    assert xch.attainable_seconds(port, port_cfg(F32)) == pytest.approx(
        ref_xch.attainable_seconds(ref, F32), rel=1e-12)


def test_state_moves_nested_state():
    st = xch.convert(port_coo(long_rows_matrix()), port_cfg(F32))
    meta = st.to("meta")
    assert meta.long is not None and meta.long is not st.long
    assert meta.long.val1[0].device.type == "meta"
    assert meta.long.vis_gids.device.type == "meta"
    assert meta.long_rows.device.type == "meta"
    assert meta.chunk_ngrp == st.chunk_ngrp
    assert st.long.val1[0].device.type == "cpu"


@pytest.mark.parametrize("dtype", ["float64", "bfloat16"])
def test_other_dtypes_name_the_roadmap(dtype):
    """float64 is ported (native fp64), and so is bfloat16 (ROADMAP A.10:
    the state holds bfloat16 values and y verifies).  A state never takes
    an x of another value type."""
    coo = generate("band", 512, 5, seed=1)
    st = xch.convert(port_coo(coo), port_cfg(F32))
    with pytest.raises(TypeError, match="float32 values"):
        xch.spmv(st, torch.zeros(coo.n_col, dtype=getattr(torch, dtype)))
    if dtype == "bfloat16":
        sb = xch.convert(port_coo(coo), port_cfg(F32.replace(dtype=dtype)))
        x = np.random.default_rng(0).uniform(size=coo.n_col)
        yb = xch.spmv(sb, torch.from_numpy(x).to(torch.bfloat16))
        assert sb.val1[0].dtype == yb.dtype == torch.bfloat16
        assert verify_result(coo, x, yb.float().numpy(), dtype=dtype)[0]
        return
    assert xch.convert(port_coo(coo),
                       port_cfg(F32.replace(dtype=dtype))).val1[0].dtype \
        == torch.float64
    df = ref_xch.convert(_mix(2000, 9000, 3), F32.replace(dtype=dtype))
    carried = xch.state_from_reference(_reference_arrays(df))
    assert carried.val1[0].dtype == torch.float64


def test_run_benchmark_on_cpu():
    coo = _mix(6000, 30000, 6, dense_rows=3)
    res = run_benchmark(port_coo(coo), port_cfg(F32), quick=True, device="cpu",
                        log=lambda msg: None)
    assert res.verify_ok and res.report["Verify"] == "PASS"
    assert res.report["MatrixFormat"] == "XCH"
    assert res.y.shape == (coo.n_row,) and np.isfinite(res.y).all()
    want = ref_xch.report_fields(ref_xch.convert(coo, F32), F32)
    for k, v in want.items():
        assert res.report[k] == v, k
    assert "LongRows" in res.report
