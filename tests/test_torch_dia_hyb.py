"""Port dia and hyb formats against the reference's, at float32 and float64:
convert parity (the diagonal table, the peel plan, the residual engine),
spmv against the reference's spmv on CPU JAX and against the float64
oracle, round trips, reports, and the driver on the CPU.

dia's table and hyb's peel are the same numpy code in both packages, so
their arrays must be equal.  The port sums over the diagonals and through
its residual engine in another order, so outputs agree to 1e-5·max|y_ref|
at float32 and 1e-11·max|y_ref| at float64.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from singlespmv_tpu.config import Config
from singlespmv_tpu.core import verify_result
from singlespmv_tpu.core.oracle import reference_spmv
from singlespmv_tpu.core.types import COOMatrix
from singlespmv_tpu.data.generators import generate
from singlespmv_tpu.formats import auto as ref_auto
from singlespmv_tpu.formats import dia as ref_dia
from singlespmv_tpu.formats import hyb as ref_hyb
from singlespmv_tpu_torch import formats
from singlespmv_tpu_torch.formats import auto as port_auto
from singlespmv_tpu_torch.formats import dia, hyb
from singlespmv_tpu_torch.harness import run_benchmark
from torch_parity import port_cfg, port_coo

TOL = {"float32": 1e-5, "float64": 1e-11}
DTYPES = ["float32", "float64"]


def _cfg(fmt, dtype):
    return Config(format=fmt, dtype=dtype)


def _x(coo, dtype, seed=3):
    return np.random.default_rng(seed).uniform(-1, 1, coo.n_col).astype(
        dtype)


def _close(got, want, dtype):
    assert got.dtype == np.dtype(dtype) and got.shape == want.shape
    assert np.abs(got - want).max() <= TOL[dtype] * np.abs(want).max()


def _oracle_rel(coo, x, y):
    ref = reference_spmv(coo, x)
    return np.abs(y - ref).max() / max(np.abs(ref).max(), 1e-300)


def _band(n_row, n_col, offsets, seed):
    """Full diagonals at ``offsets`` of an n_row × n_col matrix."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for o in offsets:
        r = np.arange(max(0, -o), min(n_row, n_col - o))
        rows.append(r)
        cols.append(r + o)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    return COOMatrix.from_triplets(n_row, n_col, rows, cols,
                                   rng.uniform(-1, 2, len(rows)), sort=True)


def _mixed(n=2000, seed=1, k=6, scatter=2):
    """Band + scattered mixture (``tests/test_hyb.py``'s shape)."""
    rng = np.random.default_rng(seed)
    band = generate("band", n, k, seed=seed)
    sc_r = rng.integers(0, n, n * scatter)
    sc_c = rng.integers(0, n, n * scatter)
    return COOMatrix.from_triplets(
        n, n, np.concatenate([band.row, sc_r]),
        np.concatenate([band.col, sc_c]),
        np.concatenate([band.val, rng.uniform(-1, 1, sc_r.size)]),
        sort=True, sum_duplicates=True)


def _host(state):
    """A reference state's fields as numpy arrays and scalars."""
    return {f.name: (np.asarray(v) if hasattr(v, "shape") else v)
            for f in dataclasses.fields(state)
            for v in [getattr(state, f.name)]}


BANDS = [
    ("square", lambda: _band(900, 900, (-7, -1, 0, 2, 40), seed=1)),
    ("wide", lambda: _band(600, 1000, (-3, 0, 5, 350), seed=2)),
    ("tall", lambda: _band(1000, 640, (-300, -2, 0, 1), seed=3)),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("label,make", BANDS, ids=[b[0] for b in BANDS])
def test_dia_matches_reference(label, make, dtype):
    coo = make()
    cfg = _cfg("dia", dtype)
    ref, port = ref_dia.convert(coo, cfg), dia.convert(port_coo(coo),
                                                       port_cfg(cfg))
    for k in ("n_diag", "n_row_pad", "x_pad_left", "x_pad_len", "offsets"):
        assert getattr(port, k) == getattr(ref, k), k
    np.testing.assert_array_equal(port.diag.numpy(), np.asarray(ref.diag))
    x = _x(coo, dtype)
    y = dia.spmv(port, torch.from_numpy(x)).numpy()
    _close(y, np.asarray(jax.jit(ref_dia.spmv)(ref, x)), dtype)
    assert _oracle_rel(coo, x, y) <= TOL[dtype] / 10
    carried = dia.state_from_reference(_host(ref))
    np.testing.assert_array_equal(dia.spmv(carried, torch.from_numpy(x)),
                                  y)
    back = formats.to_coo(port, port_cfg(cfg))
    np.testing.assert_array_equal(back.to_dense(),
                                  coo.to_dense().astype(dtype))
    pcfg = port_cfg(cfg)
    assert formats.report_fields(port, pcfg) == ref_dia.report_fields(ref,
                                                                      cfg)
    assert formats.traffic_bytes(port, pcfg) == ref_dia.traffic_bytes(ref,
                                                                      cfg)


def test_dia_density_guard_and_dtypes(monkeypatch):
    coo = _band(300, 300, (-1, 0, 1), seed=4)
    monkeypatch.setattr(dia, "MAX_DIA_ELEMENTS", 2 * 384)
    with pytest.raises(ValueError, match="density guard"):
        dia.convert(port_coo(coo), port_cfg(_cfg("dia", "float32")))
    monkeypatch.undo()
    # bfloat16 is ported: dia converts it and verifies
    sb = dia.convert(port_coo(coo), port_cfg(_cfg("dia", "bfloat16")))
    x = np.random.default_rng(0).uniform(size=300)
    yb = dia.spmv(sb, torch.from_numpy(x).to(torch.bfloat16))
    assert sb.diag.dtype == yb.dtype == torch.bfloat16
    assert verify_result(coo, x, yb.float().numpy(), dtype="bfloat16")[0]
    st = dia.convert(port_coo(coo), port_cfg(_cfg("dia", "float64")))
    with pytest.raises(TypeError):
        dia.spmv(st, torch.zeros(300, dtype=torch.float32))


def _hyb_pair(coo, cfg):
    ref, port = ref_hyb.convert(coo, cfg), hyb.convert(port_coo(coo),
                                                       port_cfg(cfg))
    assert port.rest_fmt == ref.rest_fmt
    assert port.peel_nnz == ref.peel_nnz
    assert port.dia_state.offsets == ref.dia_state.offsets
    np.testing.assert_array_equal(port.dia_state.diag.numpy(),
                                  np.asarray(ref.dia_state.diag))
    return ref, port


HYB = [
    ("band+scatter", lambda: _mixed(1200), "float32"),
    ("band+scatter", lambda: _mixed(1200), "float64"),
    ("denser-scatter", lambda: _mixed(1500, 4, 9, 8), "float32"),
]


@pytest.mark.parametrize("label,make,dtype", HYB,
                         ids=[f"{h[0]}-{h[2]}" for h in HYB])
def test_hyb_matches_reference(label, make, dtype):
    coo = make()
    cfg = _cfg("hyb", dtype)
    ref, port = _hyb_pair(coo, cfg)
    assert port.rest_fmt == "slab" and port.dia_state.n_diag > 5
    np.testing.assert_array_equal(
        np.asarray(hyb.plan_peel(port_coo(coo), port_cfg(cfg))[0]),
        np.asarray(ref_hyb.plan_peel(coo, cfg)[0]))
    x = _x(coo, dtype)
    y = hyb.spmv(port, torch.from_numpy(x)).numpy()
    _close(y, np.asarray(jax.jit(ref_hyb.spmv)(ref, x)), dtype)
    assert _oracle_rel(coo, x, y) <= TOL[dtype] / 10
    pcfg = port_cfg(cfg)
    assert formats.report_fields(port, pcfg) == ref_hyb.report_fields(ref,
                                                                      cfg)
    assert formats.traffic_bytes(port, pcfg) == ref_hyb.traffic_bytes(ref,
                                                                      cfg)
    back = formats.to_coo(port, port_cfg(cfg))
    np.testing.assert_allclose(back.to_dense(), coo.to_dense(),
                               rtol=1e-6 if dtype == "float32" else 0)


def test_hyb_residual_the_port_lacks():
    """The reference's residual here is bkt_g, which the port lacked until
    the bucket engine was ported: both packages now rank the residual with
    the same costs, pick bkt_g, and meet the oracle."""
    coo = _mixed(8000, 5, 7, 3)
    cfg = _cfg("hyb", "float32")
    ref = ref_hyb.convert(coo, cfg)
    port = hyb.convert(port_coo(coo), port_cfg(cfg))
    assert ref.rest_fmt == "bkt_g" and port.rest_fmt == "bkt_g"
    assert port.dia_state.offsets == ref.dia_state.offsets
    rest = hyb._split(port_coo(coo), np.asarray(port.dia_state.offsets),
                      port_cfg(cfg))[1]
    costs = port_auto.estimate_costs(rest, port_cfg(cfg), skip=("hyb",))
    ref_costs = ref_auto.estimate_costs(rest, cfg)
    for k, v in costs.items():
        assert v == pytest.approx(ref_costs[k], rel=1e-12), k
    assert min((k for k in costs if k in hyb.REST_MODULES),
               key=costs.get) == "bkt_g"
    x = _x(coo, np.float32)
    ok, det = verify_result(coo, x, hyb.spmv(port, torch.from_numpy(x))
                            .numpy(), dtype=np.float32)
    assert ok, det


def test_hyb_hyper_sparse_residual_rides_xch():
    """Past 500k rows at degree < 12 the reference skips slab and bkt for
    the residual: both packages peel the same offsets, and both rank xch,
    at the same cost, first of their residual engines."""
    n = 520_000
    band = _band(n, n, (-1, 0, 1), seed=6)
    rng = np.random.default_rng(6)
    r, c = rng.integers(0, n, n), rng.integers(0, n, n)
    coo = COOMatrix.from_triplets(
        n, n, np.concatenate([band.row, r]), np.concatenate([band.col, c]),
        np.concatenate([band.val, rng.uniform(-1, 1, n)]), sort=True,
        sum_duplicates=True)
    cfg = _cfg("hyb", "float32")
    offs, peel_nnz = hyb.plan_peel(port_coo(coo), port_cfg(cfg))
    ref_offs, ref_peel_nnz = ref_hyb.plan_peel(coo, cfg)
    np.testing.assert_array_equal(offs, ref_offs)
    assert peel_nnz == ref_peel_nnz and len(offs) == 3
    rest = hyb._split(port_coo(coo), offs, port_cfg(cfg))[1]
    ref_rest = ref_hyb._split(coo, ref_offs, cfg)[1]
    for k in ("row", "col", "val"):
        np.testing.assert_array_equal(getattr(rest, k), getattr(ref_rest, k))
    costs = port_auto.estimate_costs(rest, port_cfg(cfg), skip=("hyb",))
    ref_costs = ref_auto.estimate_costs(ref_rest, cfg)
    assert not {"slab", "bkt", "bkt_g"} & (set(costs) | set(ref_costs))
    ranked = sorted((k for k in costs if k in hyb.REST_MODULES),
                    key=costs.get)
    assert ranked[0] == "xch" and min(
        (k for k in ref_costs if k in ("bsr", "xch")),
        key=ref_costs.get) == "xch"
    assert costs["xch"] == pytest.approx(ref_costs["xch"], rel=1e-12)


def test_hyb_pure_band_and_state_moves():
    coo = generate("band", 512, 6, seed=1)
    cfg = _cfg("hyb", "float64")
    ref, port = _hyb_pair(coo, cfg)
    assert port.rest_fmt == "" and port.rest_state is None
    meta = _hyb_pair(_mixed(), cfg)[1].to("meta")
    assert meta.dia_state.diag.device.type == "meta"
    assert meta.rest_state.val[0].device.type == "meta"
    x = _x(coo, np.float64)
    y = hyb.spmv(port, torch.from_numpy(x)).numpy()
    assert _oracle_rel(coo, x, y) <= 1e-12
    assert formats.report_fields(port, port_cfg(cfg))["RestFormat"] == "NONE"


@pytest.mark.parametrize("fmt,dtype", [("slab", "float64"),
                                       ("xch", "float64"),
                                       ("hyb", "float64"),
                                       ("hyb", "float32")])
def test_run_benchmark_on_cpu(fmt, dtype):
    coo = _mixed(3000, 7, 6, 3)
    res = run_benchmark(port_coo(coo), port_cfg(_cfg(fmt, dtype)), quick=True,
                        device="cpu",
                        log=lambda msg: None)
    assert res.verify_ok and res.report["Verify"] == "PASS"
    assert res.report["Dtype"] == dtype and res.y.dtype == np.dtype(dtype)
    assert res.report["MatrixFormat"] == fmt.upper()
    if fmt == "hyb":
        assert res.report["RestFormat"] == "SLAB"
        assert res.report["PeelDiags"] > 5
    x = np.random.default_rng(3).uniform(0, 1, coo.n_col)   # run_benchmark's
    bound = 1e-12 if dtype == "float64" else 1e-5
    assert _oracle_rel(coo, x, res.y) <= bound
