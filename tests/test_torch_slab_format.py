"""Port slab format: the host layout builder against the reference convert,
the torch spmv glue against the reference spmv and the float64 oracle, and
the port's freedom from jax.

Convert is the same numpy code in both packages, so its arrays must be equal.
The spmv outputs agree to rtol 1e-5 with atol 1e-5·max|y|: the port takes
row prefixes and the diagonal shift-add in another summation order.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from conftest import all_test_matrices
from singlespmv_tpu.config import Config
from singlespmv_tpu.core import verify_result
from singlespmv_tpu.core.types import COOMatrix
from singlespmv_tpu.data.generators import generate, powerlaw
from singlespmv_tpu.formats import slab as ref_slab
from singlespmv_tpu_torch import formats
from singlespmv_tpu_torch.formats import slab
from torch_parity import port_cfg, port_coo

F32 = Config(format="slab", dtype="float32")
RTOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _hubby(n=200_000, seed=5):
    """Hyper-sparse rows plus 500 columns of degree 80: the planner
    relabels the hub columns into the x-table appendix."""
    rng = np.random.default_rng(seed)
    r = np.concatenate([rng.integers(0, n, 40000),
                        rng.integers(0, n, 40000)])
    c = np.concatenate([rng.integers(0, n, 40000),
                        np.repeat(rng.choice(n, 500, replace=False), 80)])
    return COOMatrix.from_triplets(n, n, r, c, rng.uniform(0.1, 1.0, len(r)),
                                   sort=True, sum_duplicates=True)


def _forced_plan(mod, coo, mode, kblk=1, planes=8, m=1, t=32):
    plan = mod._estimate_cols(coo.row.astype(np.int64),
                              coo.col.astype(np.int64), coo.nnz,
                              fixed={"mode": mode, "kblk": kblk, "m": m,
                                     "t": t, "planes": planes})
    if plan["feasible"]:
        plan.update(hub_cols=None, cols_eff=None, hub_off=0)
    return plan


def _assert_same_state(ref, port):
    """Every field equal to the reference's; the spmv route's stream, which
    the reference lacks, equal to ``route_rows`` of the reference's own
    arrays."""
    routes = slab.route_rows(ref)
    for f in dataclasses.fields(port):
        a = routes[f.name] if f.name in routes else getattr(ref, f.name)
        b = getattr(port, f.name)
        if isinstance(b, tuple) and b and isinstance(b[0], torch.Tensor):
            assert len(a) == len(b), f.name
            pairs = zip(a, b)
        elif isinstance(b, torch.Tensor):
            pairs = [(a, b)]
        else:
            assert a == b, (f.name, a, b)
            continue
        for x, y in pairs:
            x = np.asarray(x)
            assert x.dtype == y.numpy().dtype, f.name
            assert np.array_equal(x, y.numpy()), f.name


def _y_port(state, x):
    return slab.spmv(state, torch.from_numpy(x)).numpy()


def _y_ref(state, x):
    return np.asarray(jax.jit(ref_slab.spmv)(state, x))


def _assert_y_close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * max(np.abs(want).max(), 1e-30))


def _reference_arrays(st):
    """The reference state's fields on the host, as state_from_reference
    takes them."""
    out = {}
    for f in dataclasses.fields(st):
        v = getattr(st, f.name)
        if isinstance(v, tuple) and f.name != "chunk_nu":
            v = tuple(np.asarray(a) for a in v)
        elif hasattr(v, "shape"):
            v = np.asarray(v)
        out[f.name] = v
    return out


MATS = all_test_matrices()


@pytest.mark.parametrize("label,coo", MATS, ids=[n for n, _ in MATS])
def test_convert_parity_with_reference(label, coo):
    """Default plan and both forced modes give the reference's arrays."""
    ran = 0
    for mode in (None, "unit", "blk"):
        if mode is None:
            plans = (None, None)
        elif coo.nnz == 0:
            continue
        else:
            plans = (_forced_plan(ref_slab, coo, mode),
                     _forced_plan(slab, coo, mode))
            assert plans[0]["feasible"] == plans[1]["feasible"]
            if not plans[0]["feasible"]:
                continue
        ref = ref_slab.convert(coo, F32, plan=plans[0])
        port = slab.convert(port_coo(coo), port_cfg(F32), plan=plans[1])
        _assert_same_state(ref, port)
        ran += 1
    assert ran >= (1 if coo.nnz == 0 else 2)


@pytest.mark.parametrize("kblk,planes", [(2, 16), (4, 8)])
def test_convert_parity_blk_kblk(kblk, planes):
    coo = powerlaw(3000, 40000, seed=2)
    ref = ref_slab.convert(coo, F32, plan=_forced_plan(
        ref_slab, coo, "blk", kblk=kblk, planes=planes, m=8))
    port = slab.convert(port_coo(coo), port_cfg(F32), plan=_forced_plan(
        slab, coo, "blk", kblk=kblk, planes=planes, m=8))
    assert port.mode == "blk" and port.idx[0].shape[0] == kblk
    _assert_same_state(ref, port)


def test_estimate_parity_and_hub_appendix():
    coo = _hubby()
    a, b = ref_slab.estimate(coo, F32), slab.estimate(port_coo(coo),
                                                      port_cfg(F32))
    for k in ("feasible", "est_s", "slots", "m", "t", "planes", "mode",
              "kblk", "hub_off"):
        assert a[k] == b[k], k
    assert b["hub_cols"] is not None
    assert np.array_equal(a["hub_cols"], b["hub_cols"])
    port = slab.convert(port_coo(coo), port_cfg(F32))
    _assert_same_state(ref_slab.convert(coo, F32), port)
    assert port.hub_cols is not None and port.hub_off > 0
    x = np.random.default_rng(0).uniform(size=coo.n_col).astype(np.float32)
    ok, det = verify_result(coo, x, _y_port(port, x), dtype=np.float32)
    assert ok, det


def test_chunked_stream_parity(monkeypatch):
    """Streams split into several kernel calls: same arrays as the
    reference, and the same y as one call over the whole stream."""
    coo = powerlaw(8000, 30000, seed=6)
    x = np.random.default_rng(1).uniform(size=coo.n_col).astype(np.float32)
    for mode in ("unit", "blk"):
        whole = slab.convert(port_coo(coo), port_cfg(F32),
                             plan=_forced_plan(slab, coo, mode))
        with monkeypatch.context() as mp:
            for mod in (ref_slab, slab):
                mp.setattr(mod, "CHUNK_ROWS", 256)
            ref = ref_slab.convert(coo, F32, plan=_forced_plan(ref_slab, coo,
                                                               mode))
            port = slab.convert(port_coo(coo), port_cfg(F32),
                                plan=_forced_plan(slab, coo, mode))
        assert len(whole.uids) == 1 and len(port.uids) > 1
        assert sum(port.chunk_nu) == port.n_units
        _assert_same_state(ref, port)
        y = _y_port(port, x)
        np.testing.assert_array_equal(y, _y_port(whole, x))
        ok, det = verify_result(coo, x, y, dtype=np.float32)
        assert ok, f"{mode}: {det}"


SPMV_CASES = [
    ("band-default", lambda: generate("band", 1024, 8, seed=1), None),
    ("powerlaw-unit8", lambda: powerlaw(3000, 30000, seed=2),
     dict(mode="unit", planes=8, m=8)),
    ("powerlaw-unit16", lambda: powerlaw(3000, 30000, seed=2),
     dict(mode="unit", planes=16, m=1)),
    ("powerlaw-blk-k1", lambda: powerlaw(3000, 30000, seed=3),
     dict(mode="blk", kblk=1, planes=8, m=1)),
    # 3100 rows = 25 blocks: the last kblk group reaches past y's end
    ("powerlaw-blk-k2", lambda: powerlaw(3100, 30000, seed=3),
     dict(mode="blk", kblk=2, planes=16, m=8)),
    ("powerlaw-blk-k4", lambda: powerlaw(3100, 30000, seed=3),
     dict(mode="blk", kblk=4, planes=32, m=8)),
]


@pytest.mark.parametrize("label,make,forced", SPMV_CASES,
                         ids=[c[0] for c in SPMV_CASES])
def test_spmv_matches_reference_and_oracle(label, make, forced):
    coo = make()
    plans = (None, None) if forced is None else (
        _forced_plan(ref_slab, coo, **forced), _forced_plan(slab, coo,
                                                            **forced))
    ref = ref_slab.convert(coo, F32, plan=plans[0])
    port = slab.convert(port_coo(coo), port_cfg(F32), plan=plans[1])
    x = np.random.default_rng(3).uniform(-1, 1, coo.n_col).astype(np.float32)
    y = _y_port(port, x)
    assert y.shape == (coo.n_row,) and y.dtype == np.float32
    _assert_y_close(y, _y_ref(ref, x))
    ok, det = verify_result(coo, x, y, dtype=np.float32)
    assert ok, f"{label}: {det}"
    # state_from_reference carries the reference's layout across
    carried = slab.state_from_reference(_reference_arrays(ref))
    assert np.array_equal(_y_port(carried, x), y)


def test_empty_single_and_round_trip():
    empty = COOMatrix.from_triplets(64, 64, [], [], [], sort=True)
    st = slab.convert(port_coo(empty), port_cfg(F32))
    assert (_y_port(st, np.ones(64, np.float32)) == 0).all()
    single = COOMatrix.from_triplets(10, 10, [3], [7], [2.5], sort=True)
    y = _y_port(slab.convert(port_coo(single), port_cfg(F32)),
                np.arange(10, dtype=np.float32))
    want = np.zeros(10, np.float32)
    want[3] = 2.5 * 7
    np.testing.assert_array_equal(y, want)
    coo = powerlaw(2048, 16000, seed=9)
    st = slab.convert(port_coo(coo), port_cfg(F32))
    back = formats.to_coo(st, port_cfg(F32))
    np.testing.assert_allclose(back.to_dense(),
                               coo.to_dense().astype(np.float32), rtol=1e-6)


def test_reports_match_reference():
    coo = powerlaw(3000, 30000, seed=7)
    ref, port = ref_slab.convert(coo, F32), slab.convert(port_coo(coo),
                                                         port_cfg(F32))
    pcfg = port_cfg(F32)
    assert formats.report_fields(port, pcfg) == ref_slab.report_fields(ref,
                                                                       F32)
    assert formats.traffic_bytes(port, pcfg) == ref_slab.traffic_bytes(ref,
                                                                       F32)
    assert slab.attainable_seconds(port, port_cfg(F32)) == pytest.approx(
        ref_slab.attainable_seconds(ref, F32), rel=1e-12)


def test_state_moves_between_devices():
    st = slab.convert(port_coo(powerlaw(1000, 8000, seed=1)), port_cfg(F32))
    meta = st.to("meta")
    assert meta.val[0].device.type == "meta"
    assert meta.unit_ids.device.type == "meta"
    assert meta.chunk_nu == st.chunk_nu and st.val[0].device.type == "cpu"


@pytest.mark.parametrize("dtype", ["float64", "bfloat16"])
def test_other_dtypes_name_the_roadmap(dtype):
    """float64 is ported (native fp64), and so is bfloat16 (ROADMAP A.10:
    the state holds bfloat16 values and y verifies).  A state never takes
    an x of another value type."""
    coo = powerlaw(500, 3000, seed=1)
    st = slab.convert(port_coo(coo), port_cfg(F32))
    with pytest.raises(TypeError, match="float32 values"):
        slab.spmv(st, torch.zeros(coo.n_col, dtype=getattr(torch, dtype)))
    if dtype == "bfloat16":
        sb = slab.convert(port_coo(coo), port_cfg(F32.replace(dtype=dtype)))
        x = np.random.default_rng(0).uniform(size=coo.n_col)
        yb = slab.spmv(sb, torch.from_numpy(x).to(torch.bfloat16))
        assert sb.val[0].dtype == yb.dtype == torch.bfloat16
        assert verify_result(coo, x, yb.float().numpy(), dtype=dtype)[0]
        return
    st64 = slab.convert(port_coo(coo), port_cfg(F32.replace(dtype=dtype)))
    assert st64.mode == "unit" and st64.val[0].dtype == torch.float64
    df = ref_slab.convert(generate("band", 256, 4, seed=0),
                          F32.replace(dtype="float64"))
    carried = slab.state_from_reference(_reference_arrays(df))
    assert carried.val[0].dtype == torch.float64


def test_registry():
    from singlespmv_tpu_torch.formats import xch

    from singlespmv_tpu_torch.formats import auto, bkt

    from singlespmv_tpu.formats import available_formats as ref_available
    from singlespmv_tpu_torch.formats import ellg

    assert formats.available_formats() == [
        "auto", "bcoo", "bkt", "bsr", "coo", "crs", "csr", "csr5", "css",
        "dense", "dia", "ell", "ellg", "hostlib", "hyb", "jds", "mkl", "slab",
        "ss", "xch"]
    assert formats.available_formats() == ref_available()
    assert formats.spmv_fn(F32) is slab.spmv
    assert formats.spmv_fn(F32.replace(format="xch")) is xch.spmv
    assert formats.spmv_fn(F32.replace(format="bkt")) is bkt.spmv
    assert formats.spmv_fn(F32.replace(format="auto")) is auto.spmv
    assert formats.spmv_fn(F32.replace(format="ellg")) is ellg.spmv
    with pytest.raises(KeyError):        # auto's internal name only
        formats.get_format("bkt_g")


def test_port_never_imports_jax():
    """Import every module of the port (and chip_smoke) in a fresh process:
    jax must stay out of sys.modules.  A subprocess, because this test
    process imported jax in conftest."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import singlespmv_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "assert len(names) >= 10, names\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')))\n"
        "assert not bad, bad\n"
        "print('ok', len(names))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")
