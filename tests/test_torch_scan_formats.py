"""Port ss, css and csr5 against the reference: the host layouts, spmv,
``to_coo`` and the reports on the ``tests/conftest.py`` matrices, css's
padding guard, csr5 without a normal tile and its convert times across
``.to()``, and css and ss in auto's cost model and hyb's residual set.

Convert is the same numpy code in both packages, so every array must be
equal (the port stores the heads as uint8, the reference as bool).  The
reference runs its Pallas kernels in interpret mode (at float64 css's df64
kernel and log-tree combine), the port the kernels' plain versions: y agrees
to 1e-6 abs-or-rel at float32 (the oracle's bound) and to 1e-12·max|y| at
float64, which a float32 computation would not meet.

The reference's float64 convert turns ``jax_enable_x64`` on for good; every
test here puts the flag back as it found it.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from conftest import all_test_matrices, rand_x
from singlespmv_tpu.config import Config
from singlespmv_tpu.core.oracle import reference_spmv
from singlespmv_tpu.core.types import COOMatrix
from singlespmv_tpu.data.generators import generate, powerlaw
from singlespmv_tpu.formats import auto as ref_auto
from singlespmv_tpu.formats import csr5 as ref_csr5
from singlespmv_tpu.formats import css as ref_css
from singlespmv_tpu.formats import hyb as ref_hyb
from singlespmv_tpu.formats import ss as ref_ss
from singlespmv_tpu_torch import formats
from singlespmv_tpu_torch.core import create_random_vector, verify_result
from singlespmv_tpu_torch.formats import auto, csr5, css, hyb, ss
from singlespmv_tpu_torch.harness import run_benchmark
from singlespmv_tpu_torch.ops import segscan
from torch_parity import port_cfg, port_coo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# small widths keep the interpret-mode Pallas traces short
FORMATS = {
    "ss": (ss, ref_ss, dict(segment_width=256)),
    "css": (css, ref_css, dict(segment_width=256)),
    "css-simple": (css, ref_css, dict(variant="simple", n_block=3)),
    "csr5": (csr5, ref_csr5, dict(sigma=2)),
}
MATS = dict(all_test_matrices())
F64_MATS = ("10x10", "empty", "band-art-128", "random_unbalance-32",
            "powerlaw-256")


@pytest.fixture(autouse=True)
def _x64_scope():
    saved = jax.config.jax_enable_x64
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", saved)


def _cfg(fmt, dtype="float32"):
    mod, _, kw = FORMATS[fmt]
    return Config(format=fmt.split("-")[0], dtype=dtype, **kw)


def _host(st):
    return {f.name: (np.asarray(getattr(st, f.name))
                     if hasattr(getattr(st, f.name), "shape")
                     else getattr(st, f.name))
            for f in dataclasses.fields(st)}


def _assert_same_state(ref, port):
    """Every field of the port's state equal to the reference's; heads are
    uint8 here, bool there."""
    want = _host(ref)
    for f in dataclasses.fields(port):
        if f.name not in want:          # the port's own (csr5 convert_ms)
            continue
        a, b = want[f.name], getattr(port, f.name)
        if not isinstance(b, torch.Tensor):
            assert a == b, (f.name, a, b)
            continue
        b = b.numpy()
        if f.name == "heads":
            assert a.dtype == np.bool_ and b.dtype == np.uint8
            a = a.astype(np.uint8)
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(b, a, err_msg=f.name)


def _agree(got, want, dtype):
    got, want = np.asarray(got), np.asarray(want, dtype=np.float64)
    assert got.dtype == np.dtype(dtype) and got.shape == want.shape
    err = np.abs(got - want)
    if dtype == "float32":
        assert ((err <= 1e-6) | (err <= 1e-6 * np.abs(want))).all()
    else:
        assert err.max(initial=0) <= 1e-12 * max(np.abs(want).max(
            initial=0), 1e-300)


def _check_format(fmt, name, dtype):
    coo = MATS[name]
    mod, ref_mod, _ = FORMATS[fmt]
    cfg = _cfg(fmt, dtype)
    ref = ref_mod.convert(coo, cfg)
    port = mod.convert(port_coo(coo), port_cfg(cfg))
    _assert_same_state(ref, port)
    x = rand_x(coo.n_col).astype(dtype)
    y = mod.spmv(port, torch.from_numpy(x)).numpy()
    _agree(y, jax.jit(ref_mod.spmv)(ref, x), dtype)
    ok, det = verify_result(port_coo(coo), x, y, dtype=np.dtype(dtype))
    assert ok, det
    if dtype == "float64":
        _agree(y, reference_spmv(coo, x), dtype)
    back, want = mod.to_coo(port), ref_mod.to_coo(ref)
    for k in ("row", "col", "val"):
        np.testing.assert_array_equal(getattr(back, k), getattr(want, k))
    carried = mod.state_from_reference(_host(ref))
    assert torch.equal(mod.spmv(carried, torch.from_numpy(x)),
                       torch.from_numpy(y))
    rep, ref_rep = mod.report_fields(port, port_cfg(cfg)), \
        ref_mod.report_fields(ref, cfg)
    for k, v in ref_rep.items():
        if not k.startswith("Convert-"):
            assert rep[k] == v, k
    assert mod.traffic_bytes(port, port_cfg(cfg)) == \
        ref_mod.traffic_bytes(ref, cfg)


@pytest.mark.parametrize("name", list(MATS))
@pytest.mark.parametrize("fmt", list(FORMATS))
def test_format_matches_reference_f32(fmt, name):
    _check_format(fmt, name, "float32")


@pytest.mark.parametrize("name", F64_MATS)
@pytest.mark.parametrize("fmt", list(FORMATS))
def test_format_matches_reference_f64(fmt, name):
    """The reference's css holds float64 values in ``val`` beside its df64
    planes, so its state carries over field for field."""
    _check_format(fmt, name, "float64")


def _wide_sparse():
    """One nonzero in each of 20,000 column blocks: padding every block to
    a whole tile would take 20 M slots for 20 k nonzeros."""
    n = 20_000
    r = np.arange(n)
    return COOMatrix.from_triplets(n, 128 * n, r, 128 * r, np.ones(n),
                                   sort=True)


def test_css_padding_guard_is_a_value_error():
    coo = _wide_sparse()
    cfg = Config(format="css")
    with pytest.raises(ValueError, match="block padding"):
        ref_css.convert(coo, cfg)
    with pytest.raises(ValueError, match="block padding"):
        css.convert(port_coo(coo), port_cfg(cfg))
    # auto leaves it out the way the reference does, and auto's trials and
    # the driver's retry skip a ValueError
    got = auto.estimate_costs(port_coo(coo), port_cfg(cfg))
    assert "css" not in got and "css" not in ref_auto.estimate_costs(coo,
                                                                     cfg)
    assert ValueError in auto.GUARD_ERRORS


def _single_row_tiles():
    """Rows of 256 nonzeros each at σ = 2: every tile lies in one row."""
    rows = np.repeat(np.arange(6), 256)
    cols = np.tile(np.arange(256), 6)
    vals = np.random.default_rng(2).uniform(-1, 1, len(rows))
    return COOMatrix.from_triplets(8, 300, rows, cols, vals, sort=True)


def test_csr5_without_normal_tiles_launches_nothing(monkeypatch):
    coo = _single_row_tiles()
    cfg = _cfg("csr5")
    ref = ref_csr5.convert(coo, cfg)
    port = csr5.convert(port_coo(coo), port_cfg(cfg))
    assert port.n_normal == 0 and port.n_fast == 6
    _assert_same_state(ref, port)

    def never(*a, **k):
        raise AssertionError("a scan with no normal tile")

    monkeypatch.setattr(csr5, "segmented_scan_tiles", never)
    x = rand_x(coo.n_col).astype(np.float32)
    y = csr5.spmv(port, torch.from_numpy(x)).numpy()
    _agree(y, jax.jit(ref_csr5.spmv)(ref, x), "float32")


def test_csr5_convert_times_survive_to():
    coo = MATS["powerlaw-256"]
    cfg = port_cfg(_cfg("csr5"))
    st = csr5.convert(port_coo(coo), cfg)
    keys = [f"Convert-{n}(ms)" for n in csr5.CONVERT_PHASES]
    assert "convert_ms" in {f.name for f in dataclasses.fields(st)}
    for moved in (st, st.to("cpu"), st.to("meta")):
        rep = csr5.report_fields(moved, cfg)
        assert [rep[k] for k in keys] == list(st.convert_ms)
        assert all(v >= 0 for v in st.convert_ms)
    meta = st.to("meta")
    assert meta.heads.device.type == "meta" and meta.fast_val.is_meta


def test_css_state_moves_and_phases_compose():
    coo = MATS["powerlaw-256"]
    cfg = port_cfg(_cfg("css"))
    st = css.convert(port_coo(coo), cfg)
    meta = st.to("meta")
    assert meta.block_ids.is_meta and meta.heads.is_meta
    assert meta.n_xrow == st.n_xrow and meta.nnz == coo.nnz
    x = torch.from_numpy(rand_x(coo.n_col).astype(np.float32))
    ph = css.phases(st)
    assert list(ph) == ["MulScan", "Sum2"]
    assert torch.equal(ph["Sum2"](st, ph["MulScan"](st, x)), css.spmv(st, x))
    sst = ss.convert(port_coo(coo), port_cfg(_cfg("ss")))
    ph = ss.phases(sst)
    assert torch.equal(ph["Sum2"](sst, ph["Sum1"](sst, ph["Mul"](sst, x))),
                       ss.spmv(sst, x))
    with pytest.raises(TypeError):
        css.spmv(st, x.double())


def _css_first(monkeypatch):
    """Both packages' gather and scatter rates raised so far that css
    prices below every other scattered engine."""
    for mod in (auto, ref_auto):
        monkeypatch.setattr(mod, "SCATTER_RATE", 1e18)
        monkeypatch.setattr(mod, "LANE_GATHER_RATE", 1e18)


def _band_and_scatter(n=3000, seed=3):
    rng = np.random.default_rng(seed)
    d = np.arange(n)
    r, c = rng.integers(0, n, 6 * n), rng.integers(0, n, 6 * n)
    rows = np.concatenate([d, d[1:], d[:-1], r])
    cols = np.concatenate([d, d[1:] - 1, d[:-1] + 1, c])
    return COOMatrix.from_triplets(n, n, rows, cols,
                                   rng.uniform(-1, 1, len(rows)), sort=True,
                                   sum_duplicates=True)


def test_hyb_residual_set_is_the_references(monkeypatch):
    assert set(hyb.REST_MODULES) == set(ref_hyb._rest_modules())
    coo = _band_and_scatter()
    cfg = Config(format="hyb")
    for rates in ("as measured", "css first"):
        if rates == "css first":
            _css_first(monkeypatch)
        ref = ref_hyb.convert(coo, cfg)
        port = hyb.convert(port_coo(coo), port_cfg(cfg))
        assert port.rest_fmt == ref.rest_fmt, rates
        assert port.dia_state.offsets == ref.dia_state.offsets
    assert port.rest_fmt == "css"
    _assert_same_state(ref.rest_state, port.rest_state)
    x = rand_x(coo.n_col).astype(np.float32)
    y = hyb.spmv(port, torch.from_numpy(x)).numpy()
    ok, det = verify_result(port_coo(coo), x, y)
    assert ok, det


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_auto_prices_and_picks_css_as_the_reference(monkeypatch, dtype):
    """With the rates raised, css is the cheapest engine that runs a kernel
    (csr and ss, the gather fallbacks, gain as much): with those two
    excluded both packages convert css."""
    coo = powerlaw(3000, 30000, seed=2)
    cfg = Config(format="auto", dtype=dtype, auto_exclude=("csr", "ss"))
    _css_first(monkeypatch)
    want = ref_auto.estimate_costs(coo, cfg)
    got = auto.estimate_costs(port_coo(coo), port_cfg(cfg))
    assert {"css", "ss"} <= set(got)
    for k, v in got.items():
        assert v == pytest.approx(want[k], rel=1e-12, abs=0), k
    assert ref_auto.convert(coo, cfg).chosen == "css"
    st = auto.convert(port_coo(coo), port_cfg(cfg))
    assert st.chosen == "css" and isinstance(st.inner, css.CSSState)
    res = run_benchmark(port_coo(coo), port_cfg(cfg), quick=True,
                        device="cpu", log=lambda m: None)
    assert res.report["ChosenFormat"] == "CSS" and res.verify_ok
    assert "css" in res.report["AutoEstimates(us)"] \
        and "ss" in res.report["AutoEstimates(us)"]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("fmt", ["ss", "css", "csr5"])
def test_run_benchmark_scan_formats_on_cpu(fmt, dtype):
    coo = generate("random", 300, 4000, seed=5)
    cfg = Config(format=fmt, dtype=dtype)
    res = run_benchmark(port_coo(coo), port_cfg(cfg), quick=True,
                        device="cpu", log=lambda m: None)
    rep = res.report
    assert res.verify_ok and rep["Verify"] == "PASS"
    assert rep["MatrixFormat"] == fmt.upper() and rep["Dtype"] == dtype
    assert res.y.dtype == np.dtype(dtype)
    assert formats.spmv_fn(port_cfg(cfg)) is {"ss": ss, "css": css,
                                              "csr5": csr5}[fmt].spmv
    if dtype == "float64":      # the driver's x: its seeded vector
        _agree(res.y, reference_spmv(coo, create_random_vector(coo.n_col)),
               dtype)


def test_scan_formats_run_without_the_reference_package():
    """A fresh process where ``singlespmv_tpu`` cannot be imported: ss, css
    and csr5 convert and multiply, and neither jax nor the reference
    package is loaded."""
    code = (
        "import sys\n"
        "sys.modules['singlespmv_tpu'] = None\n"
        "import numpy as np, torch\n"
        "from singlespmv_tpu_torch import Config\n"
        "from singlespmv_tpu_torch.core import verify_result\n"
        "from singlespmv_tpu_torch.data import powerlaw\n"
        "from singlespmv_tpu_torch.formats import csr5, css, ss\n"
        "coo = powerlaw(2000, 16000, seed=1)\n"
        "x = np.random.default_rng(0).uniform(size=2000)\n"
        "for mod in (ss, css, csr5):\n"
        "    for dt in ('float32', 'float64'):\n"
        "        cfg = Config(format=mod.__name__.rsplit('.', 1)[1], "
        "dtype=dt)\n"
        "        xd = x.astype(dt)\n"
        "        y = mod.spmv(mod.convert(coo, cfg), torch.from_numpy(xd))\n"
        "        ok, det = verify_result(coo, xd, y.numpy(), "
        "dtype=np.dtype(dt))\n"
        "        assert ok, det\n"
        "bad = sorted(m for m in sys.modules if m.startswith("
        "('jax', 'singlespmv_tpu.')) or m == 'jaxlib')\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_heads_are_stored_once_as_uint8():
    coo = MATS["powerlaw-256"]
    for fmt in ("ss", "css", "csr5"):
        st = formats.convert(port_coo(coo), port_cfg(_cfg(fmt)))
        assert st.heads.dtype == torch.uint8
        assert st.heads.dtype in segscan.HEAD_TYPES
