"""bfloat16 SpMV (ROADMAP A.10): the port against the JAX package on the CPU.

The same seeded COO goes through the reference at ``Config(dtype=
"bfloat16")`` (its Pallas kernels in interpret mode, as its own tests run
them) and through the port, whose wrappers run their plain versions on CPU
tensors (bfloat16 values and x, products and sums in float32, y rounded
once).  The tolerances:

- the port: within ``torch_bounds.accuracy_bound`` of the float64 oracle
  of the stored values (the bfloat16-rounded values and x, which both
  packages read), a proven bound of about γ(nnz_i)·Σ_j|a_ij x_j| plus half
  a bfloat16 ulp of y_i, with 2⁻⁸·Σ_j|a_ij x_j| more where products are
  stored as bfloat16 and a term for the stream rows' prefix sums; a
  product dropped from a row fails it (``test_a_dropped_product_fails``);
- the reference: the bfloat16 oracle's bound, which its own tests hold it
  to: per row max(tol, tol·|ref|, 64·2⁻⁸·Σ_j|a_ij x_j|) against the
  oracle of the float64 values, since it rounds prefixes, planes and
  products to bfloat16 where the port keeps float32;
- the two agree within the sum of those bounds and the difference of the
  two oracles.

Both y pass ``verify_result(dtype=bfloat16)``.  Where the port carries
the reference's state across (``state_from_reference``), the carried
bfloat16 state gives the port's own y bit for bit.  Also: rounding agrees
with ml_dtypes; a cached bfloat16 state loads back bit for bit; hostlib
and mkl refuse bfloat16 with
``ValueError``, as the reference's scipy path does (SpMM at bfloat16 is
``tests/test_torch_bf16_spmm.py``'s); ``reorder_bound`` is 0 on rows of one run end and holds
on a hand-built reordering, a peel added after the free-order sum
included, and ``adds_per_row`` counts the peel; and the bfloat16 path runs
in a process where ml_dtypes cannot be imported.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from singlespmv_tpu import formats as ref_formats
from singlespmv_tpu.config import Config
from singlespmv_tpu.core import create_random_vector, verify_result
from singlespmv_tpu.core.oracle import reference_spmv, tolerance_for
from singlespmv_tpu.data.generators import generate, powerlaw
from singlespmv_tpu_torch import formats
from singlespmv_tpu_torch.core.dtypes import (from_numpy, round_values,
                                              to_host, value_tensor)
from singlespmv_tpu_torch.core.oracle import reference_spmv as port_oracle
from singlespmv_tpu_torch.core.oracle import reorder_bound
from singlespmv_tpu_torch.core.types import COOMatrix as PortCOO
from singlespmv_tpu_torch.formats import cache
from torch_bounds import accuracy_bound, stored
from torch_parity import port_cfg, port_coo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16 = "bfloat16"
EPS = 2.0 ** -8           # the oracle's bfloat16 eps
BAND = lambda: generate("band", 512, 5, seed=1)             # noqa: E731
SCATTERED = lambda: powerlaw(1500, 9000, seed=2)             # noqa: E731
LOCAL = lambda: generate("band", 2048, 3, seed=5)            # noqa: E731
# format → (matrix, the Config fields beside format and dtype)
CASES = {
    "csr": (BAND, {}), "coo": (BAND, {}), "ell": (BAND, {}),
    "jds": (BAND, {}), "dia": (BAND, {}), "dense": (BAND, {}),
    "bsr": (BAND, {}), "bcoo": (BAND, {}), "hyb": (BAND, {}),
    "slab": (SCATTERED, {}), "xch": (SCATTERED, {}),
    "auto": (SCATTERED, {}), "bkt": (SCATTERED, {}),
    "bkt_g": (SCATTERED, {"bkt_row_group": 1024}),
    "ss": (SCATTERED, {"segment_width": 256}),
    "csr5": (SCATTERED, {}),
    "css": (SCATTERED, {"segment_width": 256}),
    "ellg": (LOCAL, {}),
}
CARRIED = ("bkt", "bkt_g", "bsr", "csr5", "css", "dia", "ellg", "slab", "ss",
           "xch")   # the formats whose state the port takes from the reference


def _host(obj):
    """A reference state as numpy arrays and scalars (a nested state as
    such a dict), as ``state_from_reference`` takes it."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _host(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, tuple):
        return tuple(_host(v) for v in obj)
    return np.asarray(obj) if hasattr(obj, "shape") else obj


def _bounds(coo, x):
    """Each row's oracle bound at bfloat16: the largest of its three
    disjuncts (abs tol, rel tol, the backward term)."""
    ref = reference_spmv(coo, x)
    absref = np.zeros(coo.n_row)
    np.add.at(absref, coo.row, np.abs(coo.val * x[coo.col]))
    tol = tolerance_for(coo, ml_dtypes.bfloat16)
    return np.maximum.reduce([np.full(coo.n_row, tol), tol * np.abs(ref),
                              64.0 * EPS * absref])


def _port_bound(coo, x, st, fmt):
    """(the float64 oracle of the stored values, the port's bound b_i)."""
    sc, xh = stored(port_coo(coo)), round_values(x, BF16).astype(np.float64)
    return port_oracle(sc, xh), accuracy_bound(sc, xh, st, fmt,
                                               value_tensor(x, BF16))


@pytest.mark.parametrize("fmt", sorted(CASES))
def test_port_and_reference_agree_at_bfloat16(fmt):
    make, extra = CASES[fmt]
    coo = make()
    name = "bkt" if fmt == "bkt_g" else fmt
    cfg = Config(format=name, dtype=BF16, **extra)
    x = create_random_vector(coo.n_col)
    ref_state = ref_formats.convert(coo, cfg)
    y_ref = np.asarray(jax.jit(ref_formats.spmv_fn(cfg))(
        ref_state, jnp.asarray(x.astype(ml_dtypes.bfloat16))))
    assert y_ref.dtype == ml_dtypes.bfloat16
    y_ref = y_ref.astype(np.float64)

    pcfg = port_cfg(cfg)
    mod = formats.get_format(name)
    st = formats.convert(port_coo(coo), pcfg)
    xb = value_tensor(x, BF16)
    y = formats.spmv_fn(pcfg)(st, xb)
    assert y.dtype == torch.bfloat16 and y.shape == (coo.n_row,)
    y = to_host(y).astype(np.float64)

    for got in (y, y_ref):
        ok, det = verify_result(coo, x, got, dtype=ml_dtypes.bfloat16)
        assert ok, (fmt, det)
    r, bound = _port_bound(coo, x, st, fmt)
    err = np.abs(y - r)
    assert (err <= bound).all(), (fmt, float(np.max(err / bound)))
    ref_bound = _bounds(coo, x)
    assert (np.abs(y_ref - reference_spmv(coo, x)) <= ref_bound).all()
    assert (np.abs(y - y_ref) <= bound + ref_bound
            + np.abs(r - reference_spmv(coo, x))).all()
    if fmt in CARRIED:
        carried = mod.state_from_reference(_host(ref_state))
        assert np.array_equal(
            to_host(formats.spmv_fn(pcfg)(carried, xb)).astype(np.float64),
            y)


@pytest.mark.parametrize("fmt", ["csr", "slab", "xch", "bkt_g", "css",
                                 "hyb"])
def test_a_dropped_product_fails(fmt):
    """A port that loses one product fails its bound: of the products the
    oracle's bound cannot see (|p| within 2× the oracle's bound of its row,
    the width the parity test allowed before), the one largest against the
    port's bound is zeroed in the matrix the port converts."""
    make, extra = CASES[fmt]
    coo = make()
    name = "bkt" if fmt == "bkt_g" else fmt
    cfg = port_cfg(Config(format=name, dtype=BF16, **extra))
    x = create_random_vector(coo.n_col)
    st = formats.convert(port_coo(coo), cfg)
    r, bound = _port_bound(coo, x, st, fmt)
    sc, xh = stored(port_coo(coo)), round_values(x, BF16)
    p = np.abs(sc.val * xh[sc.col])
    hidden = p <= 2.0 * _bounds(coo, x)[sc.row]
    assert hidden.any()
    j = int(np.argmax(np.where(hidden, p / bound[sc.row], -1.0)))
    val = coo.val.copy()
    val[j] = 0.0
    bad = port_coo(coo)
    bad = PortCOO(bad.n_row, bad.n_col, bad.row, bad.col, val)
    y = to_host(formats.spmv_fn(cfg)(formats.convert(bad, cfg),
                                     value_tensor(x, BF16)))
    i = int(sc.row[j])
    assert abs(float(y[i]) - r[i]) > bound[i], (fmt, i, p[j], bound[i])


def test_rounding_is_ml_dtypes():
    """float64 → float32 → bfloat16 by torch equals ml_dtypes' float64 →
    bfloat16, ties and every binade included; ``from_numpy`` takes the
    reference's bfloat16 arrays bit for bit."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal(200_000) * np.exp2(rng.integers(-60, 60, 200_000))
    ties = (np.arange(1, 2049) + 0.5) * 2.0 ** -7   # halfway between bf16s
    a = np.concatenate([a, ties, -ties, [0.0, -0.0]])
    want = a.astype(ml_dtypes.bfloat16)
    assert np.array_equal(round_values(a, BF16),
                          want.astype(np.float32))
    t = from_numpy(want)
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.view(torch.int16).numpy(),
                          want.view(np.int16))


@pytest.mark.parametrize("fmt", ["slab", "xch", "bkt"])
def test_cached_bfloat16_state_loads_bit_exactly(fmt, tmp_path):
    coo = port_coo(SCATTERED())
    cfg = port_cfg(Config(format=fmt, dtype=BF16))
    st = formats.convert(coo, cfg)
    path = str(tmp_path / fmt)
    cache.save_state(path, st, coo, cfg)
    back = cache.load_state(path, coo, cfg, "cpu")
    assert back is not None
    for f in dataclasses.fields(st):
        a, b = getattr(st, f.name), getattr(back, f.name)
        for u, v in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            if isinstance(u, torch.Tensor):
                assert u.dtype == v.dtype and torch.equal(u, v), f.name
    x = value_tensor(create_random_vector(coo.n_col), BF16)
    spmv = formats.spmv_fn(cfg)
    assert torch.equal(spmv(st, x), spmv(back, x))


@pytest.mark.parametrize("fmt", ["hostlib", "mkl"])
def test_host_libraries_refuse_bfloat16(fmt):
    with pytest.raises(ValueError, match="bfloat16"):
        formats.convert(port_coo(BAND()),
                        port_cfg(Config(format=fmt, dtype=BF16)))


def test_reorder_bound():
    """0 on rows of at most one free add (a warp's in-row scan has a fixed
    order); the ulp of the output type on top where y is rounded; and
    float32 sums of a row's totals in three orders stay inside it, before
    and after rounding to bfloat16."""
    rng = np.random.default_rng(4)
    n, k = 200, 40
    rows = np.repeat(np.arange(n), k)
    cols = np.tile(np.arange(k), n)
    # the totals: float32 values of mixed sign over 16 binades
    t = (rng.standard_normal(n * k)
         * np.exp2(rng.integers(-8, 8, n * k))).astype(np.float32)
    coo = PortCOO.from_triplets(n, k, rows, cols, t.astype(np.float64),
                                sort=False)
    ones = np.ones(k)
    adds = np.full(n, k)
    adds[:10] = 1
    b32 = reorder_bound(coo, ones, adds, "float32", "float32")
    assert (b32[:10] == 0).all() and (b32[10:] > 0).all()
    b16 = reorder_bound(coo, ones, adds, "float32", BF16)
    assert (b16 > b32).all()
    tk = t.reshape(n, k)
    sums = []
    for order in (np.arange(k), np.arange(k)[::-1], rng.permutation(k)):
        acc = np.zeros(n, np.float32)
        for j in order:
            acc = acc + tk[:, j]
        sums.append(acc)
    full = np.full(n, k)
    for out, cast in (("float32", lambda s: s.astype(np.float64)),
                      (BF16, lambda s: torch.from_numpy(s).to(
                          torch.bfloat16).double().numpy())):
        bound = reorder_bound(coo, ones, full, "float32", out)
        first = cast(sums[0])
        for s in sums[1:]:
            assert (np.abs(cast(s) - first) <= bound).all()


def test_reorder_bound_with_a_peel():
    """y = fl(s + d): k free-order totals s and a fixed-order peel d added
    after them.  Two orders of the totals stay within the bound at k + 1
    terms (``adds_per_row`` counts the peel), before and after rounding
    to bfloat16."""
    rng = np.random.default_rng(6)
    n, k = 400, 6
    t = (rng.standard_normal((n, k))
         * np.exp2(rng.integers(-6, 6, (n, k)))).astype(np.float32)
    d = (rng.standard_normal(n) * np.exp2(rng.integers(-6, 6, n))
         ).astype(np.float32)
    terms = np.concatenate([t, d[:, None]], axis=1)
    coo = PortCOO.from_triplets(n, k + 1, np.repeat(np.arange(n), k + 1),
                                np.tile(np.arange(k + 1), n),
                                terms.ravel().astype(np.float64), sort=False)
    ys = []
    for _ in range(8):
        s = np.zeros(n, np.float32)
        for j in rng.permutation(k):
            s = s + t[:, j]
        ys.append(s + d)
    ones, adds = np.ones(k + 1), np.full(n, k + 1)
    for out, cast in (("float32", lambda v: v.astype(np.float64)),
                      (BF16, lambda v: torch.from_numpy(v).to(
                          torch.bfloat16).double().numpy())):
        bound = reorder_bound(coo, ones, adds, "float32", out)
        for y in ys[1:]:
            assert (np.abs(cast(y) - cast(ys[0])) <= bound).all()


@pytest.mark.parametrize("fmt", ["xch", "hyb"])
def test_adds_per_row_counts_the_peel(fmt):
    """A peeled state's k_i: the route's (xch) or the residual's (hyb)
    run totals, and one more on each row the peel touches."""
    band, rest = generate("band", 6000, 3, seed=4), powerlaw(6000, 30000,
                                                             seed=6)
    coo = PortCOO.from_triplets(
        6000, 6000, np.concatenate([band.row, rest.row]),
        np.concatenate([band.col, rest.col]),
        np.concatenate([band.val, rest.val]), sum_duplicates=True)
    st = formats.convert(coo, port_cfg(Config(format=fmt, dtype=BF16)))
    mod = formats.get_format(fmt)
    if fmt == "xch":
        assert st.dia_vals is not None
        peel = (to_host(st.dia_vals) != 0).any(axis=0)
        route = mod.adds_per_row(dataclasses.replace(st, dia_vals=None))
    else:
        assert st.rest_fmt
        peel = (to_host(st.dia_state.diag) != 0).any(axis=0)[:coo.n_row]
        rmod = mod.REST_MODULES[st.rest_fmt]
        route = rmod.adds_per_row(st.rest_state) \
            if hasattr(rmod, "adds_per_row") \
            else rmod.to_coo(st.rest_state).row_lengths()
    assert peel.sum() >= coo.n_row // 2
    assert np.array_equal(mod.adds_per_row(st), route + peel)


def test_bfloat16_path_without_ml_dtypes():
    """The card's machine has no ml_dtypes: the port's bfloat16 convert,
    spmv and verify run with ``sys.modules["ml_dtypes"] = None``."""
    code = """
import sys
sys.modules["ml_dtypes"] = None
sys.modules["singlespmv_tpu"] = None
sys.modules["jax"] = None
import numpy as np
from singlespmv_tpu_torch import Config
from singlespmv_tpu_torch.core import create_random_vector, verify_result
from singlespmv_tpu_torch.core.dtypes import to_host, value_tensor
from singlespmv_tpu_torch.data import powerlaw
from singlespmv_tpu_torch.formats import convert, spmv_fn
from singlespmv_tpu_torch.harness import run_benchmark
coo = powerlaw(1000, 6000, seed=1)
x = create_random_vector(coo.n_col)
for fmt in ("slab", "xch", "bkt", "css", "csr"):
    cfg = Config(format=fmt, dtype="bfloat16")
    y = spmv_fn(cfg)(convert(coo, cfg), value_tensor(x, "bfloat16"))
    assert verify_result(coo, x, to_host(y), dtype="bfloat16")[0], fmt
r = run_benchmark(coo, Config(format="auto", dtype="bfloat16"),
                  device="cpu", quick=True, log=lambda m: None)
assert r.verify_ok and r.report["Dtype"] == "bfloat16"
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
