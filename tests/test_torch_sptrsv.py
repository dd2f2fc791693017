"""The port's SpTRSV (``singlespmv_tpu_torch/ops/sptrsv.py``) against the
reference's (``singlespmv_tpu/ops/sptrsv.py``) on the CPU: the same level
schedule array for array, the same solve within 1e-12 of max|y| in
float64 (through ``TriSolveplan.from_arrays`` of the reference's plan
too), the same refusals, and the native level pass equal to its numpy
walk.

The reference's float64 arrays need ``jax_enable_x64``; every test runs
inside ``x64_restored`` (``tests/test_torch_f64.py``), which puts the flag
back as it found it.
"""
import contextlib

import jax
import numpy as np
import pytest
import torch

from singlespmv_tpu.config import Config as RefConfig
from singlespmv_tpu.core.types import COOMatrix as RefCOO
from singlespmv_tpu.ops import sptrsv as ref
from singlespmv_tpu_torch.config import Config
from singlespmv_tpu_torch.core import native
from singlespmv_tpu_torch.ops import sptrsv
from torch_parity import port_coo

REL = 1e-12


@contextlib.contextmanager
def x64_restored():
    """Puts ``jax_enable_x64`` back as it was on entry."""
    saved = jax.config.jax_enable_x64
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", saved)


@pytest.fixture(autouse=True)
def _x64_scope():
    with x64_restored():
        jax.config.update("jax_enable_x64", True)
        yield


def tri(n, lower=True, seed=0, density=0.2):
    """A random triangular matrix with a stored diagonal in [1, 2)."""
    rng = np.random.default_rng(seed)
    r, c = np.tril_indices(n, -1) if lower else np.triu_indices(n, 1)
    keep = rng.uniform(size=r.size) < density
    r, c = r[keep], c[keep]
    i = np.arange(n)
    return RefCOO.from_triplets(
        n, n, np.concatenate([r, i]), np.concatenate([c, i]),
        np.concatenate([rng.uniform(-1, 1, r.size), rng.uniform(1, 2, n)]))


def rel_err(y, want):
    return float(np.abs(np.asarray(y) - np.asarray(want)).max()
                 / np.abs(np.asarray(want)).max())


def _plan_arrays(plan):
    return [np.asarray(getattr(plan, f)) if not isinstance(
        getattr(plan, f), torch.Tensor) else getattr(plan, f).numpy()
        for f in ("level_rows", "col", "val", "diag")]


def _from_reference(plan):
    return sptrsv.TriSolveplan.from_arrays(
        *_plan_arrays(plan), n_row=plan.n_row, lower=plan.lower,
        device="cpu")


CASES = [(True, 3, 0.2), (False, 3, 0.2), (True, 5, 0.4), (False, 6, 0.05),
         (True, 7, 0.0)]


@pytest.mark.parametrize("lower,seed,density", CASES)
def test_plan_equals_the_reference(lower, seed, density):
    t = tri(64, lower, seed, density)
    want = ref.analyze(t, lower=lower)
    got = sptrsv.analyze(port_coo(t), lower=lower, device="cpu")
    for f in ("n_row", "n_levels", "rows_per_level", "k", "lower"):
        assert getattr(got, f) == getattr(want, f), f
    for g, w in zip(_plan_arrays(got), _plan_arrays(want)):
        np.testing.assert_array_equal(g, w)
    assert got.val.dtype == torch.float64


@pytest.mark.parametrize("lower", [True, False], ids=["L", "U"])
@pytest.mark.parametrize("through", ["analyze", "from_arrays"])
def test_solve_matches_the_reference(lower, through):
    t = tri(96, lower, seed=11, density=0.15)
    b = np.random.default_rng(4).uniform(-1, 1, 96)
    plan = ref.analyze(t, lower=lower)
    want = np.asarray(ref.solve(plan, b))
    port = (sptrsv.analyze(port_coo(t), lower=lower, device="cpu")
            if through == "analyze" else _from_reference(plan))
    y = sptrsv.solve(port, torch.from_numpy(b)).numpy()
    assert rel_err(y, want) <= REL
    assert rel_err(t.to_dense() @ y, b) <= 1e-9


def test_one_shot_and_plan_reuse():
    t = tri(48, seed=5, density=0.4)
    plan = sptrsv.analyze(port_coo(t), device="cpu")
    for seed in (6, 7):
        b = np.random.default_rng(seed).uniform(-1, 1, 48)
        want = np.asarray(ref.sptrsv(t, b))
        assert rel_err(sptrsv.solve(plan, torch.from_numpy(b)), want) <= REL
        assert rel_err(sptrsv.sptrsv(port_coo(t), torch.from_numpy(b),
                                     device="cpu"), want) <= REL


def test_float32_plan_matches_the_reference():
    t = tri(64, True, seed=8, density=0.3)
    b = np.random.default_rng(9).uniform(-1, 1, 64).astype(np.float32)
    want = np.asarray(ref.solve(ref.analyze(
        t, RefConfig(dtype="float32"), lower=True), b))
    plan = sptrsv.analyze(port_coo(t), Config(dtype="float32"), device="cpu")
    assert plan.val.dtype == plan.diag.dtype == torch.float32
    y = sptrsv.solve(plan, torch.from_numpy(b))
    assert y.dtype == torch.float32 and rel_err(y, want) <= 1e-6


def test_diagonal_only():
    i = np.arange(10)
    t = RefCOO.from_triplets(10, 10, i, i, np.full(10, 2.0))
    y = sptrsv.sptrsv(port_coo(t), torch.ones(10, dtype=torch.float64),
                      device="cpu")
    np.testing.assert_array_equal(y.numpy(), np.full(10, 0.5))
    assert sptrsv.analyze(port_coo(t), device="cpu").n_levels == 1


def test_missing_diagonal_raises_as_the_reference():
    t = RefCOO.from_triplets(3, 3, [0, 1, 2], [0, 0, 2], [2.0, 1.0, 3.0])
    with pytest.raises(ValueError, match="no stored diagonal") as want:
        ref.analyze(t, lower=True)
    with pytest.raises(ValueError, match="no stored diagonal") as got:
        sptrsv.analyze(port_coo(t), lower=True, device="cpu")
    assert str(got.value) == str(want.value)


def test_zero_diagonal_raises_as_the_reference():
    i = np.arange(4)
    t = RefCOO.from_triplets(4, 4, i, i, np.array([1.0, 0.0, 1.0, 1.0]))
    with pytest.raises(ValueError) as want:
        ref.analyze(t)
    with pytest.raises(ValueError) as got:
        sptrsv.analyze(port_coo(t), device="cpu")
    assert str(got.value) == str(want.value)


def test_value_type_mismatch_raises():
    plan = sptrsv.analyze(port_coo(tri(16)), device="cpu")
    with pytest.raises(TypeError, match="value type"):
        sptrsv.solve(plan, torch.ones(16, dtype=torch.float32))


@pytest.mark.parametrize("lower", [True, False], ids=["L", "U"])
def test_native_levels_equal_the_numpy_walk(lower):
    t = tri(300, lower, seed=12, density=0.02)
    off = (t.col < t.row) if lower else (t.col > t.row)
    orow, ocol = t.row[off], t.col[off].astype(np.int64)
    rp = np.zeros(301, dtype=np.int64)
    np.cumsum(np.bincount(orow, minlength=300), out=rp[1:])
    got = native.tri_levels(rp, ocol, lower=lower)
    if got is None:
        pytest.skip("the native factor library did not build")
    want = sptrsv._levels_numpy(rp, ocol, lower=lower)
    np.testing.assert_array_equal(got, want)
    assert want.max() > 1
