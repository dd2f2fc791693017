"""The port's ILU(0) and IC(0) (``singlespmv_tpu_torch/ops/ilu.py``) against
the reference's (``singlespmv_tpu/ops/ilu.py``) on the CPU: the same
factors within 1e-12 of their largest value, the port's native factor
library equal to its numpy walk, the same refusals, and the preconditioner
apply within 1e-12 of the reference's.

Every test runs inside ``x64_restored`` (``tests/test_torch_f64.py``).
"""
import contextlib

import jax
import numpy as np
import pytest
import torch

from singlespmv_tpu.config import Config as RefConfig
from singlespmv_tpu.core.types import COOMatrix as RefCOO
from singlespmv_tpu.ops import ilu as ref
from singlespmv_tpu_torch.config import Config
from singlespmv_tpu_torch.core import native
from singlespmv_tpu_torch.ops import ilu
from singlespmv_tpu_torch.ops.sptrsv import LEVEL_NODES
from torch_parity import port_coo

REL = 1e-12
F64 = Config(format="csr", dtype="float64", verify=False)


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


def laplacian(n):
    """1-D Laplacian (tridiagonal SPD)."""
    i = np.arange(n)
    return RefCOO.from_triplets(
        n, n, np.concatenate([i, i[1:], i[:-1]]),
        np.concatenate([i, i[1:] - 1, i[:-1] + 1]),
        np.concatenate([np.full(n, 2.0), np.full(2 * n - 2, -1.0)]))


def general(n, seed=0):
    """The reference's ``general_matrix`` (tests/test_solvers.py)."""
    rng = np.random.default_rng(seed)
    dense = np.eye(n) * n + rng.uniform(-1, 1, (n, n)) * (rng.uniform(
        size=(n, n)) < 0.15)
    r, c = np.nonzero(dense)
    return RefCOO.from_triplets(n, n, r, c, dense[r, c])


def spd(n=60, seed=9):
    """The reference's sparse SPD matrix of ``TestIC0._spd``."""
    rng = np.random.default_rng(seed)
    d = np.abs(rng.standard_normal(n)) + n
    rows = np.repeat(np.arange(n), 4)
    cols = rng.integers(0, n, n * 4)
    dense = np.zeros((n, n))
    dense[rows, cols] += rng.standard_normal(n * 4) * 0.3
    dense = dense @ dense.T + np.diag(d)
    keep = np.abs(dense) > 0.05
    np.fill_diagonal(keep, True)
    rr, cc = np.nonzero(keep)
    return RefCOO.from_triplets(n, n, rr, cc, dense[rr, cc])


def same_factor(got, want):
    np.testing.assert_array_equal(got.row, want.row)
    np.testing.assert_array_equal(got.col, want.col)
    assert np.abs(got.val - want.val).max() <= REL * np.abs(want.val).max()


ILU_MATS = {"laplacian": lambda: laplacian(32),
            "general": lambda: general(48, seed=1),
            "spd": lambda: spd(50, seed=3)}


@pytest.mark.parametrize("name", ILU_MATS)
def test_ilu0_factors_equal_the_reference(name):
    a = ILU_MATS[name]()
    for got, want in zip(ilu.ilu0(port_coo(a)), ref.ilu0(a)):
        same_factor(got, want)


@pytest.mark.parametrize("name", ["laplacian", "spd"])
def test_ic0_factor_equals_the_reference(name):
    a = ILU_MATS[name]()
    same_factor(ilu.ic0(port_coo(a)), ref.ic0(a))


@pytest.mark.parametrize("which", ["ilu0", "ic0"])
def test_native_equals_the_numpy_walk(which):
    a = spd(50, seed=3)
    if which == "ic0":
        keep = a.col <= a.row
        a = RefCOO.from_triplets(a.n_row, a.n_col, a.row[keep], a.col[keep],
                                 a.val[keep])
    rp, cols, vals = ilu._csr(port_coo(a))
    v_native = vals.copy()
    rc = getattr(native, f"{which}_csr")(rp, cols, v_native)
    if rc is None:
        pytest.skip("the native factor library did not build")
    assert rc == 0
    v_np = getattr(ilu, f"_{which}_numpy")(a.n_row, rp, cols, vals.copy())
    np.testing.assert_allclose(v_native, v_np, rtol=REL, atol=0)


def _zero_pivot():
    # row 0's pivot is 0 and row 1 reads it
    return RefCOO.from_triplets(3, 3, [0, 0, 1, 1, 2], [0, 1, 0, 1, 2],
                                [0.0, 1.0, 1.0, 2.0, 3.0])


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_ilu0_zero_pivot_raises(path, monkeypatch):
    if path == "numpy":
        monkeypatch.setattr(native, "ilu0_csr", lambda *a: None)
    with pytest.raises(ValueError, match="zero pivot at row 0"):
        ilu.ilu0(port_coo(_zero_pivot()))
    with pytest.raises(ValueError, match="zero pivot at row 0"):
        ref.ilu0(_zero_pivot())


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_ic0_refusals_as_the_reference(path, monkeypatch):
    if path == "numpy":
        monkeypatch.setattr(native, "ic0_csr", lambda *a: None)
    non_spd = RefCOO.from_triplets(2, 2, [0, 1, 1], [0, 0, 1],
                                   [1.0, 4.0, 1.0])
    no_diag = RefCOO.from_triplets(2, 2, [0, 1], [0, 0], [1.0, 4.0])
    for a, match in ((non_spd, "non-positive pivot at row 1"),
                     (no_diag, "no diagonal stored at row 1")):
        with pytest.raises(ValueError, match=match):
            ref.ic0(a)
        with pytest.raises(ValueError, match=match):
            ilu.ic0(port_coo(a))


@pytest.mark.parametrize("kind,name", [("ilu0", "general"),
                                       ("ilu0", "laplacian"),
                                       ("ic0", "spd")])
def test_preconditioner_apply_matches_the_reference(kind, name):
    a = ILU_MATS[name]()
    v = np.random.default_rng(2).uniform(-1, 1, a.n_row)
    want = np.asarray(getattr(ref, f"{kind}_preconditioner")(
        a, RefConfig(format="csr", dtype="float64", verify=False))(v))
    M = getattr(ilu, f"{kind}_preconditioner")(port_coo(a), F64,
                                               device="cpu")
    got = M(torch.from_numpy(v)).numpy()
    assert np.abs(got - want).max() <= REL * np.abs(want).max()
    assert M.dtype == torch.float64
    assert M.graph_nodes == LEVEL_NODES * (M.l_plan.n_levels
                                           + M.u_plan.n_levels) + 6


def test_tridiagonal_preconditioner_is_the_inverse():
    a = laplacian(64)
    M = ilu.ilu0_preconditioner(port_coo(a), F64, device="cpu")
    out = M(torch.ones(64, dtype=torch.float64)).numpy()
    np.testing.assert_allclose(a.to_dense() @ out, np.ones(64), rtol=1e-10)


def test_preconditioner_of_another_value_type_raises():
    M = ilu.ic0_preconditioner(port_coo(spd(20)), Config(dtype="float32"),
                               device="cpu")
    assert M.dtype == torch.float32
    with pytest.raises(TypeError, match="value type"):
        M(torch.ones(20, dtype=torch.float64))
