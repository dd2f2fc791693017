"""The port's SpGEMM (``singlespmv_tpu_torch/ops/spgemm.py``) against the
reference's (``singlespmv_tpu/ops/spgemm.py``) on the CPU: ``spgemm_coo``
on the reference's own cases (a small exact product, a rectangular chain,
an empty product, a power-law B with one 20,000-entry row) gives the same
pattern and values within 1e-12 of max|C|, and ``spgemm_arrays`` on ELL
states of the same factors the same keys, count and sums.

Every test runs inside ``x64_restored`` (``tests/test_torch_f64.py``).
"""
import contextlib

import jax
import numpy as np
import pytest
import torch

from singlespmv_tpu.config import Config as RefConfig
from singlespmv_tpu.core.types import COOMatrix as RefCOO
from singlespmv_tpu.data.generators import generate
from singlespmv_tpu.formats import ell as ref_ell
from singlespmv_tpu.ops import spgemm as ref
from singlespmv_tpu_torch.config import Config
from singlespmv_tpu_torch.formats import ell
from singlespmv_tpu_torch.ops import spgemm
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


def small_exact():
    return generate("band", 24, 3, seed=8), generate("band", 24, 2, seed=9)


def rectangular_chain():
    rng = np.random.default_rng(2)
    a = RefCOO.from_triplets(20, 30, rng.integers(0, 20, 120),
                             rng.integers(0, 30, 120),
                             rng.uniform(-1, 1, 120), sum_duplicates=True)
    b = RefCOO.from_triplets(30, 15, rng.integers(0, 30, 90),
                             rng.integers(0, 15, 90),
                             rng.uniform(-1, 1, 90), sum_duplicates=True)
    return a, b


def empty_product():
    # A's col 4 misses B's only row 0
    return (RefCOO.from_triplets(5, 5, np.array([0]), np.array([4]),
                                 np.array([2.0])),
            RefCOO.from_triplets(5, 5, np.array([0]), np.array([0]),
                                 np.array([3.0])))


def powerlaw_b(n=100_000):
    """A light scatter times a B with one dense row of 20,000 entries:
    without the degree groups the rectangle would be nnz_A · 20,000."""
    rng = np.random.default_rng(5)
    a = RefCOO.from_triplets(
        n, n, rng.integers(0, n, 100_000), rng.integers(0, n, 100_000),
        rng.uniform(1, 2, 100_000), sum_duplicates=True)
    br = np.concatenate([rng.integers(0, n, 80_000), np.full(20_000, 1234)])
    bc = np.concatenate([rng.integers(0, n, 80_000),
                         rng.choice(n, 20_000, replace=False)])
    b = RefCOO.from_triplets(n, n, br, bc, rng.uniform(1, 2, len(br)),
                             sum_duplicates=True)
    return a, b


CASES = {"small_exact": small_exact, "rectangular_chain": rectangular_chain,
         "empty_product": empty_product, "powerlaw_b": powerlaw_b}


@pytest.mark.parametrize("name", CASES)
def test_spgemm_coo_equals_the_reference(name):
    a, b = CASES[name]()
    want = ref.spgemm_coo(a, b)
    got = spgemm.spgemm_coo(port_coo(a), port_coo(b), device="cpu")
    assert (got.n_row, got.n_col) == (want.n_row, want.n_col)
    np.testing.assert_array_equal(got.row, want.row)
    np.testing.assert_array_equal(got.col, want.col)
    if want.nnz:
        assert np.abs(got.val - want.val).max() <= \
            REL * np.abs(want.val).max()
    else:
        assert name == "empty_product" and got.nnz == 0


def test_small_exact_is_the_dense_product():
    a, b = small_exact()
    c = spgemm.spgemm_coo(port_coo(a), port_coo(b), device="cpu")
    np.testing.assert_allclose(c.to_dense(), a.to_dense() @ b.to_dense(),
                               rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("name", ["small_exact", "rectangular_chain"])
def test_spgemm_arrays_equal_the_reference(name):
    a, b = CASES[name]()
    cfg = RefConfig(format="ell", dtype="float64")
    keys, vals, n = ref.spgemm_arrays(ref_ell.convert(a, cfg),
                                      ref_ell.convert(b, cfg), b.n_col)
    n = int(n)
    pcfg = Config(format="ell", dtype="float64")
    pk, pv, pn = spgemm.spgemm_arrays(ell.convert(port_coo(a), pcfg),
                                      ell.convert(port_coo(b), pcfg),
                                      b.n_col)
    assert int(pn) == n > 0
    np.testing.assert_array_equal(pk[:n].numpy(), np.asarray(keys)[:n])
    want = np.asarray(vals)[:n]
    assert np.abs(pv[:n].numpy() - want).max() <= REL * np.abs(want).max()
    assert pk.dtype == torch.int64 and (pk[n:] == pk[-1]).all()


def test_float32_product():
    a, b = small_exact()
    c = spgemm.spgemm_coo(port_coo(a), port_coo(b), Config(dtype="float32"),
                          device="cpu")
    want = ref.spgemm_coo(a, b)
    np.testing.assert_array_equal(c.col, want.col)
    np.testing.assert_allclose(c.val, want.val, rtol=1e-6)
