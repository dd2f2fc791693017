"""The campaign's formats on the card: ``block_gather_mul`` at ellg's gran
128 (m 1 with no src, m 2 and 8) against its plain version, ellg's spmv
against its plain version on the CPU and the float64 oracle, and
``run_benchmark`` of coo, ell, jds, bcoo (cuSPARSE inside the chained
runner's CUDA graph) and hostlib (placed on the host).

Needs an NVIDIA GPU and skips without one.  This file imports no jax:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_campaign.py

Kernel and plain version agree exactly in stage A (one product a slot);
the ellg spmv to 1e-5·max|y| (its rest adds run totals in another order).
"""
import numpy as np
import pytest
import torch

from singlespmv_tpu_torch import Config
from singlespmv_tpu_torch.core import COOMatrix, verify_result
from singlespmv_tpu_torch.data import generate, powerlaw
from singlespmv_tpu_torch.formats import ellg
from singlespmv_tpu_torch.harness import run_benchmark
from singlespmv_tpu_torch.ops import bucket as ops

pytestmark = pytest.mark.cuda

TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _tail(n=1000, seed=4):
    """Local rows and a few heavy ones: ellg levels of m 2 and m 1, and a
    bkt_g rest."""
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(n), 4)
    c = np.clip(r + rng.integers(-40, 41, r.size), 0, n - 1)
    hr = np.repeat(rng.choice(n, 4, replace=False), 600)
    rows, cols = np.concatenate([r, hr]), np.concatenate(
        [c, rng.integers(0, n, hr.size)])
    return COOMatrix.from_triplets(n, n, rows, cols,
                                   rng.uniform(-1, 1, rows.size), sort=True,
                                   sum_duplicates=True)


@pytest.mark.parametrize("m", [1, 2, 8])
def test_stage_a_at_gran_128(cuda, m):
    rng = np.random.default_rng(m)
    h, w, cb = 40, 1024, 37
    lane = torch.from_numpy(rng.integers(0, 128, (h, w)).astype(np.int8))
    src = None if m == 1 else torch.from_numpy(
        rng.integers(0, m, (h, w)).astype(np.int8))
    val = torch.from_numpy(rng.uniform(-1, 1, (h, w)).astype(np.float32))
    mem = torch.from_numpy(
        rng.integers(0, cb, h * w // 128 * m).astype(np.int32))
    xt = torch.from_numpy(rng.uniform(-1, 1, (cb, 128)).astype(np.float32))
    want = ops.block_gather_mul_ref(mem, lane, src, val, xt, m, gran=128)
    args = [None if a is None else a.to(cuda)
            for a in (mem, lane, src, val, xt)]
    before = ops.block_gather_mul.launches
    got = ops.block_gather_mul(*args, m, gran=128)
    assert ops.block_gather_mul.launches == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("make", [_tail, lambda: generate("band", 700, 9,
                                                          seed=1)])
def test_ellg_spmv_on_the_card(cuda, make):
    coo = make()
    st = ellg.convert(coo, Config(format="ellg"))
    x = np.random.default_rng(3).uniform(-1, 1, coo.n_col).astype(np.float32)
    want = ellg.spmv(st, torch.from_numpy(x)).numpy()
    got = ellg.spmv(st.to(cuda), torch.from_numpy(x).to(cuda)).cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * np.abs(want).max())
    ok, det = verify_result(coo, x, got, dtype=np.float32)
    assert ok, det


@pytest.mark.parametrize("fmt", ["coo", "ell", "jds", "bcoo", "hostlib",
                                 "ellg"])
def test_run_benchmark(cuda, fmt):
    coo = powerlaw(20000, 160000, seed=2) if fmt != "ellg" else _tail()
    res = run_benchmark(coo, Config(format=fmt), quick=True, device=cuda,
                        log=lambda m: None)
    assert res.verify_ok
    arch = "CPU" if fmt == "hostlib" else "GPU"
    assert res.report["Architecture"] == arch
