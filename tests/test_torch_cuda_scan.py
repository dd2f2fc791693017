"""Port scan CUDA kernels on the card: ``segmented_scan_tiles`` and
``block_gather_scan`` (float32 and their native-fp64 builds) against their
plain versions, and ss, css and csr5 spmv against the float64 oracle.

Needs an NVIDIA GPU and skips without one.  This file imports no jax, so it
runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_scan.py

Kernel and plain version agree to 1e-5·max|out| at float32 and
1e-12·max|out| at float64: the kernel scans four elements per thread, then
warps and blocks, where the plain version shifts by powers of two.
"""
import numpy as np
import pytest
import torch

from singlespmv_tpu_torch import Config
from singlespmv_tpu_torch.core import COOMatrix, reference_spmv, verify_result
from singlespmv_tpu_torch.data import powerlaw
from singlespmv_tpu_torch.formats import csr5, css, ss
from singlespmv_tpu_torch.harness import run_benchmark
from singlespmv_tpu_torch.ops import blockgather, segscan

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _close(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    err = float((got - want).abs().max()) if got.numel() else 0.0
    scale = float(want.abs().max()) if want.numel() else 0.0
    assert err <= TOL[got.dtype] * max(scale, 1e-30), err


def _stream(h, w, p_head, dtype, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    v = (torch.rand(h, w, generator=g, dtype=torch.float64) * 2 - 1)
    heads = (torch.rand(h, w, generator=g) < p_head).to(torch.uint8)
    return v.to(dtype).to(dev), heads.to(dev)


SHAPES = [(1, 128, 0.2), (37, 128, 0.05), (100, 384, 0.01), (50, 2048, 0.0),
          (9, 4096, 0.001), (3, 640, 1.0), (1000, 2048, 0.02)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("h,w,p_head", SHAPES)
def test_segmented_scan_tiles_kernel(cuda, h, w, p_head, dtype):
    v, heads = _stream(h, w, p_head, dtype, cuda)
    attr = "launches_f64" if dtype == torch.float64 else "launches"
    before = getattr(segscan.segmented_scan_tiles, attr)
    got = segscan.segmented_scan_tiles(v, heads)
    torch.cuda.synchronize()
    assert getattr(segscan.segmented_scan_tiles, attr) == before + 1
    _close(got, segscan.segmented_scan_tiles_ref(v, heads))
    assert torch.equal(segscan.segmented_scan_tiles(v, heads.bool()), got)


def _tiles(h, w, n_block, dtype, dev, seed=1):
    g = torch.Generator().manual_seed(seed)
    bids = torch.randint(0, n_block, (-(-h // 8),), generator=g,
                         dtype=torch.int32)
    lanes = torch.randint(0, 128, (h, w), generator=g)
    col = (lanes + 128 * bids.long().repeat_interleave(8)[:h, None]).int()
    val = (torch.rand(h, w, generator=g, dtype=torch.float64) * 2 - 1)
    heads = (torch.rand(h, w, generator=g) < 0.1).to(torch.uint8)
    x = torch.rand(n_block, 128, generator=g, dtype=torch.float64)
    return [t.to(dev) for t in (bids, col, val.to(dtype), heads,
                                x.to(dtype))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("h,w", [(8, 128), (40, 256), (16, 384), (13, 1024),
                                 (64, 2048)])
def test_block_gather_scan_kernel(cuda, h, w, dtype):
    args = _tiles(h, w, 5, dtype, cuda)
    attr = "launches_f64" if dtype == torch.float64 else "launches"
    before = getattr(blockgather.block_gather_scan, attr)
    got = blockgather.block_gather_scan(*args)
    torch.cuda.synchronize()
    assert getattr(blockgather.block_gather_scan, attr) == before + 1
    _close(got, blockgather.block_gather_scan_ref(*args))


def test_empty_streams_launch_nothing(cuda):
    v = torch.zeros(0, 128, device=cuda)
    h = torch.zeros(0, 128, dtype=torch.uint8, device=cuda)
    before = segscan.segmented_scan_tiles.launches
    assert segscan.segmented_scan_tiles(v, h).shape == (0, 128)
    assert segscan.segmented_scan_tiles.launches == before


def _coo(seed=3):
    return powerlaw(20_000, 300_000, seed=seed)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("fmt,kw", [("ss", {}), ("css", {}),
                                    ("css", {"variant": "simple"}),
                                    ("csr5", {}), ("csr5", {"sigma": 0})])
def test_spmv_on_the_card(cuda, fmt, kw, dtype):
    coo = _coo()
    mod = {"ss": ss, "css": css, "csr5": csr5}[fmt]
    cfg = Config(format=fmt, dtype=dtype, **kw)
    st = mod.convert(coo, cfg).to(cuda)
    x = np.random.default_rng(1).uniform(-1, 1, coo.n_col).astype(dtype)
    y = mod.spmv(st, torch.from_numpy(x).to(cuda)).cpu().numpy()
    ok, det = verify_result(coo, x, y, dtype=np.dtype(dtype))
    assert ok, det
    if dtype == "float64":
        want = reference_spmv(coo, x)
        assert np.abs(y - want).max() <= 1e-12 * np.abs(want).max()


def test_csr5_without_normal_tiles_launches_nothing(cuda):
    rows = np.repeat(np.arange(6), 256)
    coo = COOMatrix.from_triplets(8, 300, rows, np.tile(np.arange(256), 6),
                                  np.ones(len(rows)), sort=True)
    st = csr5.convert(coo, Config(format="csr5", sigma=2)).to(cuda)
    assert st.n_normal == 0
    before = segscan.segmented_scan_tiles.launches
    x = torch.ones(300, device=cuda)
    y = csr5.spmv(st, x).cpu().numpy()
    assert segscan.segmented_scan_tiles.launches == before
    np.testing.assert_allclose(y[:6], 256.0)


@pytest.mark.parametrize("fmt", ["ss", "css", "csr5"])
def test_run_benchmark_on_the_card(cuda, fmt):
    res = run_benchmark(_coo(4), Config(format=fmt, calibrate_seconds=0.05,
                                        n_trials=2), log=lambda m: None)
    assert res.verify_ok and res.report["Verify"] == "PASS"
    assert res.report["Architecture"] == "GPU"
