"""Port calibration kernels on the card: ``xch_route`` and the probe kernels
of ``ops/probes.py`` against their plain versions, at the shapes that
``harness/calibrate``, ``harness/microbench`` and ``harness/probe_slab``
give them, each counting its launch.

Needs an NVIDIA GPU and skips without one.  This file imports no jax, so it
runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_probes.py

float32 kernels agree with their plain versions to 1e-5·max|out| (prefix
sums by warp shuffles, accumulation with atomics in run-dependent order);
the bfloat16 lane gather and the gathers without sums agree exactly.
"""
import numpy as np
import pytest
import torch

from singlespmv_tpu_torch.harness import calibrate, microbench, probe_slab
from singlespmv_tpu_torch.ops import _build, probes
from singlespmv_tpu_torch.ops import xch as ops

pytestmark = pytest.mark.cuda

TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _close(got, want, exact=False):
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.is_cuda
    if exact:
        assert torch.equal(got, want)
        return
    scale = float(want.abs().max())
    assert scale > 0
    assert float((got - want).abs().max()) <= TOL * scale


def _launched(wrapper, *args, **kw):
    before = wrapper.launches
    out = wrapper(*args, **kw)
    assert wrapper.launches == before + 1
    return out


@pytest.mark.parametrize("planes", [8, 16])
def test_xch_route_on_calibrate_args(cuda, planes):
    a, ngb = calibrate._route_args(np.random.default_rng(0), 16 * 1024,
                                   planes, 1, 64, device=cuda)
    got = _launched(ops.xch_route, *a, ngb, 1, planes, 64)
    _close(got, ops.xch_route_ref(*a, ngb, 1, planes, 64))


def test_xch_route_prunes_by_groups(cuda):
    a, _ = calibrate._route_args(np.random.default_rng(1), 4096, 16, 8, 32,
                                 device=cuda)
    n_steps = a[0].shape[0]
    rng = np.random.default_rng(2)
    a[1] = (a[0] // 2).contiguous()
    ngb = int(a[1][-1]) + 1
    a[3] = torch.from_numpy(rng.integers(-2, 18, n_steps).astype(
        np.int32)).to(cuda)
    a[4] = torch.from_numpy(rng.integers(-2, 18, n_steps).astype(
        np.int32)).to(cuda)
    got = _launched(ops.xch_route, *a, ngb, 8, 16, 32, 2, 4)
    _close(got, ops.xch_route_ref(*a, ngb, 8, 16, 32, 2, 4))


@pytest.mark.parametrize("name", list(microbench.KERNEL_CASES))
def test_probe_kernel_at_its_probes_shapes(cuda, name):
    case, kw = microbench.KERNEL_CASES[name]
    fn, args, fkw = case(**kw, device=cuda)
    got = _launched(fn, *args, **fkw)
    want = getattr(probes, fn.__name__ + "_ref")(*args, **fkw)
    sums = fn in (probes.onehot_bins, probes.dynslice_accum)
    _close(got, want, exact=not sums)


@pytest.mark.parametrize("cb,nu,s,offset", [
    (13, 11, 3, 0), (40, 24, 1, 0), (9, 300, 12, 0), (3, 5, 4, 0),
    (17, 9, 8, 1), (24, 40, 128, 1), (256, 256, 128, 0)])
def test_transpose_at_any_shape(cuda, cb, nu, s, offset):
    """S not a multiple of 4, CB and NU not multiples of 8 (partial
    bricks), and inputs one float past 16 bytes: the kernel's scalar path;
    a copy, so exact."""
    a = torch.from_numpy(np.random.default_rng(cb).standard_normal(
        cb * nu * s + offset).astype(np.float32)).to(cuda)[offset:]
    a = a.view(cb, nu * s)
    assert a.data_ptr() % 16 == 4 * offset
    got = _launched(probes.tile_transpose, a, nu, s)
    _close(got, probes.tile_transpose_ref(a, nu, s), exact=True)
    _close(got, a.view(cb, nu, s).transpose(0, 1).reshape(nu, cb * s),
           exact=True)


@pytest.mark.parametrize("G,lo,hi", [(8, 0, 128), (8, -8, 200),
                                     (8192, -8, 200), (64, 0, 3),
                                     (8192, 0, 16)])
def test_onehot_bins_any_bins(cuda, G, lo, hi):
    """One tile, bins outside [0, 128) (which add nowhere), and bins that
    pile onto 16 or 3 (the lanes left after the bidding rounds summed by the
    shuffle tree)."""
    rng = np.random.default_rng(G + hi)
    bins = torch.from_numpy(rng.integers(lo, hi, (G, 128)).astype(
        np.int32)).to(cuda)
    val = torch.from_numpy(rng.standard_normal((G, 128)).astype(
        np.float32)).to(cuda)
    _close(_launched(probes.onehot_bins, bins, val),
           probes.onehot_bins_ref(bins, val))


def test_onehot_bins_refuses_misaligned_inputs(cuda):
    bins = torch.zeros(8 * 128 + 1, dtype=torch.int32, device=cuda)[1:]
    val = torch.zeros(8, 128, device=cuda)
    with pytest.raises(ValueError, match="16-byte aligned"):
        probes.onehot_bins(bins.view(8, 128), val)


def test_pal2step_three_planes(cuda):
    fn, args, _ = microbench.pal2step_case(w=512, K=3, device=cuda)
    _close(_launched(fn, *args), probes.pal2step_ref(*args), exact=True)


def _slab_step_case(cuda, T, s8, stage):
    n_steps = 3200 // (T // 8)
    arrs = probe_slab.make_inputs(np.random.default_rng(7), n_steps, T, s8,
                                  probe_slab.CB, probe_slab.NU)
    tens = [torch.from_numpy(a).to(cuda) for a in arrs]
    got = _launched(probes.slab_step, *tens, probe_slab.NU, T, stage)
    _close(got, probes.slab_step_ref(*tens, probe_slab.NU, T, stage))


@pytest.mark.parametrize("s8", [2, 8])
@pytest.mark.parametrize("stage", probes.STAGES)
def test_probe_slab_stages(cuda, s8, stage):
    _slab_step_case(cuda, 32, s8, stage)


@pytest.mark.parametrize("T,s8,stage", probe_slab.ROWS)
def test_probe_slab_rows(cuda, T, s8, stage):
    """probe_slab.main's rows: at T 16 a warp holds two rows, at T 64 two
    blocks of one step add into the same unit block."""
    _slab_step_case(cuda, T, s8, stage)


def test_launchers_refuse_bad_ranges(cuda):
    lib = _build.load()
    stream = torch.cuda.current_stream(cuda).cuda_stream
    # uids .. out | H T m planes pg p1 n_out
    assert lib.xch_route_f32(*[None] * 11, 64, 64, 1, 65, 8, 64, 1,
                             stream) != 0               # planes past 64
    assert lib.xch_route_f32(*[None] * 11, 96, 64, 1, 8, 8, 64, 1,
                             stream) != 0               # H % T
    # uids .. out | H T S8 NU stage
    assert lib.probe_slab_f32(*[None] * 9, 64, 32, 9, 1, 0,
                              stream) != 0              # S8 past 8
    assert lib.probe_slab_f32(*[None] * 9, 64, 32, 8, 1, 7,
                              stream) != 0              # no such stage
    # col .. out | n w kind a b
    assert lib.probe_gather_f32(*[None] * 7, 1024, 100, 0, 1, 0,
                                stream) != 0            # w not 128·k
    assert lib.probe_onehot_f32(None, None, None, 12, stream) != 0
    assert lib.probe_onehot_f32(4, 16, 32, 8, stream) != 0   # not on 16 B
    assert lib.probe_transpose_f32(None, None, 0, 4, 4, stream) == 0
    assert lib.probe_transpose_f32(None, None, 4, -1, 4, stream) != 0
    assert lib.probe_transpose_f32(None, None, 4, 4, -2, stream) != 0
