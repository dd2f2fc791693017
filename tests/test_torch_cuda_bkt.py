"""Port bucket CUDA kernels on the card: ``block_gather_mul``, stage B
``bucket_rows`` in each of its designs (a warp a row; blocks of a unit
merged in shared memory, one a unit and several), and the first port's
``bucket_reduce``, ``bucket_reduce_grouped`` and ``lane_unpermute`` against
their plain versions, bkt and bkt_g spmv against the float64 oracle
through ``bucket_rows`` alone, and ``run_benchmark(format="auto")`` with
measured trials that run the bucket kernels.

Needs an NVIDIA GPU and skips without one.  This file imports no jax, so it
runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_bkt.py

Kernel and plain version agree to 1e-5·max|out|: the stage-B kernels sum
row prefixes by warp shuffles in another order than ``torch.cumsum``, and
``bucket_rows`` adds run totals in another order than ``index_add_``.
"""
import numpy as np
import pytest
import torch

from singlespmv_tpu_torch import Config
from singlespmv_tpu_torch.core import COOMatrix, verify_result
from singlespmv_tpu_torch.data import powerlaw
from singlespmv_tpu_torch.formats import bkt
from singlespmv_tpu_torch.harness import run_benchmark
from singlespmv_tpu_torch.ops import _build
from singlespmv_tpu_torch.ops import bucket as ops

pytestmark = pytest.mark.cuda

TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _scattered(n, nnz, seed):
    rng = np.random.default_rng(seed)
    return COOMatrix.from_triplets(
        n, n, rng.integers(0, n, nnz), rng.integers(0, n, nnz),
        rng.uniform(-1, 1, nnz), sort=True, sum_duplicates=True)


CASES = [
    ("powerlaw-ru1", lambda: powerlaw(6000, 60000, seed=2), 128, True),
    ("deep-ru1-unbalanced", lambda: _scattered(2000, 60000, 9), 128, False),
    ("powerlaw-ru8", lambda: powerlaw(6000, 60000, seed=2), 1024, True),
    ("scatter-ru8-m4", lambda: _scattered(9000, 18000, 5), 1024, True),
    ("big-ru8-unbalanced", lambda: _scattered(300_000, 900_000, 3), 1024,
     False),
]


def _parts(g):
    """``parts`` of each design of ``bucket_rows`` for units of ``g``
    stream rows: direct, and the merge kernel at 4 rows a warp and at one
    block a unit."""
    return 0, -(-g // (8 * bkt.MERGE_ROWS)), 1


def _close(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    err = float((got - want).abs().max())
    assert err <= TOL * max(float(want.abs().max()), 1e-30), err


@pytest.mark.parametrize("label,make,rg,bal", CASES,
                         ids=[c[0] for c in CASES])
def test_kernels_match_plain_versions(cuda, label, make, rg, bal):
    coo = make()
    st = bkt.convert(coo, Config(bkt_row_group=rg, bkt_balance=bal)).to(cuda)
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        -1, 1, coo.n_col).astype(np.float32)).to(cuda)
    xt = bkt.x_table(st, x)
    a = (st.members, st.lane, st.src, st.val, xt, st.m)
    n0 = ops.block_gather_mul.launches
    prod = ops.block_gather_mul(*a)
    assert ops.block_gather_mul.launches == n0 + 1
    _close(prod, ops.block_gather_mul_ref(*a))
    nu_pad = st.rb_pad // (rg // 128)
    b_in = bkt.stage_b_input(st, prod)
    if rg == 1024:
        fn, ref = ops.bucket_reduce_grouped, ops.bucket_reduce_grouped_ref
        b = (b_in, st.hm1, st.idx, nu_pad, st.n_chunks)
    else:
        fn, ref = ops.bucket_reduce, ops.bucket_reduce_ref
        b = (b_in, st.hm1, st.idx, nu_pad)
    n0 = fn.launches
    y_tab = fn(*b)
    assert fn.launches == n0 + 1
    _close(y_tab, ref(*b))
    if st.balanced:
        u = (bkt.y_table_t(st, y_tab), st.src_lane, st.src_chunk)
        n0 = ops.lane_unpermute.launches
        got = ops.lane_unpermute(*u)
        assert ops.lane_unpermute.launches == n0 + 1
        assert torch.equal(got, ops.lane_unpermute_ref(*u))
    nu, sh, g, h = bkt._unit_rows(st)
    r = (prod.view(h, 128), st.hm1r, st.dest, st.yrow)
    want = ops.bucket_rows_ref(*r, torch.zeros(st.n_row, device=cuda), sh,
                               nu)
    for parts in _parts(g):
        n0 = ops.bucket_rows.launches
        got = ops.bucket_rows(*r, torch.zeros(st.n_row, device=cuda), sh,
                              nu, parts)
        assert ops.bucket_rows.launches == n0 + 1
        _close(got, want)
    first = (ops.bucket_reduce, ops.bucket_reduce_grouped,
             ops.lane_unpermute)
    before = [w.launches for w in first] + [ops.bucket_rows.launches]
    y = bkt.spmv(st, x)
    assert [w.launches for w in first] + [ops.bucket_rows.launches] \
        == before[:3] + [before[3] + 1]       # stage B is bucket_rows alone
    _close(y, want)      # stage A's products are the same
    ok, det = verify_result(coo, x.cpu().numpy(), y.cpu().numpy(),
                            dtype=np.float32)
    assert ok, det


def test_launch_failure_raises_kernel_error(cuda):
    out = torch.empty(8, 128, device=cuda)
    rc = _build.load().bucket_reduce_f32(
        *(ops._ptr(out),) * 4, 7, 1, 1,            # rb_pad 7: refused
        ops._stream(cuda))
    assert rc != 0
    with pytest.raises(_build.KernelError):
        ops._raise_on(rc, "bucket_reduce")
    for rg, parts in ((512, 0), (128, -1)):                # refused
        rc = _build.load().bucket_rows_f32(
            *(ops._ptr(out),) * 5, 8, 1, 8, rg, 8, parts, ops._stream(cuda))
        assert rc != 0


def test_auto_trials_run_the_bucket_kernels(cuda):
    coo = _scattered(9000, 18000, 5)
    cfg = Config(format="auto", calibrate_seconds=0.05, n_trials=2)
    before = ops.bucket_rows.launches
    res = run_benchmark(coo, cfg, device=cuda, log=lambda m: None)
    rep = res.report
    assert res.verify_ok and rep["Verify"] == "PASS"
    assert "bkt_g" in rep["AutoTrials(us)"]
    assert rep["AutoFailed"] == "none" and rep["AutoExcluded"] == "none"
    assert ops.bucket_rows.launches > before
