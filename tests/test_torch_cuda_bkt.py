"""Port bucket CUDA kernels on the card: ``block_gather_mul``, stage B
``bucket_rows`` in each of its designs (a warp a row; blocks of a unit
merged in shared memory, one a unit and several), and the first port's
``bucket_reduce``, ``bucket_reduce_grouped`` and ``lane_unpermute`` against
their plain versions; the fused stage A + B ``bucket_fused_rows`` in each
design against its plain version and against the unfused pair
(``block_gather_mul`` then ``bucket_rows``) on the same state, within each
row's ``reorder_bound`` (the same products and run totals, the run ends
added in another order); ellg's passes in one launch, ``ellg_rows``,
against its plain version and against the first port of the passes
(``block_gather_mul`` at gran 128, then the row sums in torch), within the
reorder bound of any order of a row's products, and two of its calls
within the bound of its own free-order adds; bkt, bkt_g and ellg spmv
against the float64 oracle, one bucket launch a bkt spmv and one a pass
set for ellg's passes; and ``run_benchmark(format="auto")`` with measured
trials that run the bucket kernels.

Needs an NVIDIA GPU and skips without one.  This file imports no jax, so it
runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_bkt.py

Kernel and plain version agree to 1e-5·max|out|: the stage-B kernels sum
row prefixes by warp shuffles in another order than ``torch.cumsum``, and
``bucket_rows`` adds run totals in another order than ``index_add_``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from singlespmv_tpu_torch import Config
from singlespmv_tpu_torch.core import COOMatrix, verify_result
from singlespmv_tpu_torch.core.oracle import reorder_bound
from singlespmv_tpu_torch.data import generate, powerlaw
from singlespmv_tpu_torch.formats import bkt, ellg
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
             ops.lane_unpermute, ops.block_gather_mul, ops.bucket_rows)
    before = [w.launches for w in first] + [ops.bucket_fused_rows.launches]
    y = bkt.spmv(st, x)
    assert [w.launches for w in first] + [ops.bucket_fused_rows.launches] \
        == before[:5] + [before[5] + 1]       # one launch: the fused kernel
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
    before = ops.bucket_fused_rows.launches
    res = run_benchmark(coo, cfg, device=cuda, log=lambda m: None)
    rep = res.report
    assert res.verify_ok and rep["Verify"] == "PASS"
    assert "bkt_g" in rep["AutoTrials(us)"]
    assert rep["AutoFailed"] == "none" and rep["AutoExcluded"] == "none"
    assert ops.bucket_fused_rows.launches > before


def _within(got, want, bound):
    torch.cuda.synchronize()
    err = np.abs(got.cpu().numpy().astype(np.float64)
                 - want.cpu().numpy().astype(np.float64))
    assert (err <= bound).all(), float(np.max(err - bound))


@pytest.mark.parametrize("label,make,rg,bal", CASES,
                         ids=[c[0] for c in CASES])
def test_fused_rows_match_plain_version_and_pair(cuda, label, make, rg, bal):
    coo = make()
    st = bkt.convert(coo, Config(bkt_row_group=rg, bkt_balance=bal)).to(cuda)
    xh = np.random.default_rng(1).uniform(-1, 1, coo.n_col).astype(
        np.float32)
    x = torch.from_numpy(xh).to(cuda)
    a = (st.members, st.lane, st.src, st.val, bkt.x_table(st, x), st.m)
    nu, sh, g, h = bkt._unit_rows(st)
    r = (st.hm1r, st.dest, st.yrow)
    # two orders of the same run totals: the fused launch and the pair
    bound = reorder_bound(bkt.to_coo(st), xh, bkt.adds_per_row(st),
                          "float32", "float32")

    def zeros():
        return torch.zeros(st.n_row, device=cuda)

    for parts in _parts(g):
        before = [w.launches for w in (ops.bucket_fused_rows,
                                       ops.block_gather_mul,
                                       ops.bucket_rows)]
        got = ops.bucket_fused_rows(*a, *r, zeros(), sh, nu, parts)
        assert [w.launches for w in (ops.bucket_fused_rows,
                                     ops.block_gather_mul,
                                     ops.bucket_rows)] \
            == [before[0] + 1] + before[1:]
        _close(got, ops.bucket_fused_rows_ref(*a, *r, zeros(), sh, nu,
                                              parts))
        pair = ops.bucket_rows(ops.block_gather_mul(*a).view(h, 128), *r,
                               zeros(), sh, nu, parts)
        _within(got, pair, bound)


def test_fused_rows_refuse_what_either_stage_refuses(cuda):
    coo = powerlaw(6000, 60000, seed=2)
    st = bkt.convert(coo, Config(bkt_row_group=1024)).to(cuda)
    x = torch.ones(coo.n_col, device=cuda)
    a = (st.members, st.lane, st.src, st.val, bkt.x_table(st, x), st.m)
    nu, sh, g, h = bkt._unit_rows(st)
    y = torch.zeros(st.n_row, device=cuda)
    r = (st.hm1r, st.dest, st.yrow, y, sh, nu)
    with pytest.raises(ValueError):                      # not whole rows
        ops.bucket_fused_rows(*a, *r, gran=100)
    with pytest.raises(TypeError):                       # bkt_g: int16
        ops.bucket_fused_rows(*a, st.hm1r, st.dest.to(torch.int8),
                              *r[2:])
    rc = _build.load().bucket_fused_rows_f32(
        *(ops._ptr(y),) * 9, h, 1024, st.m, sh, nu, 512, st.n_row, 0,
        ops._stream(cuda))                                 # rg 512
    assert rc != 0


def _wide(n_row=3000, n_col=2_400_000, seed=6):
    """Local rows over two x panels (more than 16,384 col-blocks)."""
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(n_row), 6)
    c = np.clip(r * (n_col // n_row) + rng.integers(-300, 301, r.size), 0,
                n_col - 1)
    return COOMatrix.from_triplets(n_row, n_col, r, c,
                                   rng.uniform(-1, 1, r.size), sort=True,
                                   sum_duplicates=True)


def _ellg_cases():
    from test_torch_cuda_campaign import _tail

    return {"tail": _tail,
            "band": lambda: generate("band", 700, 9, seed=1),
            "wide": _wide,
            "scatter": lambda: _scattered(20000, 100000, 2)}


@pytest.mark.parametrize("case", ["tail", "band", "wide", "scatter"])
def test_ellg_rows_match_plain_version_and_pair(cuda, case):
    coo = _ellg_cases()[case]()
    st = ellg.convert(coo, Config(format="ellg"))
    passes_only = dataclasses.replace(st, rest_fmt="", rest_state=None)
    pcoo = ellg.to_coo(passes_only)
    st = st.to(cuda)
    xh = np.random.default_rng(2).uniform(-1, 1, coo.n_col).astype(
        np.float32)
    x = torch.from_numpy(xh).to(cuda)
    xp = torch.zeros(-(-coo.n_col // 128) * 128, device=cuda)
    xp[: coo.n_col] = x

    def zeros():
        return torch.zeros(st.n_row, device=cuda)

    table = ellg.row_passes(st.passes)
    n0 = ops.ellg_rows.launches
    got = ops.ellg_rows(table, xp, zeros())
    assert ops.ellg_rows.launches == n0 + 1
    _close(got, ops.ellg_rows_ref(table, xp, zeros()))
    # any order of a row's products, against the first port
    first_port = ops.ellg_rows_ref(table, xp, zeros(),
                                   stage_a=ops.block_gather_mul)
    _within(got, first_port, reorder_bound(
        pcoo, xh, pcoo.row_lengths(), "float32", "float32"))
    # two calls: the passes' row sums add in a free order
    _within(got, ops.ellg_rows(table, xp, zeros()), reorder_bound(
        pcoo, xh, ellg.adds_per_row(passes_only), "float32", "float32"))
    # the spmv: one launch for the passes, one for a bkt_g rest
    watched = (ops.ellg_rows, ops.bucket_fused_rows, ops.block_gather_mul,
               ops.bucket_rows)
    before = [w.launches for w in watched]
    y = ellg.spmv(st, x)
    rest = int(st.rest_fmt == "bkt_g")
    assert [w.launches for w in watched] == [
        before[0] + 1, before[1] + rest] + before[2:]
    ok, det = verify_result(coo, xh, y.cpu().numpy(), dtype=np.float32)
    assert ok, det
    if case == "wide":
        assert len({p.panel_base for p in st.passes}) > 1
    if case == "tail":
        assert st.rest_fmt == "bkt_g" and not all(p.full for p in st.passes)


def test_ellg_rows_launch_once_a_chunk_of_passes(cuda):
    """More passes than one launch takes: one launch a chunk of
    ``ELLG_MAX_PASSES``."""
    from test_torch_cuda_campaign import _tail

    coo = _tail()
    st = ellg.convert(coo, Config(format="ellg")).to(cuda)
    passes = ellg.row_passes(st.passes) * (
        ops.ELLG_MAX_PASSES // len(st.passes) + 1)
    assert ops.ELLG_MAX_PASSES < len(passes) <= 2 * ops.ELLG_MAX_PASSES
    xp = torch.zeros(-(-coo.n_col // 128) * 128, device=cuda)
    xp[: coo.n_col] = torch.linspace(-1, 1, coo.n_col, device=cuda)
    n0 = ops.ellg_rows.launches
    got = ops.ellg_rows(passes, xp, torch.zeros(st.n_row, device=cuda))
    assert ops.ellg_rows.launches == n0 + 2
    _close(got, ops.ellg_rows_ref(passes, xp,
                                  torch.zeros(st.n_row, device=cuda)))
