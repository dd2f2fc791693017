"""Port scan kernels, plain path: ``segmented_scan_tiles`` and
``block_gather_scan`` on CPU tensors against the Pallas kernels run in
interpret mode (float64 against the df64 ``block_gather_scan_df``), and the
port's segment-reduction engines (``ops/segsum.py``) against the
reference's.

The plain versions scan by the same Hillis–Steele shifts as the Pallas
kernels, so float32 agrees to 1e-6·max|out| (the multiply and the adds
round alike, the lane gather exactly) and float64 to 1e-12·max|out|; the
df64 kernel carries ~48 bits, so the float64 block gather agrees with it to
1e-12·max|out|.  On the CPU the wrappers run their plain versions and the
launch counters do not move.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singlespmv_tpu.ops import segsum as ref_segsum
from singlespmv_tpu.ops.pallas.blockgather import (block_gather_scan_df,
                                                   block_gather_scan as
                                                   ref_block_gather_scan)
from singlespmv_tpu.ops.pallas.segscan import segmented_scan_tiles as ref_scan
from singlespmv_tpu_torch.ops import blockgather, segscan, segsum

TOL = {np.float32: 1e-6, np.float64: 1e-12}


@pytest.fixture(autouse=True)
def _x64_scope():
    """Puts ``jax_enable_x64`` back as it was (a float64 Pallas call turns
    it on here)."""
    saved = jax.config.jax_enable_x64
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", saved)


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30)


def _stream(h, w, seed, dtype, p_head=0.2):
    rng = np.random.default_rng(seed)
    v = rng.uniform(-1, 1, (h, w)).astype(dtype)
    heads = rng.uniform(size=(h, w)) < p_head
    return v, heads


@contextlib.contextmanager
def _unchanged(wrapper):
    before = (wrapper.launches, wrapper.launches_f64)
    yield
    assert (wrapper.launches, wrapper.launches_f64) == before


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("h,w,p_head", [(8, 128, 0.2), (16, 256, 0.05),
                                        (3, 128, 0.0), (9, 256, 1.0)])
def test_segmented_scan_tiles_matches_pallas(h, w, p_head, dtype):
    """Sparse, absent and all-set heads; H not a multiple of 8."""
    if dtype == np.float64:
        jax.config.update("jax_enable_x64", True)
    v, heads = _stream(h, w, h + w, dtype, p_head)
    want = ref_scan(jnp.asarray(v), jnp.asarray(heads))
    with _unchanged(segscan.segmented_scan_tiles):
        got = segscan.segmented_scan_tiles(
            torch.from_numpy(v), torch.from_numpy(heads.astype(np.uint8)))
    _close(got.numpy(), want, TOL[dtype])
    # a bool heads tensor gives the same scan
    same = segscan.segmented_scan_tiles(torch.from_numpy(v),
                                        torch.from_numpy(heads))
    assert torch.equal(same, got)


def _tiles(h, w, n_block, seed, dtype):
    """A block-ordered stream: each (8, w) tile reads one x block."""
    rng = np.random.default_rng(seed)
    bids = rng.integers(0, n_block, -(-h // 8)).astype(np.int32)
    lanes = rng.integers(0, 128, (h, w))
    col = (lanes + 128 * np.repeat(bids.astype(np.int64), 8)[:h, None])
    val = rng.uniform(-1, 1, (h, w)).astype(dtype)
    heads = rng.uniform(size=(h, w)) < 0.25
    x = rng.uniform(-1, 1, (n_block, 128)).astype(dtype)
    return bids, col.astype(np.int32), val, heads, x


@pytest.mark.parametrize("h,w,n_block", [(16, 256, 4), (8, 128, 1),
                                         (24, 128, 7)])
def test_block_gather_scan_matches_pallas(h, w, n_block):
    bids, col, val, heads, x = _tiles(h, w, n_block, h * w, np.float32)
    want = ref_block_gather_scan(jnp.asarray(bids), jnp.asarray(col),
                                 jnp.asarray(val),
                                 jnp.asarray(heads.astype(np.int32)),
                                 jnp.asarray(x))
    with _unchanged(blockgather.block_gather_scan):
        got = blockgather.block_gather_scan(
            *map(torch.from_numpy, (bids, col, val,
                                    heads.astype(np.uint8), x)))
    _close(got.numpy(), want, TOL[np.float32])


@pytest.mark.parametrize("h,w,n_block", [(16, 256, 4), (8, 128, 3)])
def test_block_gather_scan_f64_matches_df64(h, w, n_block):
    """The port's float64 values against the df64 kernel's (hi, lo)
    planes of the same values."""
    jax.config.update("jax_enable_x64", True)
    bids, col, val, heads, x = _tiles(h, w, n_block, w - h, np.float64)

    def split(a):
        hi = a.astype(np.float32)
        return hi, (a - hi.astype(np.float64)).astype(np.float32)

    (vh, vl), (xh, xl) = split(val), split(x)
    val = vh.astype(np.float64) + vl.astype(np.float64)
    x = xh.astype(np.float64) + xl.astype(np.float64)
    oh, ol = block_gather_scan_df(jnp.asarray(bids), jnp.asarray(col),
                                  jnp.asarray(vh), jnp.asarray(vl),
                                  jnp.asarray(heads.astype(np.int32)),
                                  jnp.asarray(xh), jnp.asarray(xl))
    want = np.asarray(oh).astype(np.float64) + np.asarray(ol).astype(
        np.float64)
    with _unchanged(blockgather.block_gather_scan):
        got = blockgather.block_gather_scan(
            *map(torch.from_numpy, (bids, col, val,
                                    heads.astype(np.uint8), x)))
    _close(got.numpy(), want, TOL[np.float64])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_segment_engines_match_reference(dtype):
    if dtype == np.float64:
        jax.config.update("jax_enable_x64", True)
    h, w, r, n_row = 12, 256, 16, 40
    v, heads = _stream(h, w, 7, dtype, 0.1)
    heads[:, 0] = True
    got = segsum.segmented_scan_inclusive(torch.from_numpy(v),
                                          torch.from_numpy(heads))
    want = jax.jit(ref_segsum.segmented_scan_inclusive)(jnp.asarray(v),
                                                        jnp.asarray(heads))
    # associative_scan adds in another tree order than the shifts
    _close(got.numpy(), want, 10 * TOL[dtype])
    rng = np.random.default_rng(8)
    end_pos = rng.integers(0, w, (h, r)).astype(np.int32)
    rows = rng.integers(0, n_row + 1, (h, r)).astype(np.int32)  # n_row: ghost
    parts = segsum.extract_run_partials(got, torch.from_numpy(end_pos))
    ref_parts = ref_segsum.extract_run_partials(jnp.asarray(got.numpy()),
                                                jnp.asarray(end_pos))
    np.testing.assert_array_equal(parts.numpy(), np.asarray(ref_parts))
    y = segsum.combine_partials(parts, torch.from_numpy(rows), n_row)
    ref_y = jax.jit(ref_segsum.combine_partials, static_argnums=2)(
        ref_parts, jnp.asarray(rows), n_row)
    _close(y.numpy(), ref_y, 10 * TOL[dtype])
    srows = np.sort(rows.reshape(-1) % n_row)
    s = segsum.segment_sum_sorted(parts.reshape(-1), torch.from_numpy(srows),
                                  n_row)
    ref_s = jax.jit(ref_segsum.segment_sum_sorted, static_argnums=2)(
        jnp.asarray(parts.numpy()).reshape(-1), jnp.asarray(srows), n_row)
    _close(s.numpy(), ref_s, 10 * TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_combine_runs_is_extract_and_combine_without_ghosts(dtype):
    """The formats' combine over the run index gives the reference's
    extract + combine (ghost slots included there) to rounding."""
    from singlespmv_tpu_torch.formats.ss import run_index

    h, w, r, n_row = 10, 128, 24, 30
    rng = np.random.default_rng(4)
    scanned = torch.from_numpy(rng.uniform(-1, 1, (h, w)).astype(dtype))
    end_pos = rng.integers(0, w, (h, r)).astype(np.int32)
    rows = rng.integers(0, n_row + 1, (h, r)).astype(np.int32)
    pos, run_rows = run_index(end_pos, rows, n_row, w)
    assert (run_rows < n_row).all() and len(pos) == (rows < n_row).sum()
    got = segsum.combine_runs(scanned, torch.from_numpy(pos),
                              torch.from_numpy(run_rows), n_row)
    want = segsum.combine_partials(segsum.extract_run_partials(
        scanned, torch.from_numpy(end_pos)), torch.from_numpy(rows), n_row)
    _close(got.numpy(), want.numpy(), 10 * TOL[dtype])


def test_wrappers_refuse_what_the_kernels_do_not_take():
    v, heads = _stream(8, 128, 1, np.float32)
    tv, th = torch.from_numpy(v), torch.from_numpy(heads)
    with pytest.raises(TypeError, match="float16"):
        segscan.segmented_scan_tiles(tv.half(), th)
    with pytest.raises(TypeError, match="heads"):
        segscan.segmented_scan_tiles(tv, th.int())
    with pytest.raises(ValueError, match="multiple of 4"):
        segscan.segmented_scan_tiles(tv[:, :6].contiguous(),
                                     th[:, :6].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        segscan.segmented_scan_tiles(tv.t(), th.t())
    bids, col, val, heads, x = map(torch.from_numpy,
                                   _tiles(16, 128, 2, 3, np.float32))
    with pytest.raises(TypeError, match="int32"):
        blockgather.block_gather_scan(bids, col.long(), val, heads, x)
    with pytest.raises(TypeError):
        blockgather.block_gather_scan(bids, col, val, heads, x.double())
    with pytest.raises(ValueError, match="tile_block_ids"):
        blockgather.block_gather_scan(bids[:1], col, val, heads, x)
    with pytest.raises(ValueError, match="x_table"):
        blockgather.block_gather_scan(bids, col, val, heads, x[:, :64])
