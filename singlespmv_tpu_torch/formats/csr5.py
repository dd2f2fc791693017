"""CSR5 — the tiled format of ``singlespmv_tpu/formats/csr5.py`` (after Liu
and Vinter's CSR5).

The nnz stream is cut into ω×σ tiles (ω = 128 lanes, σ from the config or,
at ``sigma=0``, from nnz per row), and the tiles are split at convert:

- the fast track holds tiles that lie in one row (and all-padding tiles,
  on the ghost row): their products are summed per tile and added into the
  row, in plain torch, as the reference leaves it to XLA;
- the normal track holds the rest: products, the ``segmented_scan_tiles``
  kernel ("optimized"; the plain Hillis–Steele loop for "simple"), each
  real run's total at its end lane and an ``index_add_`` by row (ss's run
  index: ghost slots are left out).  A matrix with no normal tile launches
  no kernel.

``convert`` is a copy of the reference's, array for array (heads as uint8).
Its phase times (``Convert-*(ms)``) are a field of the state, so they
survive ``state.to(device)``; the reference keeps them as an attribute off
its dataclass fields.  Values are float32 or float64.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..config import Config
from ..core.dtypes import (acc, acc_dtype, to_host, value_size,
                           value_tensor)
from ..core.types import COOMatrix, round_up
from ..ops.segscan import segmented_scan_tiles
from ..ops.segsum import segmented_scan_inclusive
from .base import TensorState, check_dtype, state_from_arrays
from .slab import _t
from .ss import _with_run_index, run_index, stream_rows

CONVERT_PHASES = ("malloc", "tile_ptr", "tile_desc", "transpose")


def auto_sigma(n_row: int, nnz: int) -> int:
    avg = nnz / max(n_row, 1)
    if avg < 8:
        return 4
    if avg < 32:
        return 8
    if avg < 128:
        return 16
    return 32


@dataclasses.dataclass(frozen=True)
class CSR5State(TensorState):
    n_row: int
    n_col: int
    nnz: int
    omega: int
    sigma: int
    w: int                    # ω·σ elements per tile
    n_tile: int
    n_fast: int               # fast-track (single-row) tiles
    n_normal: int
    r_max: int
    variant: str
    fast_col: torch.Tensor    # (n_fast, W)
    fast_val: torch.Tensor
    fast_rows: torch.Tensor   # (n_fast,)
    col: torch.Tensor         # (n_normal, W)
    val: torch.Tensor
    heads: torch.Tensor       # (n_normal, W) uint8
    end_pos: torch.Tensor     # (n_normal, r_max) int32
    rank_rows: torch.Tensor   # (n_normal, r_max)
    run_pos: torch.Tensor     # (P,) int64 — flat end slot of each real run
    run_rows: torch.Tensor    # (P,) index type — its row
    convert_ms: tuple = ()    # ms of the CONVERT_PHASES


def _ms(t1, t0):
    return round((t1 - t0) * 1e3, 3)


def convert(coo: COOMatrix, cfg: Config) -> CSR5State:
    """Build the tiles on the host; tensors come back on the CPU."""
    check_dtype("csr5", cfg.dtype)
    t0 = time.perf_counter()
    omega = cfg.omega
    sigma = cfg.sigma if cfg.sigma > 0 else auto_sigma(coo.n_row, coo.nnz)
    w = omega * sigma
    nnz_pad = round_up(max(coo.nnz, 1), w)
    n_tile = nnz_pad // w
    idx = cfg.index_dtype

    row_s = np.full(nnz_pad, coo.n_row, dtype=np.int64)
    col_s = np.zeros(nnz_pad, dtype=idx)
    val_s = np.zeros(nnz_pad, dtype=cfg.np_dtype)
    row_s[: coo.nnz] = coo.row
    col_s[: coo.nnz] = coo.col
    val_s[: coo.nnz] = coo.val.astype(cfg.np_dtype)
    row2d = row_s.reshape(n_tile, w)
    t_alloc = time.perf_counter()

    # fast track: a tile inside one (real) row, or pure padding (ghost row)
    single = (row2d == row2d[:, :1]).all(axis=1) & (row2d[:, 0] < coo.n_row)
    all_ghost = (row2d == coo.n_row).all(axis=1)
    fast = single | all_ghost
    fi = np.nonzero(fast)[0]
    ni = np.nonzero(~fast)[0]

    col2d = col_s.reshape(n_tile, w)
    val2d = val_s.reshape(n_tile, w)
    t_ptr = time.perf_counter()

    # normal track: heads, run ends and run rows, as in ss
    nrow2d = row2d[ni]
    n_normal = int(ni.shape[0])
    if n_normal:
        prev = np.empty_like(nrow2d)
        prev[:, 0] = -1
        prev[:, 1:] = nrow2d[:, :-1]
        heads = nrow2d != prev
        heads[:, 0] = True
        nxt = np.empty_like(nrow2d)
        nxt[:, -1] = -1
        nxt[:, :-1] = nrow2d[:, 1:]
        ends = nrow2d != nxt
        ends[:, -1] = True
        rank = np.cumsum(heads, axis=1) - 1
        r_max = round_up(int(rank[:, -1].max(initial=0)) + 1, 8)
        end_pos = np.zeros((n_normal, r_max), dtype=np.int32)
        rank_rows = np.full((n_normal, r_max), coo.n_row, dtype=idx)
        hh, ww = np.nonzero(ends)
        rr = rank[hh, ww]
        end_pos[hh, rr] = ww
        rank_rows[hh, rr] = nrow2d[hh, ww]
    else:
        heads = np.zeros((0, w), dtype=bool)
        r_max = 8
        end_pos = np.zeros((0, r_max), dtype=np.int32)
        rank_rows = np.zeros((0, r_max), dtype=idx)

    fast_rows = np.minimum(row2d[fi, 0], coo.n_row).astype(idx)
    run_pos, run_rows = run_index(end_pos, rank_rows, coo.n_row, w)
    t_desc = time.perf_counter()

    arrays = dict(
        fast_col=_t(col2d[fi]), fast_val=value_tensor(val2d[fi], cfg.dtype),
        fast_rows=_t(fast_rows), col=_t(col2d[ni]),
        val=value_tensor(val2d[ni], cfg.dtype),
        heads=_t(heads.astype(np.uint8)), end_pos=_t(end_pos),
        rank_rows=_t(rank_rows), run_pos=_t(run_pos), run_rows=_t(run_rows))
    t_end = time.perf_counter()
    return CSR5State(
        n_row=coo.n_row, n_col=coo.n_col, nnz=coo.nnz, omega=omega,
        sigma=sigma, w=w, n_tile=n_tile, n_fast=int(fi.shape[0]),
        n_normal=n_normal, r_max=r_max, variant=cfg.variant,
        convert_ms=(_ms(t_alloc, t0), _ms(t_ptr, t_alloc),
                    _ms(t_desc, t_ptr), _ms(t_end, t_desc)),
        **arrays)


def state_from_reference(arrays: dict) -> CSR5State:
    """The port's state from the fields of a reference ``CSR5State``, given
    as numpy arrays and scalars (its timings, kept off its fields, are not
    carried)."""
    return state_from_arrays(CSR5State, _with_run_index(arrays), "csr5")


def _products(val, col, x):
    return val * x.index_select(0, col.view(-1)).view(val.shape)


def normal_products(state: CSR5State, x: torch.Tensor) -> torch.Tensor:
    """The normal track's (n_normal, W) products, the scan's input."""
    return _products(state.val, state.col, x)


def spmv(state: CSR5State, x: torch.Tensor) -> torch.Tensor:
    if x.dtype != state.val.dtype:
        raise TypeError(f"csr5: x is {x.dtype}, the state holds "
                        f"{state.val.dtype} values")
    # y in the accumulator type (float32 for bfloat16), rounded once
    y = torch.zeros(state.n_row + 1, dtype=acc_dtype(x.dtype),
                    device=x.device)
    if state.n_fast:
        # fast track: a dense row sum per tile, added into its row
        fast = acc(_products(state.fast_val, state.fast_col, x)).sum(1)
        y.index_add_(0, state.fast_rows, fast)
    if state.n_normal:
        # normal track: segmented scan, run ends, added by row
        prod = normal_products(state, x)
        scanned = (segmented_scan_tiles(prod, state.heads)
                   if state.variant == "optimized"
                   else segmented_scan_inclusive(acc(prod), state.heads))
        y.index_add_(0, state.run_rows, scanned.view(-1).index_select(
            0, state.run_pos))
    return y[: state.n_row].to(x.dtype)


def report_fields(state: CSR5State, cfg: Config) -> dict:
    out = {
        "Omega": state.omega, "Sigma": state.sigma, "nTile": state.n_tile,
        "nFastTile": state.n_fast, "nNormalTile": state.n_normal,
        "R_max": state.r_max,
    }
    for name, v in zip(CONVERT_PHASES, state.convert_ms):
        out[f"Convert-{name}(ms)"] = v
    return out


def traffic_bytes(state: CSR5State, cfg: Config) -> int:
    isz = 4 if cfg.index_bits == 32 else 8
    vsz = value_size(cfg.dtype)
    stream = state.n_tile * state.w
    combine = state.n_normal * state.r_max + state.n_fast
    return stream * (isz + 2 * vsz) + combine * (isz + vsz) + state.n_row * vsz


def to_coo(state: CSR5State) -> COOMatrix:
    """Inverse conversion (explicit zeros dropped)."""
    frows = np.repeat(state.fast_rows.cpu().numpy().astype(np.int64),
                      state.w)
    fcol = state.fast_col.cpu().numpy().reshape(-1)
    fval = to_host(state.fast_val).reshape(-1)
    nrows = stream_rows(state.heads.cpu().numpy(),
                        state.rank_rows.cpu().numpy()).reshape(-1)
    ncol = state.col.cpu().numpy().reshape(-1)
    nval = to_host(state.val).reshape(-1)
    rows = np.concatenate([frows, nrows.astype(np.int64)])
    cols = np.concatenate([fcol, ncol])
    vals = np.concatenate([fval, nval])
    keep = (rows < state.n_row) & (vals != 0)
    return COOMatrix.from_triplets(state.n_row, state.n_col, rows[keep],
                                   cols[keep], vals[keep], sort=True)
