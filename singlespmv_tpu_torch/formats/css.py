"""CSS — the column-blocked segmented-scan format of
``singlespmv_tpu/formats/css.py``.

- "optimized": the stream is ordered by (col // 128, row, col), and each
  128-column block's sub-stream is padded to whole (8, W) tiles (pads: ghost
  row, the block's base column, value 0), W adapting down to the blocks'
  size.  Every tile reads one 128-lane row of the x table, so SpMV is one
  ``block_gather_scan`` kernel (``ops/blockgather.py``: gather, multiply and
  segmented scan) followed by ss's combine of the run totals, which also
  sums a row's partials from every block.
- "simple": the same ordering with ``cfg.n_block`` blocks, computed by ss's
  plain engines.

``convert`` is a copy of the reference's, array for array (heads as uint8,
as in ss).  At float64 the state holds float64 values and the kernel runs
its native-fp64 build, so none of the reference's df64 fields ((hi, lo)
value planes and the row-sorted combine index of its compensated log-tree)
exist here: the fp64 scanned stream goes through the same extraction and
``index_add_`` as float32.  Values are float32 or float64.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import Config
from ..core.types import COOMatrix, cdiv, round_up
from ..ops.blockgather import block_gather_scan
from . import ss
from .base import check_dtype, state_from_arrays
from .slab import _t

LANES = 128


@dataclasses.dataclass(frozen=True)
class CSSState(ss.SSState):
    n_block: int = 1
    block_cols: int = 0
    n_xrow: int = 1                       # rows of the (B, 128) x table
    block_ids: torch.Tensor = None        # (H/8,) int32 — x block per tile


def convert(coo: COOMatrix, cfg: Config) -> CSSState:
    """Build the block-ordered stream on the host; tensors come back on the
    CPU.  Raises ``ValueError`` where padding every column block to whole
    tiles would exceed 8 slots per nonzero plus 65,536."""
    check_dtype("css", cfg.dtype)
    w = max(cfg.lane_width, round_up(cfg.segment_width, cfg.lane_width))
    optimized = cfg.variant == "optimized"
    if optimized:
        block_cols = LANES
        n_block = cdiv(max(coo.n_col, 1), block_cols)
    else:
        n_block = max(1, cfg.n_block)
        block_cols = cdiv(max(coo.n_col, 1), n_block)

    blk = coo.col // block_cols
    order = np.lexsort((coo.col, coo.row, blk))
    rows, cols, vals = coo.row[order], coo.col[order], coo.val[order]

    extra = dict(n_block=n_block, block_cols=block_cols,
                 n_xrow=cdiv(max(coo.n_col, 1), LANES))
    if optimized:
        # pad each 128-column block's sub-stream to whole 8·W tiles, so that
        # every tile reads one block; W adapts down to small blocks
        sblk = blk[order]
        present, counts = (np.unique(sblk, return_counts=True)
                           if coo.nnz else (np.zeros(1, np.int64),
                                            np.zeros(1, np.int64)))
        avg_blk = coo.nnz / max(len(present), 1)
        w = min(w, max(LANES, round_up(int(avg_blk / 8) + 1, LANES)))
        tile_elems = 8 * w
        padded = np.maximum(tile_elems,
                            (np.ceil(counts / tile_elems) * tile_elems)
                            .astype(np.int64))
        total = int(padded.sum())
        if total > 8 * max(coo.nnz, 1) + (1 << 16):
            raise ValueError(
                f"css: block padding {total} slots vs nnz {coo.nnz} — too "
                "many near-empty column blocks; use bkt/bsr")
        prow = np.full(total, coo.n_row, dtype=np.int64)
        pcol = np.zeros(total, dtype=coo.col.dtype)
        pval = np.zeros(total, dtype=np.float64)
        out_start = np.zeros(len(present), dtype=np.int64)
        np.cumsum(padded[:-1], out=out_start[1:])
        in_start = np.zeros(len(present), dtype=np.int64)
        np.cumsum(counts[:-1], out=in_start[1:])
        # entry i of block b lands at out_start[b] + its rank in the block
        binv = np.searchsorted(present, sblk)
        pos = out_start[binv] + (np.arange(coo.nnz) - in_start[binv])
        prow[pos] = rows
        pcol[pos] = cols
        pval[pos] = vals
        # pad slots keep their block's base column (an in-block lane)
        pad_mask = np.ones(total, dtype=bool)
        pad_mask[pos] = False
        pad_blk = np.repeat(present, padded)[pad_mask]
        pcol[pad_mask] = pad_blk * block_cols
        # one block id per (8, W) tile (total % 8w == 0 by construction)
        tile_bids = (pcol.reshape(-1, tile_elems)[:, 0]
                     // block_cols).astype(np.int32)
        state = ss.build_stream(coo, cfg.replace(segment_width=w), rows=prow,
                                cols=pcol, vals=pval, sorted_combine=False,
                                cls=CSSState, block_ids=_t(tile_bids),
                                **extra)
    else:
        state = ss.build_stream(coo, cfg, rows=rows, cols=cols, vals=vals,
                                sorted_combine=False, cls=CSSState, **extra)
        state = dataclasses.replace(state, block_ids=torch.zeros(
            cdiv(state.h, 8), dtype=torch.int32))
    return dataclasses.replace(state, nnz=coo.nnz)


def state_from_reference(arrays: dict) -> CSSState:
    """The port's state from the fields of a reference ``CSSState``, given
    as numpy arrays and scalars.  The reference's float64 state holds its
    values in ``val`` as float64 already (its build_stream fills them at the
    config's type); its df64 planes and combine index are not read."""
    return state_from_arrays(CSSState, ss._with_run_index(arrays), "css")


def x_table(state: CSSState, x: torch.Tensor) -> torch.Tensor:
    """The kernel's (n_xrow, 128) x table: x zero-padded to whole blocks."""
    xp = torch.zeros(state.n_xrow * LANES, dtype=x.dtype, device=x.device)
    xp[: state.n_col] = x
    return xp.view(state.n_xrow, LANES)


def spmv_scan_phase(state: CSSState, x: torch.Tensor) -> torch.Tensor:
    """The scanned product stream: one ``block_gather_scan`` launch."""
    return block_gather_scan(state.block_ids, state.col, state.val,
                             state.heads, x_table(state, x))


def spmv_acc(state: CSSState, x: torch.Tensor) -> torch.Tensor:
    """y in the accumulator type (float32 for bfloat16 values)."""
    if state.variant != "optimized":
        return ss.spmv_acc(state, x)
    ss._check_x(state, x)
    return ss.reduce(state, spmv_scan_phase(state, x))


def spmv(state: CSSState, x: torch.Tensor) -> torch.Tensor:
    return spmv_acc(state, x).to(x.dtype)


def mul(state: CSSState, x: torch.Tensor) -> torch.Tensor:
    return ss.mul(state, x)


def phases(state: CSSState):
    if state.variant == "optimized":
        return {"MulScan": spmv_scan_phase, "Sum2": ss.reduce}
    return ss.phases(state)


traffic_bytes = ss.traffic_bytes
step_init = ss.step_init      # the step timing shares ss's scan levels
step_fns = ss.step_fns


def report_fields(state: CSSState, cfg: Config) -> dict:
    out = ss.report_fields(state, cfg)
    out["N_BLOCK"] = state.n_block
    out["BlockCols"] = state.block_cols
    return out


def to_coo(state: CSSState) -> COOMatrix:
    """Inverse conversion, as ss's (rows re-sorted)."""
    return ss.to_coo(state)
