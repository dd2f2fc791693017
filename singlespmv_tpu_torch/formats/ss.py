"""SS — the segmented-scan format of ``singlespmv_tpu/formats/ss.py``.

The nnz stream is cut into H stream rows of width W (``segment_width``
rounded up to the lane width); SpMV runs three phases:

- Mul: products = val · x[col] over the (H, W) stream (an ``index_select``
  and a multiply);
- Sum1: the segmented inclusive scan of each stream row with the run heads:
  the ``segmented_scan_tiles`` kernel (``ops/segscan.py``) for the
  "optimized" variant, the plain Hillis–Steele loop (``ops/segsum.py``) for
  "simple", as the reference runs its Pallas kernel or XLA;
- Sum2: each run's total at its end lane (``end_pos``), added into its row
  (``rank_rows``; ghost id ``n_row`` for padding, dropped).  The port adds
  only the real runs, through a flat index of their end slots
  (``run_pos``, ``run_rows``, built at convert from those two): the
  reference's combine sends every ghost slot into one bin, which on the
  card is one address under millions of atomic adds.

``build_stream`` is a copy of the reference's, array for array, but for the
heads, which are stored once as uint8 (the reference keeps bool and casts to
int32 on every call).  css builds its stream with it too.  ``step_init``
and ``step_fns`` serve the driver's step timing: the Sum1 scan one tree
level at a time, in plain torch as the reference computes them.  Values are
float32 or float64 (``base.check_dtype``).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..config import Config
from ..core.dtypes import acc, to_host, value_size, value_tensor
from ..core.types import COOMatrix, round_up
from ..ops.segscan import segmented_scan_tiles
from ..ops.segsum import combine_runs, segmented_scan_inclusive
from .base import TensorState, check_dtype, state_from_arrays
from .slab import _t


@dataclasses.dataclass(frozen=True)
class SSState(TensorState):
    n_row: int
    n_col: int
    nnz: int
    w: int                    # SEGMENT_WIDTH in elements
    h: int                    # number of stream rows
    r_max: int                # max row-runs per stream row
    variant: str              # simple | optimized
    n_step: int               # log2(W) scan depth (reported as nStep)
    step_counts: tuple        # runs longer than 2^i, per step i
    sorted_combine: bool
    col: torch.Tensor         # (H, W) index type
    val: torch.Tensor         # (H, W) values
    heads: torch.Tensor       # (H, W) uint8 — 1 at each run's first slot
    end_pos: torch.Tensor     # (H, R_max) int32 — lane of each run's end
    rank_rows: torch.Tensor   # (H, R_max) index type — row per run (ghost
    #                           n_row)
    run_pos: torch.Tensor     # (P,) int64 — flat end slot of each real run
    run_rows: torch.Tensor    # (P,) index type — its row


def run_index(end_pos: np.ndarray, rank_rows: np.ndarray, n_row: int,
              w: int):
    """The flat end slots and rows of the real runs of an (H, W) stream, in
    stream order: ``end_pos`` and ``rank_rows`` without the ghost slots."""
    hh, rr = np.nonzero(rank_rows != n_row)
    return (hh.astype(np.int64) * w + end_pos[hh, rr],
            np.ascontiguousarray(rank_rows[hh, rr]))


def _with_run_index(arrays: dict) -> dict:
    """A reference state's fields with the port's run index added."""
    pos, rows = run_index(np.asarray(arrays["end_pos"]),
                          np.asarray(arrays["rank_rows"]), arrays["n_row"],
                          arrays["w"])
    return dict(arrays, run_pos=pos, run_rows=rows)


def build_stream(coo: COOMatrix, cfg: Config, *, rows=None, cols=None,
                 vals=None, sorted_combine: bool = True, cls=SSState,
                 min_h: int = 0, min_r_max: int = 0, **extra):
    """Lays out the stream, for ss and for css (which passes its
    block-ordered triplets, its state class ``cls`` and its own fields
    ``extra``).  ``min_h`` and ``min_r_max`` force the least H and R_max,
    as in the reference: the sharded operators (``parallel/``) give every
    shard's stream the same shape, so that the shards stack."""
    check_dtype("ss", cfg.dtype)
    w = max(cfg.lane_width, round_up(cfg.segment_width, cfg.lane_width))
    if rows is None:
        rows, cols, vals = coo.row, coo.col, coo.val
    nnz = int(rows.shape[0])
    nnz_pad = max(round_up(max(nnz, 1), w), min_h * w)
    h = nnz_pad // w
    idx = cfg.index_dtype

    row_s = np.full(nnz_pad, coo.n_row, dtype=np.int64)  # ghost row pads
    col_s = np.zeros(nnz_pad, dtype=idx)
    val_s = np.zeros(nnz_pad, dtype=cfg.np_dtype)
    row_s[:nnz] = rows
    col_s[:nnz] = cols
    val_s[:nnz] = np.asarray(vals, dtype=cfg.np_dtype)

    pos = np.arange(nnz_pad)
    prev = np.empty(nnz_pad, dtype=np.int64)
    prev[0] = -1
    prev[1:] = row_s[:-1]
    heads_flat = (pos % w == 0) | (row_s != prev)
    nxt = np.empty(nnz_pad, dtype=np.int64)
    nxt[-1] = -1
    nxt[:-1] = row_s[1:]
    ends_flat = (pos % w == w - 1) | (row_s != nxt)

    heads2d = heads_flat.reshape(h, w)
    rank2d = np.cumsum(heads2d, axis=1) - 1
    n_runs = rank2d[:, -1] + 1
    r_max = max(round_up(int(n_runs.max(initial=1)), 8), min_r_max)

    end_pos = np.zeros((h, r_max), dtype=np.int32)
    rank_rows = np.full((h, r_max), coo.n_row, dtype=idx)
    hh, ww = np.nonzero(ends_flat.reshape(h, w))
    rr = rank2d[hh, ww]
    end_pos[hh, rr] = ww
    rank_rows[hh, rr] = row_s.reshape(h, w)[hh, ww]
    run_pos, run_rows = run_index(end_pos, rank_rows, coo.n_row, w)

    # StepCount-i: row-runs still merging at tree level i (length > 2^i)
    run_ids = np.cumsum(heads_flat) - 1
    run_len = np.bincount(run_ids)
    n_step = int(math.ceil(math.log2(w)))
    step_counts = tuple(int((run_len > (1 << i)).sum()) for i in range(n_step))

    return cls(
        n_row=coo.n_row, n_col=coo.n_col, nnz=nnz, w=w, h=h, r_max=r_max,
        variant=cfg.variant, n_step=n_step,
        step_counts=step_counts, sorted_combine=sorted_combine,
        col=_t(col_s.reshape(h, w)),
        val=value_tensor(val_s.reshape(h, w), cfg.dtype),
        heads=_t(heads2d.astype(np.uint8)), end_pos=_t(end_pos),
        rank_rows=_t(rank_rows), run_pos=_t(run_pos), run_rows=_t(run_rows),
        **extra)


def convert(coo: COOMatrix, cfg: Config) -> SSState:
    """Build the stream on the host; tensors come back on the CPU."""
    return build_stream(coo, cfg)


def state_from_reference(arrays: dict) -> SSState:
    """The port's state from the fields of a reference ``SSState``, given as
    numpy arrays and scalars."""
    return state_from_arrays(SSState, _with_run_index(arrays), "ss")


def _check_x(state: SSState, x: torch.Tensor):
    if x.dtype != state.val.dtype:
        raise TypeError(f"ss: x is {x.dtype}, the state holds "
                        f"{state.val.dtype} values")


def mul(state: SSState, x: torch.Tensor) -> torch.Tensor:
    return state.val * x.index_select(0, state.col.view(-1)).view(
        state.h, state.w)


def scan(state: SSState, products: torch.Tensor) -> torch.Tensor:
    """The scan of the products, in the accumulator type (float32 for
    bfloat16 products)."""
    if state.variant == "optimized":
        return segmented_scan_tiles(products, state.heads)
    return segmented_scan_inclusive(acc(products), state.heads)


def reduce(state: SSState, scanned: torch.Tensor) -> torch.Tensor:
    return combine_runs(scanned, state.run_pos, state.run_rows, state.n_row)


def spmv_acc(state: SSState, x: torch.Tensor) -> torch.Tensor:
    """y in the accumulator type: the products are of the value type (at
    bfloat16 each rounded once, as the reference's), their scan and sums
    float32."""
    _check_x(state, x)
    return reduce(state, scan(state, mul(state, x)))


def spmv(state: SSState, x: torch.Tensor) -> torch.Tensor:
    return spmv_acc(state, x).to(x.dtype)


def phases(state: SSState):
    return {"Mul": mul, "Sum1": scan, "Sum2": reduce}


def step_init(state: SSState, x: torch.Tensor) -> torch.Tensor:
    """The packed (2, H, W) carry of the step timing: the products and the
    run heads as values."""
    prod = acc(mul(state, x))
    return torch.stack([prod, state.heads.to(prod.dtype)])


def step_fns(state: SSState):
    """[(name, fn)], one fn(state, carry) per level of the scan tree (the
    reference's ``formats/ss.py:160-182``): step i applies the
    distance-2^i segmented shift-add to the packed carry of step i − 1, so
    the last step's values are the Sum1 scan."""
    def make(d):
        def step(st, vf):
            v, f = vf[0], vf[1]
            vz = torch.cat([torch.zeros_like(v[:, :d]), v[:, :-d]], dim=1)
            fz = torch.cat([torch.ones_like(f[:, :d]), f[:, :-d]], dim=1)
            return torch.stack([torch.where(f > 0, v, v + vz),
                                torch.maximum(f, fz)])

        return step

    steps = []
    d, i = 1, 0
    while d < state.w:
        steps.append((f"{i:02d}", make(d)))
        d *= 2
        i += 1
    return steps


def report_fields(state: SSState, cfg: Config) -> dict:
    vsz = value_size(cfg.dtype)
    out = {"nStep": state.n_step, "SEGMENT_WIDTH(byte)": state.w * vsz,
           "R_max": state.r_max}
    for i, c in enumerate(state.step_counts):
        out[f"StepCount-{i:02d}"] = c
    return out


def traffic_bytes(state: SSState, cfg: Config) -> int:
    isz = 4 if cfg.index_bits == 32 else 8
    vsz = value_size(cfg.dtype)
    stream = state.h * state.w
    combine = state.h * state.r_max
    return (stream * (isz + vsz)       # col + val reads
            + stream * vsz             # x gather (counted once)
            + combine * (isz + vsz)    # end_pos/rank_rows + partial traffic
            + state.n_row * vsz)       # y write


def stream_rows(heads, rank_rows) -> np.ndarray:
    """Each stream element's row id, from the heads and the run rows."""
    heads = np.asarray(heads).astype(np.int64)
    rank = np.cumsum(heads, axis=1) - 1
    return np.take_along_axis(np.asarray(rank_rows), rank, axis=1)


def to_coo(state: SSState) -> COOMatrix:
    """Inverse conversion (explicit zeros dropped)."""
    rows = stream_rows(state.heads.cpu().numpy(),
                       state.rank_rows.cpu().numpy())
    col = state.col.cpu().numpy()
    val = to_host(state.val)
    keep = (rows < state.n_row) & (val != 0)
    return COOMatrix.from_triplets(state.n_row, state.n_col, rows[keep],
                                   col[keep], val[keep], sort=True)
