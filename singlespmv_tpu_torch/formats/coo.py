"""COO — the triplet format of ``singlespmv_tpu/formats/coo.py``.

The layout is the reference's: row, col and val padded to a multiple of
``PAD_MULTIPLE`` with value-0 pads on the last row, so the stream stays
row-sorted.  The reference computes the product in XLA (a gather, then a
sorted segment sum), so the port does too in plain torch: ``index_select``
of x by column and a multiply (phase Mul), then ``segment_sum_sorted``'s
``index_add_`` by row (phase Sum).  Values are float32 or float64.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import Config
from ..core.dtypes import acc, to_host, value_tensor
from ..core.types import COOMatrix, round_up
from ..ops.segsum import segment_sum_sorted
from .base import TensorState, check_dtype
from .slab import _t

STATE_REV = 1   # bump with a change of the layout (formats/cache.py)
PAD_MULTIPLE = 1024  # 8 sublanes × 128 lanes


@dataclasses.dataclass(frozen=True)
class COOState(TensorState):
    n_row: int
    n_col: int
    nnz: int
    nnz_pad: int
    row: torch.Tensor   # (nnz_pad,) index type
    col: torch.Tensor   # (nnz_pad,)
    val: torch.Tensor   # (nnz_pad,) values


def convert(coo: COOMatrix, cfg: Config) -> COOState:
    """Pads the triplets on the host; tensors come back on the CPU."""
    check_dtype("coo", cfg.dtype)
    nnz_pad = round_up(max(coo.nnz, 1), PAD_MULTIPLE)
    idx = cfg.index_dtype
    # pads keep the stream row-sorted: the last row id with val 0
    pad_row = int(coo.row[-1]) if coo.nnz else 0
    row = np.full(nnz_pad, pad_row, dtype=idx)
    col = np.zeros(nnz_pad, dtype=idx)
    val = np.zeros(nnz_pad, dtype=cfg.np_dtype)
    row[: coo.nnz] = coo.row
    col[: coo.nnz] = coo.col
    val[: coo.nnz] = coo.val.astype(cfg.np_dtype)
    return COOState(n_row=coo.n_row, n_col=coo.n_col, nnz=coo.nnz,
                    nnz_pad=nnz_pad, row=_t(row), col=_t(col),
                    val=value_tensor(val, cfg.dtype))


def mul(state: COOState, x: torch.Tensor) -> torch.Tensor:
    """Phase Mul: val · x[col] over the padded stream."""
    return acc(state.val) * acc(x.index_select(0, state.col))


def reduce(state: COOState, products: torch.Tensor) -> torch.Tensor:
    """Phase Sum: the products added into their rows."""
    return segment_sum_sorted(products, state.row, state.n_row)


def spmv(state: COOState, x: torch.Tensor) -> torch.Tensor:
    return reduce(state, mul(state, x)).to(x.dtype)


def phases(state: COOState):
    return {"Mul": mul, "Sum": reduce}


def report_fields(state: COOState, cfg: Config) -> dict:
    return {"nNnzPad": state.nnz_pad}


def to_coo(state: COOState) -> COOMatrix:
    """Inverse conversion."""
    n = state.nnz
    return COOMatrix.from_triplets(
        state.n_row, state.n_col, state.row[:n].cpu().numpy(),
        state.col[:n].cpu().numpy(), to_host(state.val[:n]), sort=False)
