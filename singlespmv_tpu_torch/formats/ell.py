"""ELL — the transposed ELLPACK of ``singlespmv_tpu/formats/ell.py``.

Every row is padded to K = the longest row's length, and the layout is the
reference's transposed one: col and val are (K, n_row_pad), rows along the
second axis, so the k-th entry of every row is one contiguous vector; pads
are col 0 and val 0.  The reference computes the product in XLA, so the
port does too in plain torch: the (K, n_row_pad) products val · x[col]
(phase Mul), summed over K (phase Sum).  ``spmm`` runs over the K slots,
adding val[k] · X[col[k]] into an (n_row_pad, B) accumulator, as the
reference's ``lax.scan`` does, so it never holds (K, n_row_pad, B).
Values are float32 or float64.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import Config
from ..core.dtypes import acc, acc_dtype, to_host, value_size, value_tensor
from ..core.types import COOMatrix, round_up
from .base import TensorState, check_dtype
from .slab import _t

STATE_REV = 1   # bump with a change of the layout (formats/cache.py)


@dataclasses.dataclass(frozen=True)
class ELLState(TensorState):
    n_row: int
    n_col: int
    nnz: int
    k: int              # the longest row's length (the ELL width)
    n_row_pad: int
    col: torch.Tensor   # (k, n_row_pad) index type
    val: torch.Tensor   # (k, n_row_pad) values


def _ell_arrays(coo: COOMatrix, k: int, n_row_pad: int, idx_dtype,
                val_dtype):
    """The transposed (K, R) ELL arrays of row-sorted triplets."""
    col = np.zeros((k, n_row_pad), dtype=idx_dtype)
    val = np.zeros((k, n_row_pad), dtype=val_dtype)
    if coo.nnz:
        rp = coo.row_ptr()
        j = np.arange(coo.nnz) - rp[coo.row]  # position within the row
        col[j, coo.row] = coo.col
        val[j, coo.row] = coo.val.astype(val_dtype)
    return col, val


def convert(coo: COOMatrix, cfg: Config) -> ELLState:
    """Builds the ELL arrays on the host; tensors come back on the CPU."""
    check_dtype("ell", cfg.dtype)
    k = max(1, int(coo.row_lengths().max(initial=0)))
    n_row_pad = round_up(max(coo.n_row, 1), cfg.lane_width)
    col, val = _ell_arrays(coo, k, n_row_pad, cfg.index_dtype, cfg.np_dtype)
    return ELLState(n_row=coo.n_row, n_col=coo.n_col, nnz=coo.nnz, k=k,
                    n_row_pad=n_row_pad, col=_t(col),
                    val=value_tensor(val, cfg.dtype))


def mul(state, x: torch.Tensor) -> torch.Tensor:
    """Phase Mul: the (K, n_row_pad) products val · x[col]."""
    return acc(state.val) * acc(x.index_select(
        0, state.col.reshape(-1)).view(state.col.shape))


def reduce(state: ELLState, products: torch.Tensor) -> torch.Tensor:
    """Phase Sum: each row's K products summed."""
    return products.sum(dim=0)[: state.n_row]


def spmv(state: ELLState, x: torch.Tensor) -> torch.Tensor:
    return reduce(state, mul(state, x)).to(x.dtype)


def phases(state: ELLState):
    return {"Mul": mul, "Sum": reduce}


def spmm_acc(state: ELLState, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X, X (n_col, B), in the accumulator type: one row gather of
    X a K slot, added into an (n_row_pad, B) accumulator."""
    Y = torch.zeros(state.n_row_pad, X.shape[1], dtype=acc_dtype(X.dtype),
                    device=X.device)
    for colk, valk in zip(state.col, state.val):
        Y += acc(valk)[:, None] * acc(X.index_select(0, colk))
    return Y[: state.n_row]


def spmm(state: ELLState, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X, X (n_col, B), rounded once to X's type."""
    return spmm_acc(state, X).to(X.dtype)


def report_fields(state: ELLState, cfg: Config) -> dict:
    return {"K": state.k, "PaddingRatio": round(
        state.k * state.n_row_pad / max(state.nnz, 1), 4)}


def traffic_bytes(state: ELLState, cfg: Config) -> int:
    isz = 4 if cfg.index_bits == 32 else 8
    vsz = value_size(cfg.dtype)
    stored = state.k * state.n_row_pad
    return stored * (isz + vsz) + (stored + state.n_row) * vsz


def to_coo(state: ELLState) -> COOMatrix:
    """Inverse conversion; explicit stored zeros are dropped (they look
    like ELL padding)."""
    col = state.col.cpu().numpy()
    val = to_host(state.val)
    k, r = np.nonzero(val)
    return COOMatrix.from_triplets(state.n_row, state.n_col, r, col[k, r],
                                   val[k, r], sort=True)
