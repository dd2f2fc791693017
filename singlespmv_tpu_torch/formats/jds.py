"""JDS — the jagged diagonals of ``singlespmv_tpu/formats/jds.py``.

Rows are sorted stably by descending length and stored in ell's transposed
(K, n_row_pad) layout (``ell._ell_arrays``) of the permuted matrix;
``inv_perm`` maps each row to its place, so y = y_perm[inv_perm].  The
reference computes the product in XLA, so the port does too in plain
torch: ell's products (phase Mul), then their sum over K and the gather by
``inv_perm`` (phase Sum).  Values are float32 or float64.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import Config
from ..core.dtypes import to_host, value_tensor
from ..core.types import COOMatrix, round_up
from .base import TensorState, check_dtype
from .ell import _ell_arrays, mul
from .slab import _t

STATE_REV = 1   # bump with a change of the layout (formats/cache.py)


@dataclasses.dataclass(frozen=True)
class JDSState(TensorState):
    n_row: int
    n_col: int
    nnz: int
    k: int
    n_row_pad: int
    col: torch.Tensor       # (k, n_row_pad), rows by descending length
    val: torch.Tensor       # (k, n_row_pad) values
    inv_perm: torch.Tensor  # (n_row,): y[r] = y_perm[inv_perm[r]]


def convert(coo: COOMatrix, cfg: Config) -> JDSState:
    """Sorts the rows and builds the ELL arrays on the host; tensors come
    back on the CPU."""
    check_dtype("jds", cfg.dtype)
    lengths = coo.row_lengths()
    # a stable descending sort, as the reference's sort by nnz
    perm = np.argsort(-lengths, kind="stable")
    inv_perm = np.empty_like(perm)
    inv_perm[perm] = np.arange(coo.n_row)
    permuted = COOMatrix.from_triplets(
        coo.n_row, coo.n_col, inv_perm[coo.row], coo.col, coo.val,
        index_bits=cfg.index_bits)
    k = max(1, int(lengths.max(initial=0)))
    n_row_pad = round_up(max(coo.n_row, 1), cfg.lane_width)
    col, val = _ell_arrays(permuted, k, n_row_pad, cfg.index_dtype,
                           cfg.np_dtype)
    return JDSState(n_row=coo.n_row, n_col=coo.n_col, nnz=coo.nnz, k=k,
                    n_row_pad=n_row_pad, col=_t(col),
                    val=value_tensor(val, cfg.dtype),
                    inv_perm=_t(inv_perm.astype(cfg.index_dtype)))


def reduce(state: JDSState, products: torch.Tensor) -> torch.Tensor:
    """Phase Sum: the sum over K, then each row from its sorted place."""
    return products.sum(dim=0).index_select(0, state.inv_perm)


def spmv(state: JDSState, x: torch.Tensor) -> torch.Tensor:
    return reduce(state, mul(state, x)).to(x.dtype)


def phases(state: JDSState):
    return {"Mul": mul, "Sum": reduce}


def report_fields(state: JDSState, cfg: Config) -> dict:
    return {"MaxLength": state.k}


def to_coo(state: JDSState) -> COOMatrix:
    """Inverse conversion; rows back in place (explicit zeros dropped)."""
    col = state.col.cpu().numpy()
    val = to_host(state.val)
    perm = np.argsort(state.inv_perm.cpu().numpy(), kind="stable")
    k, r = np.nonzero(val)
    return COOMatrix.from_triplets(state.n_row, state.n_col, perm[r],
                                   col[k, r], val[k, r], sort=True)
