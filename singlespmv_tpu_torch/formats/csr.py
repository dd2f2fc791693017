"""CSR — the row-pointer baseline of ``singlespmv_tpu/formats/csr.py``.

The layout is the reference's: the CSR arrays plus the row-id expansion of
``row_ptr`` padded to a multiple of ``PAD_MULTIPLE`` (pads: value 0 on the
last row).  The reference computes the product in XLA (a gather and a sorted
segment sum, ``ops/segsum.py``), so the port does too in plain torch:
``index_select`` of x by column and a multiply (phase Mul), then
``index_add_`` by row (phase Sum), and for SpMM the same over the rows of
X.  It is auto's fallback that always exists, at any value type.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import Config
from ..core.dtypes import acc, to_host, value_tensor
from ..core.types import COOMatrix, round_up
from .base import TensorState, check_dtype
from .slab import _t

PAD_MULTIPLE = 1024


@dataclasses.dataclass(frozen=True)
class CSRState(TensorState):
    n_row: int
    n_col: int
    nnz: int
    nnz_pad: int
    max_row_nnz: int
    variant: str
    row_ptr: torch.Tensor   # (n_row + 1,) index type
    rows: torch.Tensor      # (nnz_pad,) — expansion of row_ptr
    col: torch.Tensor       # (nnz_pad,)
    val: torch.Tensor       # (nnz_pad,) values


def convert(coo: COOMatrix, cfg: Config) -> CSRState:
    """Build the CSR arrays on the host; tensors come back on the CPU."""
    check_dtype("csr", cfg.dtype)
    nnz_pad = round_up(max(coo.nnz, 1), PAD_MULTIPLE)
    idx = cfg.index_dtype
    rp = coo.row_ptr().astype(idx)
    pad_row = int(coo.row[-1]) if coo.nnz else 0
    rows = np.full(nnz_pad, pad_row, dtype=idx)
    col = np.zeros(nnz_pad, dtype=idx)
    val = np.zeros(nnz_pad, dtype=cfg.np_dtype)
    rows[: coo.nnz] = coo.row
    col[: coo.nnz] = coo.col
    val[: coo.nnz] = coo.val.astype(cfg.np_dtype)
    return CSRState(
        n_row=coo.n_row, n_col=coo.n_col, nnz=coo.nnz, nnz_pad=nnz_pad,
        max_row_nnz=int(coo.row_lengths().max(initial=0)),
        variant=cfg.variant, row_ptr=_t(rp), rows=_t(rows), col=_t(col),
        val=value_tensor(val, cfg.dtype))


def mul(state: CSRState, x: torch.Tensor) -> torch.Tensor:
    """Phase Mul: val · x[col] over the padded stream."""
    return acc(state.val) * acc(x.index_select(0, state.col))


def reduce(state: CSRState, products: torch.Tensor) -> torch.Tensor:
    """Phase Sum: the products added into their rows."""
    y = torch.zeros(state.n_row, dtype=products.dtype,
                    device=products.device)
    if state.n_row:
        y.index_add_(0, state.rows, products)
    return y


def spmv_acc(state: CSRState, x: torch.Tensor) -> torch.Tensor:
    """y in the accumulator type (float32 for bfloat16 values)."""
    return reduce(state, mul(state, x))


def spmv(state: CSRState, x: torch.Tensor) -> torch.Tensor:
    return spmv_acc(state, x).to(x.dtype)


def phases(state: CSRState):
    return {"Mul": mul, "Sum": reduce}


def spmm_acc(state: CSRState, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X, X (n_col, B), in the accumulator type: products of the
    rows of X, summed by row."""
    products = acc(state.val)[:, None] * acc(X.index_select(0, state.col))
    Y = torch.zeros(state.n_row, X.shape[1], dtype=products.dtype,
                    device=X.device)
    if state.n_row:
        Y.index_add_(0, state.rows, products)
    return Y


def spmm(state: CSRState, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X, X (n_col, B), rounded once to X's type."""
    return spmm_acc(state, X).to(X.dtype)


def report_fields(state: CSRState, cfg: Config) -> dict:
    return {"MaxRowNnz": state.max_row_nnz}


def to_coo(state: CSRState) -> COOMatrix:
    """Inverse conversion."""
    n = state.nnz
    return COOMatrix.from_triplets(
        state.n_row, state.n_col, state.rows[:n].cpu().numpy(),
        state.col[:n].cpu().numpy(), to_host(state.val[:n]), sort=False)
