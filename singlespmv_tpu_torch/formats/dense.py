"""Dense — the densified baseline of ``singlespmv_tpu/formats/dense.py``.

The matrix is stored dense, (n_row padded to 8) × (n_col padded to 128),
within the reference's density guard, and the product is one
``torch.matmul`` (a matrix-vector product, or for SpMM a matrix product),
as the reference's is one XLA ``jnp.dot``.  A float32 ``torch.matmul`` on
the card runs in full float32 unless the caller enables TF32.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import Config
from ..core.dtypes import acc, to_host, value_size, value_tensor
from ..core.types import COOMatrix, round_up
from .base import TensorState, check_dtype

MAX_DENSE_ELEMENTS = 1 << 28  # 1 GiB of f32


@dataclasses.dataclass(frozen=True)
class DenseState(TensorState):
    n_row: int
    n_col: int
    nnz: int
    mat: torch.Tensor    # (n_row_pad, n_col_pad) values


def convert(coo: COOMatrix, cfg: Config) -> DenseState:
    """Densify on the host; the tensor comes back on the CPU."""
    check_dtype("dense", cfg.dtype)
    rp = round_up(max(coo.n_row, 1), 8)
    cp = round_up(max(coo.n_col, 1), 128)
    if rp * cp > MAX_DENSE_ELEMENTS:
        raise ValueError(
            f"dense baseline: {coo.n_row}x{coo.n_col} exceeds the density "
            "guard")
    mat = np.zeros((rp, cp), dtype=cfg.np_dtype)
    np.add.at(mat, (coo.row, coo.col), coo.val.astype(cfg.np_dtype))
    return DenseState(n_row=coo.n_row, n_col=coo.n_col, nnz=coo.nnz,
                      mat=value_tensor(mat, cfg.dtype))


def spmv(state: DenseState, x: torch.Tensor) -> torch.Tensor:
    xp = torch.zeros(state.mat.shape[1], dtype=x.dtype, device=x.device)
    xp[: state.n_col] = x
    return torch.matmul(state.mat, xp)[: state.n_row]


def spmm_acc(state: DenseState, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X, X (n_col, B), in the accumulator type: one matrix
    product of the widened matrix and panel."""
    Xp = torch.zeros(state.mat.shape[1], X.shape[1], dtype=X.dtype,
                     device=X.device)
    Xp[: state.n_col] = X
    return torch.matmul(acc(state.mat), acc(Xp))[: state.n_row]


def spmm(state: DenseState, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X, X (n_col, B), rounded once to X's type."""
    return spmm_acc(state, X).to(X.dtype)


def traffic_bytes(state: DenseState, cfg: Config) -> int:
    vsz = value_size(cfg.dtype)
    return (state.mat.shape[0] * state.mat.shape[1] + state.n_col
            + state.n_row) * vsz


def to_coo(state: DenseState) -> COOMatrix:
    """Inverse conversion (explicit zeros dropped)."""
    mat = to_host(state.mat)[: state.n_row, : state.n_col]
    r, c = np.nonzero(mat)
    return COOMatrix.from_triplets(state.n_row, state.n_col, r, c, mat[r, c],
                                   sort=True)
