"""BCOO — the library baseline of ``singlespmv_tpu/formats/bcoo.py``.

The reference benchmarks XLA's own sparse support, ``jax.experimental.
sparse.BCOO``, through the same harness as every format, as the vendor
library slot that cross-checks the others (singleSpMV calls cuSPARSE's
``cusparseDcsrmv`` there).  The port's library slot is PyTorch's own: a
coalesced ``torch.sparse_coo_tensor`` multiplied by ``@``, which on the
card runs cuSPARSE.  It is a library baseline by design, not the port of
a kernel.  It has no ``spmm``: ``spmm_fn`` loops its spmv over the columns,
as the reference vmaps it.  Values are float32, float64 or bfloat16.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import Config
from ..core.dtypes import acc, to_host, value_tensor
from ..core.types import COOMatrix
from .base import TensorState, check_dtype

STATE_REV = 1   # bump with a change of the layout (formats/cache.py)


@dataclasses.dataclass(frozen=True)
class BCOOState(TensorState):
    n_row: int
    n_col: int
    nnz: int
    mat: torch.Tensor    # coalesced sparse COO, (n_row, n_col)


def sparse_coo(indices: torch.Tensor, values: torch.Tensor,
               shape) -> torch.Tensor:
    """The coalesced sparse COO tensor of (2, nnz) ``indices`` and
    ``values``."""
    return torch.sparse_coo_tensor(indices, values, tuple(shape),
                                   check_invariants=True).coalesce()


def convert(coo: COOMatrix, cfg: Config) -> BCOOState:
    """Builds the sparse tensor on the host; it comes back on the CPU."""
    check_dtype("bcoo", cfg.dtype)
    indices = torch.from_numpy(np.stack([coo.row, coo.col]).astype(np.int64))
    values = value_tensor(coo.val, cfg.dtype)
    return BCOOState(n_row=coo.n_row, n_col=coo.n_col, nnz=coo.nnz,
                     mat=sparse_coo(indices, values, (coo.n_row, coo.n_col)))


def spmv(state: BCOOState, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` by the library; bfloat16 values and x widened to float32
    for it (torch's bfloat16 sparse product sums in bfloat16), y rounded
    once."""
    return (acc(state.mat) @ acc(x)).to(x.dtype)


def to_coo(state: BCOOState) -> COOMatrix:
    """Inverse conversion."""
    idx = state.mat.indices().cpu().numpy()
    val = to_host(state.mat.values())
    return COOMatrix.from_triplets(state.n_row, state.n_col, idx[0], idx[1],
                                   val, sort=True)
