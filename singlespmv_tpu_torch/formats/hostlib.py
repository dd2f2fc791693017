"""HOSTLIB — the host library baseline of
``singlespmv_tpu/formats/hostlib.py`` (registered as ``hostlib`` and, by
the reference's slot name, ``mkl``).

singleSpMV's MKL slot calls ``mkl_dcsrmv`` on the host as an independent
library that cross-checks every other format through the same harness.
The reference's equivalent, kept here, is scipy.sparse's compiled CSR
product on the host.  It is a baseline, not a fallback: it declares
``PREFERRED_DEVICE = "cpu"``, and the driver puts its state and x on the
CPU and times it with a host loop, as the reference's driver places it on
the CPU device (the reference's MKL never ran on an accelerator either).

The state holds the CSR arrays (duplicates summed) and each call wraps
them in a ``scipy.sparse.csr_matrix``, so a state is plain tensors like
every other and the converted-state cache stores it as such.  ``spmm`` is
``mat @ X``.  Values are float32 or float64; the report names the library
and its version.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import Config
from ..core.dtypes import value_size
from ..core.types import COOMatrix
from .base import TensorState, check_dtype

STATE_REV = 1   # bump with a change of the layout (formats/cache.py)
PREFERRED_DEVICE = "cpu"


@dataclasses.dataclass(frozen=True)
class HostLibState(TensorState):
    n_row: int
    n_col: int
    nnz: int
    indptr: torch.Tensor    # (max(n_row, 1) + 1,) int32
    indices: torch.Tensor   # (stored,) int32
    data: torch.Tensor      # (stored,) values


def convert(coo: COOMatrix, cfg: Config) -> HostLibState:
    """Builds the CSR arrays with scipy on the host; tensors on the CPU."""
    import scipy.sparse as sp

    check_dtype("hostlib", cfg.dtype)
    if cfg.dtype == "bfloat16":
        # the reference's scipy path refuses it the same way
        raise ValueError("hostlib: scipy.sparse does not support dtype "
                         "bfloat16")
    mat = sp.csr_matrix(
        (coo.val.astype(cfg.np_dtype), (coo.row, coo.col)),
        shape=(max(coo.n_row, 1), max(coo.n_col, 1)))
    mat.sum_duplicates()
    return HostLibState(
        n_row=coo.n_row, n_col=coo.n_col, nnz=coo.nnz,
        indptr=torch.from_numpy(mat.indptr.astype(np.int32)),
        indices=torch.from_numpy(mat.indices.astype(np.int32)),
        data=torch.from_numpy(np.ascontiguousarray(mat.data)))


def matrix(state: HostLibState):
    """The scipy CSR matrix over the state's arrays (no copy)."""
    import scipy.sparse as sp

    return sp.csr_matrix(
        (state.data.numpy(), state.indices.numpy(), state.indptr.numpy()),
        shape=(max(state.n_row, 1), max(state.n_col, 1)))


def _host(t: torch.Tensor) -> np.ndarray:
    if t.device.type != "cpu":
        raise ValueError(f"hostlib runs on the host; its input is on "
                         f"{t.device} (PREFERRED_DEVICE is cpu)")
    return t.numpy()


def spmv(state: HostLibState, x: torch.Tensor) -> torch.Tensor:
    """A @ x in the state's value type: one library call, x a vector or,
    as ``spmm``, an (n_col, B) panel."""
    dt = state.data.numpy().dtype
    y = matrix(state) @ np.asarray(_host(x), dtype=dt)
    return torch.from_numpy(np.ascontiguousarray(y[: state.n_row], dt))


spmm = spmv     # Y = A @ X, X (n_col, B)


def to_coo(state: HostLibState) -> COOMatrix:
    """Inverse conversion."""
    m = matrix(state).tocoo()
    return COOMatrix.from_triplets(state.n_row, state.n_col, m.row, m.col,
                                   m.data, sort=True)


def report_fields(state: HostLibState, cfg: Config) -> dict:
    import scipy

    return {"Library": f"scipy.sparse {scipy.__version__}"}


def traffic_bytes(state: HostLibState, cfg: Config) -> int:
    # the standard CSR traffic model (CSR5's detail/utils.h:10-14)
    vsz = value_size(cfg.dtype)
    return ((state.n_row + 1 + state.nnz) * 4
            + (2 * state.nnz + state.n_row) * vsz)
