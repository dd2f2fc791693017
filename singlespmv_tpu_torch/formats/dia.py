"""DIA — the diagonal format of ``singlespmv_tpu/formats/dia.py``.

Layout (unchanged from the reference): the nonzeros bucket by diagonal offset
``col − row`` into a dense (n_diag, n_row_pad) table, and y = Σ_d diag[d] ·
x[row + off_d] over a zero-padded x.  The reference never wrote a kernel for
it (static shifted slices under XLA), so its spmv here is plain torch too.

Where the reference unrolls one slice per diagonal, the port takes every
window in O(1) launches: ``xp.unfold`` is a strided view of all n_row_pad
windows of the padded x, one ``index_select`` by ``offsets + x_pad_left``
gathers the n_diag windows it needs, and one multiply and one sum over the
diagonals give y.  A loop of two launches per diagonal would cost ~140
launches on a 69-offset peel, many times its device work.

Values are float32 or float64 (``base.check_dtype``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import Config
from ..core.dtypes import (acc, from_numpy, round_values, to_host, value_size,
                           value_tensor)
from ..core.types import COOMatrix, round_up

from .base import TensorState, check_dtype

MAX_DIA_ELEMENTS = 1 << 30  # density guard, the reference's: diagonals × rows


@dataclasses.dataclass(frozen=True)
class DIAState(TensorState):
    n_row: int
    n_col: int
    nnz: int
    n_diag: int
    n_row_pad: int
    x_pad_left: int       # zeros before x, so every row + offset is ≥ 0
    x_pad_len: int        # padded-x length
    offsets: tuple        # (n_diag,) diagonal offsets col − row, ascending
    diag: torch.Tensor    # (n_diag, n_row_pad) values
    window: torch.Tensor  # (n_diag,) int64: offsets + x_pad_left


def convert(coo: COOMatrix, cfg: Config) -> DIAState:
    """Build the diagonal table on the host; tensors come back on the CPU."""
    check_dtype("dia", cfg.dtype)
    offs = np.unique(coo.col.astype(np.int64) - coo.row.astype(np.int64)) \
        if coo.nnz else np.zeros(1, dtype=np.int64)
    n_diag = int(offs.shape[0])
    n_row_pad = round_up(max(coo.n_row, 1), cfg.lane_width)
    # scattered matrices (one diagonal per nnz) would explode memory
    if n_diag * n_row_pad > MAX_DIA_ELEMENTS:
        raise ValueError(
            f"DIA: {n_diag} diagonals x {n_row_pad} rows exceeds the density "
            f"guard ({MAX_DIA_ELEMENTS} elements) — use ss/csr5 for scattered "
            "matrices")
    diag = np.zeros((n_diag, n_row_pad), dtype=cfg.np_dtype)
    if coo.nnz:
        d = np.searchsorted(offs, coo.col.astype(np.int64)
                            - coo.row.astype(np.int64))
        # add.at: duplicate (row, col) triplets must accumulate
        np.add.at(diag, (d, coo.row), coo.val.astype(cfg.np_dtype))
        diag = round_values(diag, cfg.dtype)
    x_pad_left = int(max(0, -offs.min(initial=0)))
    # row + off ranges over [-x_pad_left, n_row_pad - 1 + max_off]
    x_pad_right = int(max(0, n_row_pad - 1 + offs.max(initial=0)
                          - (coo.n_col - 1)))
    return DIAState(
        n_row=coo.n_row, n_col=coo.n_col, nnz=coo.nnz, n_diag=n_diag,
        n_row_pad=n_row_pad, x_pad_left=x_pad_left,
        x_pad_len=coo.n_col + x_pad_left + x_pad_right,
        offsets=tuple(int(o) for o in offs),
        diag=value_tensor(diag, cfg.dtype),
        window=torch.from_numpy(offs + x_pad_left))


def state_from_reference(arrays: dict) -> DIAState:
    """The port's state from the fields of a reference ``DIAState``, given
    as numpy arrays and scalars."""
    kw = {f.name: arrays[f.name] for f in dataclasses.fields(DIAState)
          if f.name != "window"}
    kw["offsets"] = tuple(int(o) for o in kw["offsets"])
    kw["diag"] = from_numpy(np.array(kw["diag"]))
    check_dtype("dia", kw["diag"].dtype)
    kw["window"] = torch.tensor(kw["offsets"], dtype=torch.int64) \
        + kw["x_pad_left"]
    return DIAState(**kw)


def spmv(state: DIAState, x: torch.Tensor) -> torch.Tensor:
    """y = Σ_d diag[d] · x[row + off_d] over all diagonals at once, rounded
    once to x's type."""
    return spmv_acc(state, x).to(x.dtype)


def spmv_acc(state: DIAState, x: torch.Tensor) -> torch.Tensor:
    """``spmv`` in the accumulator type (float32 for bfloat16 values)."""
    if x.dtype != state.diag.dtype:
        raise TypeError(f"dia: x is {x.dtype}, the state holds "
                        f"{state.diag.dtype} values")
    xp = torch.zeros(state.x_pad_len + state.n_row_pad, dtype=x.dtype,
                     device=x.device)
    xp[state.x_pad_left: state.x_pad_left + state.n_col] = x
    windows = xp.unfold(0, state.n_row_pad, 1).index_select(0, state.window)
    return (acc(state.diag) * acc(windows)).sum(0)[: state.n_row]


def report_fields(state: DIAState, cfg: Config) -> dict:
    return {"nDiag": state.n_diag}


def traffic_bytes(state: DIAState, cfg: Config) -> int:
    vsz = value_size(cfg.dtype)
    stored = state.n_diag * state.n_row_pad
    return stored * 2 * vsz + state.n_row * vsz + state.n_diag * 4


def to_coo(state: DIAState) -> COOMatrix:
    """Inverse conversion (explicit zeros dropped)."""
    diag = to_host(state.diag)
    offs = np.asarray(state.offsets, dtype=np.int64)
    d, r = np.nonzero(diag)
    return COOMatrix.from_triplets(state.n_row, state.n_col, r, r + offs[d],
                                   diag[d, r], sort=True)
