"""HYB — dense-diagonal peel plus a scattered residual, as in
``singlespmv_tpu/formats/hyb.py``.

Every diagonal offset whose nonzero count clears the reference's cost-model
threshold is peeled into a DIA table (``formats/dia.py``); the rest of the
matrix rides the cheapest scattered engine.  ``plan_peel``,
``_diag_histogram`` and ``_split`` are copies of the reference's (it imports
``jax.numpy`` through its dia module, so it cannot be imported here), and one
COO gives the same peel and residual in both packages.

The residual rides the cheapest of the scattered engines — bkt, bkt_g,
bsr, css, slab and xch (``REST_MODULES``, the reference's
``_rest_modules()``) — ranked by the port's ``auto.estimate_costs`` on the
residual, as the reference ranks its own with its ``auto.estimate_costs``.
An engine whose convert refuses (css's padding guard, a ``ValueError``) is
passed over for the next.

``spmm`` takes the dia part by the column loop of its spmv, as the
reference vmaps it, plus the residual's ``spmm`` where its engine has one,
else the column loop of the residual's spmv.

Values are float32, float64 or bfloat16 (``base.check_dtype``); at
bfloat16 the peel and the residual are summed in float32 and y is rounded
once.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..core.dtypes import to_host
from ..core.types import COOMatrix, round_up

from . import bkt as bkt_mod
from . import bsr as bsr_mod
from . import css as css_mod
from . import dia as dia_mod
from . import slab as slab_mod
from . import xch as xch_mod
from .base import TensorState, acc_spmm, acc_spmv, check_dtype, column_loop

# the reference's cost-model constants (TPU v5e, measured there)
HBM_BPS = 700e9          # streamed bytes/s achieved
DIA_BYTES_PER_SLOT = 8   # diag element + x element (f32)
RESID_SEC_PER_NNZ = 0.5e-9   # scattered-path marginal cost
MAX_PEEL_ELEMENTS = 1 << 28  # respect dia's density guard (1 GiB of f32)

REST_MODULES = {"bkt": bkt_mod, "bkt_g": bkt_mod, "bsr": bsr_mod,
                "css": css_mod, "slab": slab_mod, "xch": xch_mod}


def _diag_histogram(coo: COOMatrix):
    """Offset histogram of col-row; returns (offsets, counts) sorted by count
    descending."""
    if not coo.nnz:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    offs = coo.col.astype(np.int64) - coo.row.astype(np.int64)
    uniq, counts = np.unique(offs, return_counts=True)
    order = np.argsort(-counts, kind="stable")
    return uniq[order], counts[order]


def plan_peel(coo: COOMatrix, cfg: Config):
    """Greedy diagonal selection: peel offsets (densest first) while the DIA
    stream cost of one more diagonal is below the scattered-path cost of its
    nnz, within dia's memory guard.  Returns (peel_offsets, peel_nnz)."""
    uniq, counts = _diag_histogram(coo)
    n_row_pad = round_up(max(coo.n_row, 1), cfg.lane_width)
    dia_sec_per_diag = n_row_pad * DIA_BYTES_PER_SLOT / HBM_BPS
    max_diags = max(0, int(MAX_PEEL_ELEMENTS // max(n_row_pad, 1)))
    gain = counts * RESID_SEC_PER_NNZ
    keep = gain > dia_sec_per_diag
    n_keep = min(int(keep.sum()), max_diags)
    return uniq[:n_keep], int(counts[:n_keep].sum())


def estimate(coo: COOMatrix, cfg: Config) -> dict:
    """Convert-free cost probe for ``formats.auto``: seconds of the DIA
    part, or infeasible when no diagonal clears the peel threshold."""
    peel_offs, peel_nnz = plan_peel(coo, cfg)
    resid_nnz = coo.nnz - peel_nnz
    feasible = peel_offs.size > 0 and peel_nnz >= max(coo.nnz // 8, 1)
    n_row_pad = round_up(max(coo.n_row, 1), cfg.lane_width)
    dia_sec = peel_offs.size * n_row_pad * DIA_BYTES_PER_SLOT / HBM_BPS
    return {"feasible": feasible, "n_diag": int(peel_offs.size),
            "peel_nnz": peel_nnz, "resid_nnz": int(resid_nnz),
            "dia_sec": dia_sec}


def _split(coo: COOMatrix, peel_offs: np.ndarray, cfg: Config):
    offs = coo.col.astype(np.int64) - coo.row.astype(np.int64)
    on_diag = np.isin(offs, peel_offs)
    dia_coo = COOMatrix.from_triplets(
        coo.n_row, coo.n_col, coo.row[on_diag], coo.col[on_diag],
        coo.val[on_diag], index_bits=cfg.index_bits, sort=True)
    rest_coo = COOMatrix.from_triplets(
        coo.n_row, coo.n_col, coo.row[~on_diag], coo.col[~on_diag],
        coo.val[~on_diag], index_bits=cfg.index_bits, sort=True)
    return dia_coo, rest_coo


@dataclasses.dataclass(frozen=True)
class HYBState(TensorState):
    n_row: int
    n_col: int
    nnz: int
    rest_fmt: str                  # "" when the residual is empty
    peel_nnz: int
    dia_state: dia_mod.DIAState
    rest_state: Optional[TensorState]   # the residual engine's state


def convert(coo: COOMatrix, cfg: Config) -> HYBState:
    """Peel and residual on the host; tensors come back on the CPU."""
    check_dtype("hyb", cfg.dtype)
    peel_offs, peel_nnz = plan_peel(coo, cfg)
    if peel_offs.size == 0 and coo.nnz:
        # stay valid on any input: peel the densest offset so the DIA part
        # is never empty
        uniq, counts = _diag_histogram(coo)
        peel_offs, peel_nnz = uniq[:1], int(counts[0])
    dia_coo, rest_coo = _split(coo, peel_offs, cfg)
    dia_state = dia_mod.convert(dia_coo, cfg)
    if rest_coo.nnz == 0:
        return HYBState(n_row=coo.n_row, n_col=coo.n_col, nnz=coo.nnz,
                        rest_fmt="", peel_nnz=peel_nnz,
                        dia_state=dia_state, rest_state=None)
    from .auto import estimate_costs

    plans = {}
    costs = estimate_costs(rest_coo, cfg, plans=plans, skip=("hyb",))
    last_err = None
    for name in sorted((k for k in costs if k in REST_MODULES),
                       key=costs.get):
        ccfg = cfg.replace(bkt_row_group=1024) if name == "bkt_g" else cfg
        kw = {"plan": plans[name]} if name in plans else {}
        try:
            rest_state = REST_MODULES[name].convert(rest_coo, ccfg, **kw)
            return HYBState(n_row=coo.n_row, n_col=coo.n_col, nnz=coo.nnz,
                            rest_fmt=name, peel_nnz=peel_nnz,
                            dia_state=dia_state, rest_state=rest_state)
        except (ValueError, TypeError) as e:
            last_err = e
    raise last_err if last_err else ValueError("hyb: no viable residual "
                                               "format")


def spmv(state: HYBState, x: torch.Tensor) -> torch.Tensor:
    """The peel and the residual summed in the accumulator type, y rounded
    once to x's type."""
    y = dia_mod.spmv_acc(state.dia_state, x)
    if state.rest_fmt:
        y = y + acc_spmv(REST_MODULES[state.rest_fmt])(state.rest_state, x)
    return y.to(x.dtype)


def adds_per_row(state: HYBState) -> np.ndarray:
    """The residual engine's k_i (``base.adds_per_row``), and one more on
    each row the peel touches: the peel's sum has a fixed order, but
    y = fl(d + s) rounds once more, by an amount that moves with the
    residual's s."""
    if not state.rest_fmt:
        return np.zeros(state.n_row, np.int64)
    mod = REST_MODULES[state.rest_fmt]
    fn = getattr(mod, "adds_per_row", None)
    k = fn(state.rest_state) if fn is not None \
        else mod.to_coo(state.rest_state).row_lengths()
    peel = (to_host(state.dia_state.diag) != 0).any(axis=0)
    return k + peel[: state.n_row]


def spmm_acc(state: HYBState, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X, X (n_col, B), in the accumulator type: the peel's column
    loop and the residual's spmm added before any rounding."""
    Y = column_loop(dia_mod.spmv_acc, state.dia_state, X)
    if state.rest_fmt:
        Y = Y + acc_spmm(REST_MODULES[state.rest_fmt])(state.rest_state, X)
    return Y


def spmm(state: HYBState, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X, X (n_col, B), rounded once to X's type."""
    return spmm_acc(state, X).to(X.dtype)


def report_fields(state: HYBState, cfg: Config) -> dict:
    out = {"PeelDiags": state.dia_state.n_diag, "PeelNnz": state.peel_nnz,
           "RestFormat": (state.rest_fmt or "none").upper(),
           "RestNnz": state.nnz - state.peel_nnz}
    if state.rest_fmt:
        out.update({f"Rest{k}": v for k, v in REST_MODULES[
            state.rest_fmt].report_fields(state.rest_state, cfg).items()})
    return out


def traffic_bytes(state: HYBState, cfg: Config) -> int:
    total = dia_mod.traffic_bytes(state.dia_state, cfg)
    if state.rest_fmt:
        total += int(REST_MODULES[state.rest_fmt].traffic_bytes(
            state.rest_state, cfg))
    return total


def to_coo(state: HYBState) -> COOMatrix:
    dia_coo = dia_mod.to_coo(state.dia_state)
    if not state.rest_fmt:
        return dia_coo
    rest = REST_MODULES[state.rest_fmt].to_coo(state.rest_state)
    return COOMatrix.from_triplets(
        state.n_row, state.n_col,
        np.concatenate([dia_coo.row, rest.row.astype(dia_coo.row.dtype)]),
        np.concatenate([dia_coo.col, rest.col.astype(dia_coo.col.dtype)]),
        np.concatenate([dia_coo.val, rest.val]),
        sort=True, sum_duplicates=True)
