"""ILU(0) / IC(0) incomplete factorizations of ``singlespmv_tpu/ops/ilu.py``.

The factorization is a one-time symbolic+numeric pass over the sparsity
pattern on the host: the IKJ loop runs native (``core/native/
factor_native.cpp``, ctypes-bound), with a numpy CSR fallback that gives
the same values where no compiler is present.  The triangular factors are
applied on the device through the level-scheduled SpTRSV plans
(``ops/sptrsv.py``): M⁻¹ = U⁻¹ L⁻¹ (ILU) or L⁻ᵀ L⁻¹ (IC), the
preconditioners of ``ops/solvers.py``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import Config
from ..core import native
from ..core.types import COOMatrix
from .sptrsv import LEVEL_NODES, TriSolveplan, analyze, solve


def _csr(coo: COOMatrix):
    """Row-sorted CSR views (int64 rp/cols, fresh f64 vals)."""
    rp = coo.row_ptr().astype(np.int64)
    order = np.lexsort((coo.col, coo.row))
    cols = coo.col.astype(np.int64)[order]
    vals = np.ascontiguousarray(coo.val.astype(np.float64)[order])
    return rp, cols, vals


def _ilu0_numpy(n, rp, cols, vals):
    """IKJ with a dense column-position workspace, in place on ``vals``."""
    pos = np.full(n, -1, dtype=np.int64)
    diag = np.full(n, -1, dtype=np.int64)
    rows = np.repeat(np.arange(n), np.diff(rp))
    dmask = cols == rows
    diag[rows[dmask]] = np.nonzero(dmask)[0]
    for i in range(n):
        sl = slice(rp[i], rp[i + 1])
        pos[cols[sl]] = np.arange(rp[i], rp[i + 1])
        for p in range(rp[i], rp[i + 1]):
            k = cols[p]
            if k >= i:
                break
            dk = diag[k]
            if dk < 0 or vals[dk] == 0.0:
                raise ValueError(f"ILU(0): zero pivot at row {k}")
            vals[p] /= vals[dk]
            lik = vals[p]
            q = slice(dk + 1, rp[k + 1])
            pj = pos[cols[q]]
            hit = pj >= 0
            np.subtract.at(vals, pj[hit], lik * vals[q][hit])
        pos[cols[sl]] = -1
    return vals


def _ic0_numpy(n, rp, cols, vals):
    """IC(0) on the lower pattern, in place on ``vals``."""
    pos = np.full(n, -1, dtype=np.int64)
    for i in range(n):
        sl = slice(rp[i], rp[i + 1])
        if rp[i + 1] == rp[i] or cols[rp[i + 1] - 1] != i:
            raise ValueError(f"IC(0): no diagonal stored at row {i}")
        pos[cols[sl]] = np.arange(rp[i], rp[i + 1])
        for p in range(rp[i], rp[i + 1]):
            k = cols[p]
            s = vals[p]
            q0, q1 = rp[k], rp[k + 1]
            j = cols[q0:q1]
            keep = j < k
            pj = pos[j[keep]]
            hit = pj >= 0
            if hit.any():
                s -= float(vals[pj[hit]] @ vals[q0:q1][keep][hit])
            if k < i:
                vals[p] = s / vals[rp[k + 1] - 1]
            else:
                if s <= 0.0:
                    raise ValueError(f"IC(0): non-positive pivot at row {i}")
                vals[p] = np.sqrt(s)
        pos[cols[sl]] = -1
    return vals


def ilu0(coo: COOMatrix) -> tuple:
    """Incomplete LU with zero fill-in on A's pattern.

    Returns (L, U) as COOMatrix: L unit-diagonal, its 1.0s stored; U upper,
    diagonal included."""
    n = coo.n_row
    if coo.n_row != coo.n_col:
        raise ValueError("ILU(0) needs a square matrix")
    rp, cols, vals = _csr(coo)

    rc = native.ilu0_csr(rp, cols, vals)
    if rc is None:
        _ilu0_numpy(n, rp, cols, vals)
    elif rc != 0:
        raise ValueError(f"ILU(0): zero pivot at row {rc - 1}")

    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(rp))
    lower = cols < rows
    upper = ~lower
    lr = np.concatenate([rows[lower], np.arange(n)])
    lc = np.concatenate([cols[lower], np.arange(n)])
    lv = np.concatenate([vals[lower], np.ones(n)])
    L = COOMatrix.from_triplets(n, n, lr, lc, lv, sort=True)
    U = COOMatrix.from_triplets(n, n, rows[upper], cols[upper], vals[upper],
                                sort=True)
    return L, U


def ic0(coo: COOMatrix) -> COOMatrix:
    """Incomplete Cholesky with zero fill-in for SPD matrices.

    Uses the lower-triangular part of A's pattern (diagonal required);
    returns L (lower, diagonal included) with L·Lᵀ ≈ A on the pattern."""
    n = coo.n_row
    if coo.n_row != coo.n_col:
        raise ValueError("IC(0) needs a square matrix")
    keep = coo.col <= coo.row
    low = COOMatrix.from_triplets(n, n, coo.row[keep], coo.col[keep],
                                  coo.val[keep], sort=True)
    rp, cols, vals = _csr(low)

    rc = native.ic0_csr(rp, cols, vals)
    if rc is None:
        _ic0_numpy(n, rp, cols, vals)
    elif rc != 0:
        # a missing diagonal and a non-positive pivot return alike
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(rp))
        d_ok = np.zeros(n, dtype=bool)
        d_ok[rows[cols == rows]] = True
        if not d_ok[rc - 1]:
            raise ValueError(f"IC(0): no diagonal stored at row {rc - 1}")
        raise ValueError(f"IC(0): non-positive pivot at row {rc - 1}")

    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(rp))
    return COOMatrix.from_triplets(n, n, rows, cols, vals, sort=True)


@dataclasses.dataclass(frozen=True)
class ILUPreconditioner:
    """M⁻¹ v = U⁻¹ (L⁻¹ v) through level-scheduled solves on the plans'
    device, in their value type."""
    l_plan: TriSolveplan
    u_plan: TriSolveplan

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        return solve(self.u_plan, solve(self.l_plan, v))

    @property
    def dtype(self) -> torch.dtype:
        return self.l_plan.dtype

    @property
    def graph_nodes(self) -> int:
        """Device operations of one apply: a level step per level of
        either plan, and three a solve that set up y and the padded b."""
        return LEVEL_NODES * (self.l_plan.n_levels
                              + self.u_plan.n_levels) + 6


def ilu0_preconditioner(coo: COOMatrix, cfg: Config = None, *,
                        device="cuda") -> ILUPreconditioner:
    """M⁻¹ = U⁻¹ L⁻¹ from ILU(0), its plans in ``cfg``'s value type (float64
    by default: pass the solver's cfg)."""
    L, U = ilu0(coo)
    return ILUPreconditioner(
        l_plan=analyze(L, cfg, lower=True, device=device),
        u_plan=analyze(U, cfg, lower=False, device=device))


def ic0_preconditioner(coo: COOMatrix, cfg: Config = None, *,
                       device="cuda") -> ILUPreconditioner:
    """M⁻¹ = L⁻ᵀ L⁻¹ from IC(0), for SPD systems with CG (ops.solvers)."""
    L = ic0(coo)
    Lt = COOMatrix.from_triplets(L.n_row, L.n_col, L.col, L.row, L.val,
                                 sort=True)
    return ILUPreconditioner(
        l_plan=analyze(L, cfg, lower=True, device=device),
        u_plan=analyze(Lt, cfg, lower=False, device=device))
