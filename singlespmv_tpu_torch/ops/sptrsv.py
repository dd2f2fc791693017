"""SpTRSV, the sparse triangular solve of ``singlespmv_tpu/ops/sptrsv.py``.

Level scheduling: rows are grouped on the host into dependency levels
(level[r] = 1 + the deepest level among r's off-diagonal columns, native
C++ in ``core/native/factor_native.cpp``, numpy otherwise), and the solve
runs one step per level.  A step is a rectangular padded gather–FMA over
the level's rows (ELL-style slots) into a y of n + 1 slots, slot n the
ghost that padded rows write; the sequential depth is the DAG's, not n.

The reference runs the step in XLA, so the port runs it in plain torch:
seven device operations a level (``LEVEL_NODES``), none of which waits on
the host, so a solve can be captured in a CUDA graph (``ops/solvers.py``).

Solves L·y = b (lower) and U·y = b (upper); the diagonal must be stored.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import Config
from ..core import native
from ..core.types import COOMatrix

LEVEL_NODES = 7     # device operations of one level step in ``solve``


@dataclasses.dataclass(frozen=True)
class TriSolveplan:
    """The host-built level schedule as device tensors (static shapes)."""
    n_row: int
    n_levels: int
    rows_per_level: int   # padded level width
    k: int                # padded off-diagonal slots per row
    level_rows: torch.Tensor  # (n_levels, rows_per_level) int64, ghost n_row
    col: torch.Tensor     # (n_levels, rows_per_level, k) int64, pad 0
    val: torch.Tensor     # (n_levels, rows_per_level, k) values, pad 0
    diag: torch.Tensor    # (n_levels, rows_per_level) values, pad 1.0
    lower: bool

    @classmethod
    def from_arrays(cls, level_rows, col, val, diag, *, n_row: int,
                    lower: bool, device="cuda") -> "TriSolveplan":
        """The plan of the schedule's arrays (numpy, laid out as
        ``analyze`` and the reference's plan lay them out) on ``device``,
        in ``val``'s value type."""
        from ..harness.driver import device_of

        dev = device_of(device)
        val = np.asarray(val)
        diag = np.asarray(diag)
        if val.dtype != diag.dtype or val.dtype not in (np.float32,
                                                        np.float64):
            raise TypeError(f"plan values {val.dtype} and diagonal "
                            f"{diag.dtype}: one of float32 and float64")

        def tensor(a, dtype):     # a copy: the arrays may be read-only
            return torch.from_numpy(np.array(a, dtype=dtype)).to(dev)

        n_levels, rows_per, k = val.shape
        return cls(n_row=int(n_row), n_levels=n_levels,
                   rows_per_level=rows_per, k=k,
                   level_rows=tensor(level_rows, np.int64),
                   col=tensor(col, np.int64), val=tensor(val, val.dtype),
                   diag=tensor(diag, val.dtype), lower=bool(lower))

    @property
    def dtype(self) -> torch.dtype:
        return self.val.dtype


def _levels_numpy(rp: np.ndarray, cols: np.ndarray, *,
                  lower: bool) -> np.ndarray:
    """Each row's dependency level from the off-diagonal CSR pattern, in
    topological order: the walk of ``core/native``'s ``tri_levels``."""
    n = len(rp) - 1
    level = np.zeros(n, dtype=np.int64)
    for r in (range(n) if lower else range(n - 1, -1, -1)):
        deps = cols[rp[r]: rp[r + 1]]
        if deps.size:
            level[r] = level[deps].max() + 1
    return level


def analyze(coo: COOMatrix, cfg: Config = None, *, lower: bool = True,
            device="cuda") -> TriSolveplan:
    """The level schedule of a triangular ``coo`` on ``device``, in
    ``cfg``'s value type (float64 by default)."""
    cfg = cfg or Config(dtype="float64")
    n = coo.n_row
    if coo.n_row != coo.n_col:
        raise ValueError("triangular solve needs a square matrix")

    off = (coo.col < coo.row) if lower else (coo.col > coo.row)
    dmask = coo.col == coo.row
    diag = np.ones(n, dtype=np.float64)
    diag[coo.row[dmask]] = coo.val[dmask]
    has_diag = np.zeros(n, dtype=bool)
    has_diag[coo.row[dmask]] = True
    if not has_diag.all():
        missing = int(n - has_diag.sum())
        raise ValueError(
            f"triangular matrix has {missing} row(s) with no stored diagonal "
            "entry — store an explicit diagonal (unit-diagonal factors must "
            "store their 1.0s, as ops.ilu does)")
    if np.any(diag == 0):
        raise ValueError("singular triangular matrix (zero diagonal)")

    orow, ocol, oval = coo.row[off], coo.col[off], coo.val[off]
    rp = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(orow, minlength=n), out=rp[1:])
    level = native.tri_levels(rp, ocol.astype(np.int64), lower=lower)
    if level is None:
        level = _levels_numpy(rp, ocol.astype(np.int64), lower=lower)
    n_levels = int(level.max(initial=0)) + 1

    counts = np.bincount(level, minlength=n_levels)
    rows_per = max(1, int(counts.max(initial=1)))
    k = max(1, int(np.bincount(orow, minlength=n).max(initial=1)))

    # rows grouped by level (stable: ascending row within a level), pos_of
    # the index within the level
    order = np.argsort(level, kind="stable")
    starts = np.zeros(n_levels, dtype=np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    pos_of = np.empty(n, dtype=np.int64)
    pos_of[order] = np.arange(n) - starts[level[order]]
    level_rows = np.full((n_levels, rows_per), n, dtype=np.int64)
    level_rows[level, pos_of] = np.arange(n)

    col = np.zeros((n_levels, rows_per, k), dtype=np.int64)
    val = np.zeros((n_levels, rows_per, k), dtype=np.float64)
    within = np.arange(len(orow)) - rp[orow]
    col[level[orow], pos_of[orow], within] = ocol
    val[level[orow], pos_of[orow], within] = oval

    dlev = np.ones((n_levels, rows_per), dtype=np.float64)
    dlev[level, pos_of] = diag

    dt = cfg.np_dtype
    return TriSolveplan.from_arrays(level_rows, col, val.astype(dt),
                                    dlev.astype(dt), n_row=n, lower=lower,
                                    device=device)


def solve(plan: TriSolveplan, b: torch.Tensor) -> torch.Tensor:
    """Substitution: one gather–FMA step per level.  ``b`` lies on the
    plan's device in its value type; another type raises, since torch would
    promote the result to the wider one."""
    if b.dtype != plan.dtype:
        raise TypeError(f"sptrsv: b is {b.dtype}, the plan {plan.dtype}; "
                        "build the plan in the solver's value type")
    n = plan.n_row
    y = b.new_zeros(n + 1)                   # slot n: the ghost
    bx = torch.cat([b, b.new_zeros(1)])
    for lv in range(plan.n_levels):
        rows = plan.level_rows[lv]
        acc = (plan.val[lv] * y[plan.col[lv]]).sum(dim=-1)
        # a ghost row's b is 0, its slots 0 and its diagonal 1: it writes a
        # 0 into slot n, which no row reads
        y.index_copy_(0, rows, (bx[rows] - acc) / plan.diag[lv])
    return y[:n]


def sptrsv(coo: COOMatrix, b: torch.Tensor, cfg: Config = None, *,
           lower: bool = True, device="cuda") -> torch.Tensor:
    """One-shot analyze + solve (cache the plan for repeated solves)."""
    return solve(analyze(coo, cfg, lower=lower, device=device), b)
