"""Matrix inspection tools: a copy of ``singlespmv_tpu/data/tools.py``.

Analogs of singleSpMV's matrix/script/visualizer.cpp (32×32 downsampled ASCII spy
plot) and counter.cpp (row/col nnz stats — see core.types.matrix_stats).
"""
from __future__ import annotations

import numpy as np

from ..core.types import COOMatrix


def spy_plot(coo: COOMatrix, size: int = 32) -> str:
    """ASCII density plot, downsampled to size×size cells.

    The reference prints '#' for occupied cells (visualizer.cpp); we grade density
    into ' .:*#' quintiles so structure is visible on large matrices too.
    """
    size_r = min(size, max(coo.n_row, 1))
    size_c = min(size, max(coo.n_col, 1))
    grid = np.zeros((size_r, size_c), dtype=np.int64)
    if coo.nnz:
        r = (coo.row.astype(np.int64) * size_r) // max(coo.n_row, 1)
        c = (coo.col.astype(np.int64) * size_c) // max(coo.n_col, 1)
        np.add.at(grid, (np.minimum(r, size_r - 1), np.minimum(c, size_c - 1)), 1)
    cell_cap = max(
        1.0,
        (coo.n_row / size_r) * (coo.n_col / size_c),
    )
    shades = " .:*#"
    lines = [f"% {coo.n_row} x {coo.n_col}, nnz={coo.nnz}"]
    for i in range(size_r):
        row = ""
        for j in range(size_c):
            d = grid[i, j] / cell_cap
            level = 0 if grid[i, j] == 0 else min(4, 1 + int(d * 4))
            row += shades[level]
        lines.append(row)
    return "\n".join(lines)


def structure_metrics(coo: COOMatrix) -> dict:
    """Structural profile used by the stand-in fidelity checks.

    With zero egress (results/r3_standin_fidelity.md documents the DNS-denied
    download attempts), real-vs-synth GFLOPS deltas cannot be measured — the
    honest substitute is validating that each stand-in exhibits the published
    structural *class* of its matrix (problem kind + spy-plot shape), which
    these metrics quantify:

    - diag_cover:    fraction of rows with a main-diagonal entry
    - local_frac:    fraction of nnz with |r - c| <= 0.01 * n (band locality)
    - med_reldist:   median |r - c| / n (0 for banded, ~0.33 for uniform)
    - top1pct_col:   nnz share of the top-1% highest-degree columns
                     (~0.01 x avg-degree share for uniform; >>0.1 for
                     power-law/hub structure)
    - run2_frac:     fraction of nnz in row-runs of >= 2 consecutive columns
                     (dense-block / FEM classes cluster, scatter doesn't)
    - row_cv:        coefficient of variation of row degrees (counter.cpp's
                     variance analog, singleSpMV's matrix/script/counter.cpp:28-44)
    """
    n = max(coo.n_row, 1)
    r = coo.row.astype(np.int64)
    c = coo.col.astype(np.int64)
    out = {"n_row": coo.n_row, "n_col": coo.n_col, "nnz": coo.nnz}
    if coo.nnz == 0:
        return out
    d = np.abs(r - c)
    out["diag_cover"] = float(len(np.unique(r[d == 0])) / n)
    out["local_frac"] = float((d <= max(1, int(0.01 * n))).mean())
    out["med_reldist"] = float(np.median(d) / n)
    cdeg = np.bincount(c, minlength=coo.n_col)
    k = max(1, coo.n_col // 100)
    out["top1pct_col"] = float(
        np.sort(cdeg)[::-1][:k].sum() / coo.nnz)
    # row-runs: consecutive (r, c) pairs with same row and col+1 (row-major
    # sorted input; COOMatrix sorts at construction)
    same = (r[1:] == r[:-1]) & (c[1:] == c[:-1] + 1)
    in_run = np.zeros(coo.nnz, dtype=bool)
    in_run[1:] |= same
    in_run[:-1] |= same
    out["run2_frac"] = float(in_run.mean())
    rdeg = np.bincount(r, minlength=coo.n_row).astype(np.float64)
    out["row_cv"] = float(rdeg.std() / max(rdeg.mean(), 1e-12))
    return out
