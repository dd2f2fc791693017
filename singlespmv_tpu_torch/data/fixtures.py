"""Hand-checkable test fixtures: a copy of
``singlespmv_tpu/data/fixtures.py``.

Semantic equivalents of singleSpMV's matrix/test/*.mtx (regenerated, not
copied):
- fixture_3x3: 3×3 diagonal (values 1,2,3) — bannerless in the reference, which our
  reader must accept (matrix/test/3x3.mtx has no %%MatrixMarket banner).
- fixture_5x5: small mixed-pattern 5×5.
- fixture_10x10: 10×10 with varied row lengths AND empty rows 7..9 (0-based) — the
  empty-row regression case (CSR5's dirty-bit machinery exists for this;
  matrix/test/10x10.mtx rows 8,9,10 are empty).
- fixture_random: 10×10 with ~95 of 100 positions filled (matrix/test/random.mtx).
"""
from __future__ import annotations

import numpy as np

from ..core.types import COOMatrix
from .generators import generate


def fixture_3x3() -> COOMatrix:
    i = np.arange(3)
    return COOMatrix.from_triplets(3, 3, i, i, (i + 1).astype(np.float64))


def fixture_5x5() -> COOMatrix:
    rows = [0, 0, 1, 2, 2, 3, 4, 4]
    cols = [0, 4, 1, 0, 2, 3, 1, 4]
    vals = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0]
    return COOMatrix.from_triplets(5, 5, np.array(rows), np.array(cols), np.array(vals))


def fixture_10x10() -> COOMatrix:
    # Row lengths 6,2,6,2,1,2,8,0,0,0 — mixed lengths + a long row + empty tail rows,
    # mirroring the pathology coverage of matrix/test/10x10.mtx.
    rows, cols, vals = [], [], []
    spec = {0: [0, 1, 2, 3, 4, 5], 1: [0, 1], 2: [0, 1, 2, 3, 4, 5], 3: [0, 1],
            4: [0], 5: [0, 1], 6: [0, 1, 2, 3, 4, 5, 7, 9]}
    for r, cl in spec.items():
        for c in cl:
            rows.append(r); cols.append(c); vals.append(float(r + 1))
    return COOMatrix.from_triplets(
        10, 10, np.array(rows), np.array(cols), np.array(vals)
    )


def fixture_random() -> COOMatrix:
    return generate("random", 10, 95, seed=7)


def fixture_empty() -> COOMatrix:
    """Fully empty matrix — degenerate edge case."""
    z = np.zeros(0)
    return COOMatrix.from_triplets(4, 4, z, z, z)


def fixture_single() -> COOMatrix:
    """One nonzero."""
    return COOMatrix.from_triplets(
        4, 6, np.array([2]), np.array([5]), np.array([3.5])
    )


def fixture_rect_wide() -> COOMatrix:
    return generate("random", 16, 60, seed=11).__class__.from_triplets(
        8, 32,
        np.array([0, 0, 3, 5, 7, 7, 7]), np.array([0, 31, 16, 2, 7, 8, 30]),
        np.array([1.0, -2.0, 0.5, 4.0, 1.5, 2.5, -1.0]),
    )


ALL_FIXTURES = {
    "3x3": fixture_3x3,
    "5x5": fixture_5x5,
    "10x10": fixture_10x10,
    "random": fixture_random,
    "empty": fixture_empty,
    "single": fixture_single,
    "rect_wide": fixture_rect_wide,
}


def write_all(directory):
    """Materialize fixtures as .mtx files (analog of matrix/test/*.mtx)."""
    import os

    from ..core.mmio import write_matrix_market

    os.makedirs(directory, exist_ok=True)
    for name, fn in ALL_FIXTURES.items():
        write_matrix_market(os.path.join(directory, f"{name}.mtx"), fn())
