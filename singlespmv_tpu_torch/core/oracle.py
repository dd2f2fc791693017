"""Verification oracle: a copy of ``singlespmv_tpu/core/oracle.py``.

Scalar COO SpMV in float64 on the host + the reference's abs-OR-rel ≤ tol check
(singleSpMV's src/util.cpp:67-83: ``VerifyResult`` recomputes y from the COO
triplets and passes an element iff ``|y-ref| <= tol`` or ``|y-ref|/|ref| <= tol``).

The reference computes in f64 with tol=1e-6.  On TPU the value pipeline is f32 (f64 is
emulated and not a sane production dtype there), so the tolerance is scaled by dtype:
f64 keeps 1e-6; f32 uses a row-length-aware bound (summing k products of f32 inputs
accumulates ~k·eps relative error in the worst case).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .types import COOMatrix

DEFAULT_TOL = 1e-6


def reference_spmv(coo: COOMatrix, x: np.ndarray) -> np.ndarray:
    """Float64 COO oracle: y[r] += val[i] * x[col[i]]."""
    y = np.zeros(coo.n_row, dtype=np.float64)
    np.add.at(y, coo.row, coo.val * np.asarray(x, dtype=np.float64)[coo.col])
    return y


def tolerance_for(coo: COOMatrix, dtype) -> float:
    name = getattr(dtype, "name", None) or str(dtype)
    if "float64" in name:
        return DEFAULT_TOL
    # Reduced precision: worst-case accumulation error grows with the longest
    # row; bf16 has an 8-bit mantissa (eps = 2^-8).  Floor at the 128-lane
    # vector width: the production kernels (slab, bkt stage B) reduce runs by
    # prefix-sum differencing over a full 128-slot stream row, so their
    # rounding scales with the stream row's content, not just the row's run.
    max_row = int(coo.row_lengths().max(initial=1))
    eps = 2.0 ** -8 if "bfloat16" in name else float(np.finfo(np.float32).eps)
    return max(DEFAULT_TOL, 16.0 * eps * np.sqrt(max(max_row, 128.0)))


_EPS = {"float32": 2.0 ** -23, "float64": 2.0 ** -52, "bfloat16": 2.0 ** -7}
_MANT = {"float32": 23, "float64": 52, "bfloat16": 7}


def _type_name(dtype) -> str:
    name = str(getattr(dtype, "name", None) or dtype).replace("torch.", "")
    if name not in _EPS:
        raise ValueError(f"no rounding model for value type {name}")
    return name


def ulp(dtype, v) -> np.ndarray:
    """The spacing of value type ``dtype`` at magnitude ``|v|`` (elementwise;
    at 0 and below the normal range, the spacing of the smallest normal)."""
    name = _type_name(dtype)
    tiny = float(np.finfo(np.float64 if name == "float64"
                          else np.float32).tiny)
    a = np.maximum(np.abs(np.asarray(v, np.float64)), tiny)
    return np.exp2(np.floor(np.log2(a)) - _MANT[name])


def reorder_bound(coo: COOMatrix, x: np.ndarray, adds, acc_dtype,
                  out_dtype) -> np.ndarray:
    """Per row i, how far two runs of one spmv may put y_i apart when they
    add the same k_i partial totals into y_i in different orders:

        (k_i − 1) · eps(acc) · Σ_j |a_ij x_j|  +  ulp(out, |y_i|)

    ``adds`` holds k_i per row: the totals whose order of addition is not
    fixed (the run ends that the card's atomics add into y_i; nnz_i for a
    state without that count), and one more for a part added in a fixed
    order after such a sum (a peel: y = fl(s + d) moves with s, and its
    one rounding adds up to eps·|y|).  A sum of k terms in any order is
    within (k − 1)·u·Σ|t| of the exact sum (u = eps/2), so two orders are
    within (k − 1)·eps·Σ|t|, and the totals t are partial sums of the row's
    products.  A row with k_i ≤ 1 gets 0 in its accumulator: a warp's
    in-row scan has a fixed order.  The last term is one unit in the last
    place of the output type, at |y_i| widened by the first term and the
    oracle's backward term (where the computed values lie), for a y
    accumulated in ``acc_dtype`` and rounded to ``out_dtype`` (two values
    that far apart may round to neighbours); it is 0 where the two types
    are the same.  ``coo`` and ``x`` should hold the values the kernel read
    (a bfloat16 state's ``to_coo``, x rounded)."""
    acc_name, out_name = _type_name(acc_dtype), _type_name(out_dtype)
    x64 = np.asarray(x, dtype=np.float64)
    absref = np.zeros(coo.n_row, dtype=np.float64)
    np.add.at(absref, coo.row, np.abs(coo.val * x64[coo.col]))
    k = np.maximum(np.asarray(adds, dtype=np.float64) - 1.0, 0.0)
    bound = k * _EPS[acc_name] * absref
    if out_name != acc_name:
        # the computed values lie within the oracle's backward term of y
        top = np.abs(reference_spmv(coo, x64)) + bound \
            + 64.0 * _EPS[acc_name] * absref
        bound = bound + ulp(out_name, top)
    return bound


def verify_result(
    coo: COOMatrix,
    x: np.ndarray,
    y: np.ndarray,
    *,
    tol: Optional[float] = None,
    dtype=np.float32,
) -> Tuple[bool, dict]:
    """abs-or-rel check of y against the f64 oracle. Returns (ok, details)."""
    ref = reference_spmv(coo, x)
    y = np.asarray(y, dtype=np.float64)
    if tol is None:
        tol = tolerance_for(coo, dtype)
    abs_err = np.abs(y - ref)
    denom = np.abs(ref)
    rel_err = np.where(denom > 0, abs_err / np.maximum(denom, 1e-300), abs_err)
    # Third disjunct: the componentwise backward bound |ŷ−y| ≤ c·eps·(|A||x|)
    # — rows with heavy cancellation (Σ|aᵢxᵢ| ≫ |y|) cannot beat this in ANY
    # reduced-precision summation order; the abs/rel tol alone would reject
    # every correct f32 kernel on such rows.
    name = getattr(dtype, "name", None) or str(dtype)
    eps = (2.0 ** -8 if "bfloat16" in name
           else float(np.finfo(np.float32).eps)) \
        if "float64" not in name else float(np.finfo(np.float64).eps)
    absref = np.zeros(coo.n_row, dtype=np.float64)
    np.add.at(absref, coo.row,
              np.abs(coo.val * np.asarray(x, dtype=np.float64)[coo.col]))
    bwd = 64.0 * eps * absref
    ok_elem = (abs_err <= tol) | (rel_err <= tol) | (abs_err <= bwd)
    ok = bool(ok_elem.all())
    worst = int(np.argmax(np.where(ok_elem, -1.0, np.minimum(abs_err, rel_err))))
    details = {
        "tol": tol,
        "max_abs_err": float(abs_err.max(initial=0.0)),
        "max_rel_err": float(rel_err.max(initial=0.0)),
        "n_bad": int((~ok_elem).sum()),
        "worst_index": worst,
        "worst_got": float(y[worst]) if y.size else 0.0,
        "worst_want": float(ref[worst]) if ref.size else 0.0,
    }
    return ok, details
