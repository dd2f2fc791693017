"""The plain reference the benchmark judges the program by: y = A x, Y = A X
and conjugate gradients, in float64 with plain torch operations on the
triplets the benchmark made.  It imports nothing of the program and takes
nothing the program made.

Each product is a scatter-add of val·x[col] into y at row, in blocks of
``BLOCK`` nonzeros so the temporaries stay small; the order of its adds is
free (atomics), which float64 makes immaterial beside the value types the
program runs.  ``lowered`` gives the same reference computed in a lower
value type: the control that a comparison has to fail."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

BLOCK = 1 << 23
TYPES = {"float64": torch.float64, "float32": torch.float32,
         "bfloat16": torch.bfloat16}


def value_type(name: str) -> torch.dtype:
    return TYPES[name]


@dataclasses.dataclass(frozen=True)
class Matrix:
    """Triplets on the host, row-major and sorted: int64 positions,
    float64 values exactly representable in the configuration's type."""
    n_row: int
    n_col: int
    row: np.ndarray
    col: np.ndarray
    val: np.ndarray

    @property
    def nnz(self) -> int:
        return int(self.row.size)


class Operator:
    """A on ``device`` in ``dtype`` (float64 by default), for products."""

    def __init__(self, m: Matrix, device, dtype=torch.float64):
        self.n_row, self.n_col, self.dtype = m.n_row, m.n_col, dtype
        self.row = torch.from_numpy(m.row).to(device)
        self.col = torch.from_numpy(m.col).to(device)
        self.val = torch.from_numpy(m.val).to(device=device, dtype=dtype)

    def _acc(self, x, f):
        y = torch.zeros((self.n_row,) + tuple(x.shape[1:]),
                        dtype=torch.float64 if self.dtype == torch.float64
                        else torch.float32, device=x.device)
        for a in range(0, self.val.numel(), BLOCK):
            r, c, v = (t[a:a + BLOCK] for t in (self.row, self.col,
                                               self.val))
            v = v.view((-1,) + (1,) * (x.dim() - 1))
            y.index_add_(0, r, f(v, x[c]).to(y.dtype))
        return y

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """A x for x (n_col,) or (n_col, B): products in the operator's
        type, sums in float64 (float32 below float64)."""
        x = x.to(self.dtype)
        return self._acc(x, lambda v, xc: v * xc).to(self.dtype)

    def abs_sums(self, x: torch.Tensor) -> torch.Tensor:
        """Σ_j |a_ij x_j| in float64: the scale of each row's rounding."""
        return self._acc(x.double(), lambda v, xc: (v.double() * xc).abs())


def row_error(y: torch.Tensor, ref: torch.Tensor,
              scale: torch.Tensor) -> float:
    """max_i |y_i − ref_i| / s_i, s_i = Σ_j |a_ij x_j| (``scale``): each
    answer's error in units of its own row's magnitudes.  A row with s_i
    = 0 has to be exact (0 where it is, infinite where it is not)."""
    d = (y.double() - ref.double()).abs()
    err = torch.where(scale > 0, d / scale.clamp_min(1e-300),
                      torch.where(d > 0, torch.inf, 0.0))
    return float(err.max())


def step(y: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The next input of a chain of products: y scaled to a largest entry
    of 1 (column by column) plus the next drive ``u``, so that every
    product's answer enters the next one's input and no entry decays."""
    return y / y.abs().amax(dim=0) + u


def chain(op: Operator, x0: torch.Tensor, drives: list,
          length: int) -> torch.Tensor:
    """The last of ``length`` chained products y_k = A x_k from x_0 =
    ``x0``, x_{k+1} = ``step``(y_k, drives[(k + 1) % len(drives)]), in
    the operator's type."""
    x = x0.to(op.dtype)
    for k in range(length):
        y = op.matvec(x)
        if k + 1 < length:
            x = step(y, drives[(k + 1) % len(drives)].to(op.dtype))
    return y


def cg(op: Operator, b: torch.Tensor, maxiter: int) -> torch.Tensor:
    """``maxiter`` iterations of plain conjugate gradients from x = 0, in
    the operator's type."""
    b = b.to(op.dtype)
    x = torch.zeros_like(b)
    r = b.clone()
    p = r.clone()
    rz = torch.dot(r, r)
    for _ in range(maxiter):
        ap = op.matvec(p)
        alpha = rz / torch.dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        rz_new = torch.dot(r, r)
        p = r + (rz_new / rz) * p
        rz = rz_new
    return x


def vector_error(x: torch.Tensor, ref: torch.Tensor) -> float:
    """max_i |x_i − ref_i| / max_i |ref_i|, column by column, the worst
    column."""
    d = (x.double() - ref.double()).abs().amax(dim=0)
    return float((d / ref.double().abs().amax(dim=0).clamp_min(1e-300))
                 .max())
