"""The system under test, singlespmv_tpu_torch, as the benchmark drives it:
the only module of the benchmark that imports the program.  It hands the
program the benchmark's triplets and takes back its state, its products
and its solver; a test swaps in a subclass with a fault underneath."""
from __future__ import annotations

import os

import numpy as np
import torch

from benchmark.reference import Matrix

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "singlespmv_tpu_torch", "csrc")


class Port:
    """singlespmv_tpu_torch through its public entry points."""

    def __init__(self):
        from singlespmv_tpu_torch import formats
        from singlespmv_tpu_torch.config import Config
        from singlespmv_tpu_torch.core.types import COOMatrix
        from singlespmv_tpu_torch.formats import auto
        from singlespmv_tpu_torch.ops import solvers

        self.formats, self.Config, self.COOMatrix = formats, Config, COOMatrix
        self.auto, self.solvers = auto, solvers

    def convert(self, m: Matrix, *, fmt: str, dtype: str, spmm_b: int,
                device: torch.device):
        """(cfg, state on ``device``): the format's convert, auto's with
        the device for its trials, as the port's driver calls it."""
        cfg = self.Config(format=fmt, dtype=dtype, spmm_b=spmm_b,
                          verify=False)
        coo = self.COOMatrix(m.n_row, m.n_col, m.row.astype(np.int32),
                             m.col.astype(np.int32), m.val)
        if fmt == "auto":
            state = self.auto.convert(coo, cfg, device=device)
        else:
            state = self.formats.convert(coo, cfg)
        return cfg, state.to(device)

    def engine(self, cfg, state) -> str:
        return state.chosen if cfg.format == "auto" else cfg.format

    def product(self, cfg, columns: int):
        """y = A x (``spmv_fn``) for one column, Y = A X (``spmm_fn``) for
        more."""
        return (self.formats.spmv_fn(cfg) if columns == 1
                else self.formats.spmm_fn(cfg))

    def cg_loop(self, cfg, state, b, *, tol: float, maxiter: int):
        """A CG solve of A x = b from x = 0, set up: ``cg_loop``."""
        return self.solvers.cg_loop(self.formats.spmv_fn(cfg), state, b,
                                    tol=tol, maxiter=maxiter)

    def solve(self, cfg, state, loop):
        """(x, iterations, info) of the solve run to its end: its chunks
        captured as a CUDA graph and replayed (``MaskedLoop.run``)."""
        info = loop.run(f"{cfg.format}/{self.engine(cfg, state)}")
        return loop.carry["x"], loop.carry["it"], info
