"""HPCG's operator: the 27-point stencil on an nx × ny × nz grid, row
(and column) index ix + nx·(iy + ny·iz), each row's neighbours in the
order of HPCG's ``GenerateProblem`` loops (sz, sy, sx from −1 to 1), so the
triplets come out row-major and sorted.  The diagonal holds ``diag`` and
every other neighbour ``off`` (HPCG: 26 and −1).  Built with torch on the
run's device, then brought to the host, where the program converts."""
from __future__ import annotations

import torch

from benchmark.reference import Matrix


def build(cfg: dict, seed: int, device) -> Matrix:
    nx, ny, nz = cfg["grid"]
    n = nx * ny * nz
    idx = torch.arange(n, device=device)
    ix, iy, iz = idx % nx, (idx // nx) % ny, idx // (nx * ny)
    cols, keep, vals = [], [], []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                cols.append(idx + (dz * ny + dy) * nx + dx)
                keep.append((ix + dx >= 0) & (ix + dx < nx)
                            & (iy + dy >= 0) & (iy + dy < ny)
                            & (iz + dz >= 0) & (iz + dz < nz))
                vals.append(cfg["diag"] if (dx, dy, dz) == (0, 0, 0)
                            else cfg["off"])
    keep = torch.stack(keep, 1).reshape(-1)
    col = torch.stack(cols, 1).reshape(-1)[keep]
    row = idx.repeat_interleave(27)[keep]
    val = torch.tensor(vals, dtype=torch.float64, device=device).repeat(n)
    return Matrix(n, n, row.cpu().numpy(), col.cpu().numpy(),
                  val[keep].cpu().numpy())
