"""Weak- and strong-scaling harness of the distributed SpMV: the
reference's ``singlespmv_tpu/parallel/bench.py``.

nnz/s at mesh sizes 1, 2, 4, ... (``mesh_sizes``):

- **weak scaling**: the matrix grows with the mesh (``make_matrix(n)``);
  efficiency = rate(n) / (n · rate(1));
- **strong scaling**: one matrix; efficiency = rate(n) / (n · rate(1)).

The meshes are local (``parallel/mesh.py``): every shard runs on the one
device, so the table measures what sharding costs there, not scaling
across devices.  A time is the best of ``trials`` loops of ``loop`` calls,
a call's share of the loop (the reference's rule): on a card a CUDA graph
of the loop between CUDA events, on the CPU a host clock (``_time_op``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

from ..config import Config
from ..core.rng import create_random_vector
from ..core.types import COOMatrix
from ..harness.driver import make_chained_runner, runner_clock
from .halo import HaloSpMV
from .mesh import LOCAL_SHARDS, make_mesh
from .spmv import DistSpMV


@dataclasses.dataclass
class ScalePoint:
    n_devices: int
    nnz: int
    seconds: float
    nnz_per_s: float
    efficiency: float


def _time_op(op, x, *, loop: int = 8, trials: int = 3) -> float:
    """Seconds a call of ``op(x)``: the best of ``trials`` runs of ``loop``
    chained calls, a call's share of the run.  On a card the ``loop`` calls
    are one CUDA graph (``harness/driver.py:make_chained_runner``, captured
    after its warm-up calls) and a run is one replay between CUDA events,
    so the time is the device's and not the host's launching; on the CPU a
    run is a host loop on a host clock, after one warm-up call."""
    x = torch.from_numpy(np.ascontiguousarray(x)).to(op.mesh.device)
    timed = runner_clock(make_chained_runner(
        lambda o, a: o.step(a), op, x, name=type(op).__name__, chain=loop),
        x.device)
    timed(1)
    return min(timed(loop) for _ in range(trials)) / loop


def mesh_sizes(limit: Optional[int] = None) -> List[int]:
    n = LOCAL_SHARDS if limit is None else min(limit, LOCAL_SHARDS)
    sizes, s = [], 1
    while s <= n:
        sizes.append(s)
        s *= 2
    return sizes


def _convert(coo, cfg, mesh, *, halo: bool):
    if halo:
        return HaloSpMV.convert(coo, cfg, mesh)
    return DistSpMV.convert(coo, cfg, mesh, col_axis=None)


def _points(matrices, cfg, loop, halo, device) -> List[ScalePoint]:
    points: List[ScalePoint] = []
    base_rate = None
    for n, coo in matrices:
        mesh = make_mesh((("row", n),), device=device)
        op = _convert(coo, cfg, mesh, halo=halo)
        x = create_random_vector(coo.n_col).astype(cfg.np_dtype)
        sec = _time_op(op, x, loop=loop)
        rate = coo.nnz / sec
        if base_rate is None:
            base_rate = rate
        points.append(ScalePoint(n, coo.nnz, sec, rate,
                                 rate / (n * base_rate)))
    return points


def weak_scaling(make_matrix: Callable[[int], COOMatrix],
                 cfg: Optional[Config] = None, *, loop: int = 8,
                 limit: Optional[int] = None, halo: bool = False,
                 device=None) -> List[ScalePoint]:
    """make_matrix(n_devices) -> a COOMatrix sized ∝ n_devices.

    ``halo=True`` uses the halo-exchange operator (``HaloSpMV``) instead
    of the all-gather ``DistSpMV``; ``device`` goes to ``make_mesh``."""
    cfg = cfg or Config(format="ss", dtype="float32", segment_width=512)
    return _points(((n, make_matrix(n)) for n in mesh_sizes(limit)), cfg,
                   loop, halo, device)


def strong_scaling(coo: COOMatrix, cfg: Optional[Config] = None, *,
                   loop: int = 8, limit: Optional[int] = None,
                   halo: bool = False, device=None) -> List[ScalePoint]:
    cfg = cfg or Config(format="ss", dtype="float32", segment_width=512)
    return _points(((n, coo) for n in mesh_sizes(limit)), cfg, loop, halo,
                   device)


def report(points: List[ScalePoint]) -> str:
    lines = [f"{'devices':>8} {'nnz':>12} {'time(s)':>10} {'Gnnz/s':>8} "
             f"{'eff%':>6}"]
    for p in points:
        lines.append(f"{p.n_devices:>8} {p.nnz:>12} {p.seconds:>10.6f} "
                     f"{p.nnz_per_s/1e9:>8.3f} {100*p.efficiency:>6.1f}")
    return "\n".join(lines)
