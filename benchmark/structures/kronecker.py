"""Graph500's Kronecker graph as a sparse matrix: the specification's
generator (``kronecker_generator.m``) at ``scale`` and ``edgefactor``, with
its initiator (A, B, C; D = 1 − A − B − C), made undirected with
self-loops and duplicate edges removed, and stored as the symmetric
adjacency matrix: each edge (i, j) at both (i, j) and (j, i).

The edges come from the configuration's ``structure_seed``, so every run
of a configuration holds one graph; each edge's weight comes from the
run's seed, uniform in [0, 1) as the specification draws them, the same
at (i, j) and (j, i), rounded to the configuration's value type.  The
graph is drawn with torch on the run's device, in a few large calls."""
from __future__ import annotations

import torch

from benchmark.reference import Matrix, value_type

_CACHE = {}


def pairs(scale: int, m: int, initiator, gen, device) -> tuple:
    """(i, j) int64: ``m`` draws of the specification's generator before
    its vertex permutation.  Each of the ``scale`` bits of i is 1 with
    probability C + D, and of j, given i's bit, with C / (C + D) or
    B / (A + B)."""
    a, b, c = initiator
    ab, c_norm, a_norm = a + b, c / (1.0 - (a + b)), a / (a + b)
    i = torch.zeros(m, dtype=torch.int64, device=device)
    j = torch.zeros_like(i)
    for bit in range(scale):
        ii = torch.rand(m, generator=gen, device=device) > ab
        jj = torch.rand(m, generator=gen, device=device) > torch.where(
            ii, c_norm, a_norm)
        i |= ii.long() << bit
        j |= jj.long() << bit
    return i, j


def edges(cfg: dict, device) -> tuple:
    """(lo, hi) int64 on ``device``: the undirected edges, lo < hi, each
    once, sorted by lo·n + hi."""
    key = (cfg["name"], cfg["scale"], cfg["edgefactor"],
           tuple(cfg["initiator"]), cfg["structure_seed"], str(device))
    if key not in _CACHE:
        scale, n = int(cfg["scale"]), 1 << int(cfg["scale"])
        gen = torch.Generator(device=device)
        gen.manual_seed(int(cfg["structure_seed"]))
        i, j = pairs(scale, int(cfg["edgefactor"]) * n, cfg["initiator"],
                     gen, device)
        perm = torch.randperm(n, generator=gen, device=device)
        i, j = perm[i], perm[j]
        keep = i != j
        i, j = i[keep], j[keep]
        uniq = torch.unique(torch.minimum(i, j) * n + torch.maximum(i, j))
        _CACHE.clear()
        _CACHE[key] = (uniq // n, uniq % n)
    return _CACHE[key]


def build(cfg: dict, seed: int, device) -> Matrix:
    n = 1 << int(cfg["scale"])
    lo, hi = edges(cfg, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    w = torch.rand(lo.numel(), generator=gen, device=device,
                   dtype=value_type(cfg["dtype"]))
    row = torch.cat([lo, hi])
    col = torch.cat([hi, lo])
    order = torch.argsort(row * n + col)
    val = torch.cat([w, w])[order]
    return Matrix(n, n, row[order].cpu().numpy(), col[order].cpu().numpy(),
                  val.double().cpu().numpy())
