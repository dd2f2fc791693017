"""The multichip dryrun of the reference's ``__graft_entry__.py:36-98``: one
step of every distributed operator on small matrices, checked against the
float64 oracle.

    python -m singlespmv_tpu_torch.parallel.dryrun [n_devices] [--device cpu]

runs it on a local mesh (8 shards by default, on the card unless
``--device cpu``).  Under ``backend="dist"`` the caller has initialised a
``torch.distributed`` group of ``n_devices`` ranks, and every rank calls
``dryrun_multichip``.
"""
from __future__ import annotations

import argparse

import numpy as np

from ..config import Config
from ..core.oracle import reference_spmv
from ..core.rng import create_random_vector
from ..data.generators import powerlaw
from .halo import HaloSpMV
from .mesh import make_mesh
from .spmv import DistSpMV
from .xchd import DistXch


def grid_of(n_devices: int):
    """n_devices as a row × col grid, rows preferred: the first of 2, 3
    that divides it (leaving more than one row) is the col count."""
    for cand in (2, 3):
        if n_devices % cand == 0 and n_devices // cand > 1:
            return n_devices // cand, cand
    return n_devices, 1


def _close(y, ref, what):
    y = y.cpu().numpy()
    assert np.allclose(y, ref, rtol=1e-4, atol=1e-4), (
        f"{what} dryrun mismatch: max err {np.abs(y - ref).max()}")


def dryrun_multichip(n_devices: int, device=None,
                     backend: str = "local") -> None:
    """DistSpMV on the row × col grid (and the x all-gather path on a 1-D
    mesh where the grid has one col), HaloSpMV, and DistXch on
    ``powerlaw(20000, 240000, seed=4)``, each one step against the
    oracle; raises AssertionError on a mismatch."""
    r, c = grid_of(n_devices)
    mesh = make_mesh((("row", r), ("col", c)), device=device, backend=backend)

    cfg = Config(format="ss", dtype="float32", segment_width=128)
    coo = powerlaw(96, 700, seed=11)
    x = create_random_vector(coo.n_col)
    ref = reference_spmv(coo, x)
    _close(DistSpMV.convert(coo, cfg, mesh)(x), ref, "distspmv")

    if c == 1 and r > 1:
        # the x all-gather path on a 1-D mesh
        mesh1 = make_mesh((("row", r),), device=device, backend=backend)
        op2 = DistSpMV.convert(coo, cfg, mesh1, col_axis=None, gather_x=True)
        _close(op2(x), ref, "gather_x")

    if n_devices > 1:
        mesh_h = make_mesh((("row", n_devices),), device=device,
                           backend=backend)
        _close(HaloSpMV.convert(coo, cfg, mesh_h)(x), ref, "halo")

    # the flagship distributed path: xch shard by shard
    mesh_x = make_mesh((("row", n_devices),), device=device, backend=backend)
    coo_x = powerlaw(20000, 240000, seed=4)
    x_x = create_random_vector(coo_x.n_col)
    op4 = DistXch.convert(coo_x, Config(format="xch", dtype="float32"),
                          mesh_x)
    y4 = op4(x_x).cpu().numpy()
    ref4 = reference_spmv(coo_x, x_x)
    bad = np.abs(y4 - ref4).max() / max(np.abs(ref4).max(), 1e-9)
    assert bad < 1e-4, f"distxch dryrun mismatch: rel err {bad}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", type=int, nargs="?", default=8)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_devices, device=args.device)
    print("dryrun_multichip: OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
