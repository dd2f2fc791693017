"""Rank processes of the port's ``dist`` mesh backend, for
``tests/test_torch_parallel.py`` (gloo on the CPU) and
``tests/test_torch_cuda_parallel.py`` (NCCL on a card).  Imports only the
port.

    python tests/torch_dist_workers.py RANK WORLD INIT_FILE OUT_DIR [nccl]

joins a group of WORLD ranks (gloo, or NCCL with the mesh on the rank's
card) through the file INIT_FILE, runs every case of ``cases(WORLD)`` on a
``dist`` mesh and writes each y into OUT_DIR/rank<RANK>.npz.  The tests
build the same cases on a ``local`` mesh and compare.  A rank that does not
finish is killed by the test's timeout.
"""
import dataclasses
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _matrices():
    from singlespmv_tpu_torch.data.generators import generate, powerlaw

    return {"band": generate("band", 40000, 5, seed=2),
            "powerlaw": powerlaw(6000, 40000, seed=4),
            "small": powerlaw(300, 5000, seed=31),
            "halo_band": generate("band", 512, 8, seed=2)}


def cases(world: int) -> dict:
    """name -> fn(make_mesh) returning (op, x): the operators each world
    runs, on meshes of ``world`` shards."""
    from singlespmv_tpu_torch import Config
    from singlespmv_tpu_torch.parallel import DistSpMV, DistXch, HaloSpMV

    mats = _matrices()
    f32 = Config(format="xch", dtype="float32")
    ss = Config(format="ss", dtype="float64", segment_width=128)

    def x_of(coo, dtype=np.float64):
        return np.random.default_rng(5).uniform(
            -1, 1, coo.n_col).astype(dtype)

    def xch_ring(mk):
        op = DistXch.convert(mats["band"], f32, mk((("row", world),)))
        if world == 2:    # two shards reach ring mode only when forced
            op = dataclasses.replace(op, x_mode="ring", n_rounds=(1, 1))
        return op, x_of(mats["band"], np.float32)

    def xch_allgather(mk):
        op = DistXch.convert(mats["powerlaw"], f32, mk((("row", world),)))
        return op, x_of(mats["powerlaw"], np.float32)

    def spmv_row(mk):
        return (DistSpMV.convert(mats["small"], ss, mk((("row", world),))),
                x_of(mats["small"]))

    def spmv_gather_x(mk):
        return (DistSpMV.convert(mats["small"], ss, mk((("row", world),)),
                                 col_axis=None, gather_x=True),
                x_of(mats["small"]))

    def spmv_col(mk):
        return (DistSpMV.convert(mats["small"], ss,
                                 mk((("row", 1), ("col", world)))),
                x_of(mats["small"]))

    def halo_rounds(mk):
        return (HaloSpMV.convert(mats["halo_band"], ss, mk((("row", world),)),
                                 mode="rounds"), x_of(mats["halo_band"]))

    def halo_boundary(mk):
        return (HaloSpMV.convert(mats["small"], ss, mk((("row", world),)),
                                 mode="boundary"), x_of(mats["small"]))

    out = dict(xch_ring=xch_ring, xch_allgather=xch_allgather,
               spmv_row=spmv_row, spmv_gather_x=spmv_gather_x,
               spmv_col=spmv_col, halo_rounds=halo_rounds,
               halo_boundary=halo_boundary)
    if world == 4:
        def spmv_2x2(mk):
            return (DistSpMV.convert(mats["small"], ss,
                                     mk((("row", 2), ("col", 2)))),
                    x_of(mats["small"]))
        out["spmv_2x2"] = spmv_2x2
    return out


def main(rank: int, world: int, init_file: str, out_dir: str,
         backend: str = "gloo") -> int:
    sys.modules["singlespmv_tpu"] = None     # the reference stays out
    import datetime

    import torch
    import torch.distributed as dist

    from singlespmv_tpu_torch.parallel import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    device = "cuda" if backend == "nccl" else "cpu"

    def mk(shape):
        return make_mesh(shape, device=device, backend="dist")

    res = {}
    for name, make in cases(world).items():
        op, x = make(mk)
        res[name] = op(x).cpu().numpy()
        if name == "xch_ring":
            res["xch_ring_mode"] = np.array(op.x_mode)
    try:
        mk((("row", world + 1),))
        res["size_refused"] = np.array(False)
    except ValueError:
        res["size_refused"] = np.array(True)
    dist.barrier()
    dist.destroy_process_group()
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib")
                 or m.startswith("singlespmv_tpu."))
    res["foreign_modules"] = np.array(",".join(bad))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    raise SystemExit(main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                          sys.argv[4], *sys.argv[5:6]))
