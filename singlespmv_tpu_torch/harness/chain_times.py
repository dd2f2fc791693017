"""Chained spmv times of the port's formats on the card, for two trees side
by side.

    python singlespmv_tpu_torch/harness/chain_times.py raefsky3:bkt g7jac200sc:bkt_g raefsky3:bkt:bfloat16

Each argument is ``stand-in:format``, or ``stand-in:format:dtype``
(``bkt_g``: bkt at 1024-row buckets; ``distxch<R>``: DistXch on a local
mesh of R shards on the card, float32, its step chained as the smoke times
it; dtype float32 unless named).
For each, the script builds the full-size stand-in
(``data.synthesize_structured``, seed 0), runs ``run_benchmark`` on the
card at the dtype (``calibrate_seconds`` 0.2, 3 trials: ``Time(s)`` is the
median of marginals over CUDA-graph replays of chained calls) and times
one eager spmv of the converted state as device busy time
(``driver.busy_seconds`` over every device event of 20 calls), and prints
one JSON line with both.  It imports the package through ``PYTHONPATH``
and only names that every version of the port since its chained runner
has had, so one copy of the script times two trees of the repository:

    env PYTHONPATH=<tree> python singlespmv_tpu_torch/harness/chain_times.py ...

Run one process per tree and turn (parent, change, change, parent).
``--coo-dir DIR`` keeps each stand-in there as ``<name>.npz`` (the format
of ``harness/suite.py``) once it is synthesized, and reads it from there
in the later turns: circuit5M takes minutes to synthesize.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys


def stand_in(name: str, coo_dir=None):
    """Stand-in ``name`` (seed 0), read from ``coo_dir/<name>.npz`` where it
    is there, else synthesized and, with ``coo_dir``, written there."""
    import numpy as np

    from singlespmv_tpu_torch.core.types import COOMatrix
    from singlespmv_tpu_torch.data import synthesize_structured

    path = os.path.join(coo_dir, f"{name}.npz") if coo_dir else None
    if path and os.path.exists(path):
        with np.load(path) as z:
            return COOMatrix(n_row=int(z["n_row"]), n_col=int(z["n_col"]),
                             row=z["row"], col=z["col"], val=z["val"])
    coo = synthesize_structured(name)
    if path:
        os.makedirs(coo_dir, exist_ok=True)
        np.savez(path, n_row=coo.n_row, n_col=coo.n_col, row=coo.row,
                 col=coo.col, val=coo.val)
    return coo


def dist_step(coo, R: int, dev) -> dict:
    """DistXch at R shards of a local mesh on the card: a step's chained
    µs (``marginal_seconds``, 0.05 s windows) and its y through the
    oracle."""
    import numpy as np
    import torch

    from singlespmv_tpu_torch import Config
    from singlespmv_tpu_torch.core import verify_result
    from singlespmv_tpu_torch.harness.driver import marginal_seconds
    from singlespmv_tpu_torch.parallel import DistXch, make_mesh

    op = DistXch.convert(coo, Config(format="xch"),
                         make_mesh((("row", R),), device=dev))
    xh = np.random.default_rng(0).uniform(-1, 1, coo.n_col).astype(
        np.float32)
    x = torch.from_numpy(xh).to(dev)
    ok = verify_result(coo, xh, op(x).cpu().numpy(), dtype=np.float32)[0]
    sec = marginal_seconds(lambda o, a: o.step(a), op, x, dev, 0.05,
                           name="DistXch")
    return {"verify": "PASS" if ok else "FAIL", "time_us": sec * 1e6,
            "busy_us": None}


def main(argv) -> int:
    import numpy as np
    import torch

    from singlespmv_tpu_torch import Config, formats
    from singlespmv_tpu_torch.harness import run_benchmark
    from singlespmv_tpu_torch.harness.driver import busy_seconds

    coo_dir = None
    if argv[:1] == ["--coo-dir"]:
        coo_dir, argv = argv[1], argv[2:]
    if not torch.cuda.is_available():
        raise SystemExit("chain_times needs a CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    mats = {}
    for arg in argv:
        name, fmt, dtype = (arg + ":float32").split(":")[:3]
        if name not in mats:
            mats[name] = stand_in(name, coo_dir)
        coo = mats[name]
        if fmt.startswith("distxch"):
            print(json.dumps({"name": name, "format": fmt, "dtype": dtype}
                             | dist_step(coo, int(fmt[7:]), dev)
                             | {"card": card}), flush=True)
            continue
        cfg = Config(format=fmt, dtype=dtype) if fmt != "bkt_g" else \
            Config(format="bkt", dtype=dtype, bkt_row_group=1024)
        cfg = cfg.replace(calibrate_seconds=0.2, n_trials=3)
        rep = run_benchmark(coo, cfg, device=dev, log=lambda m: None).report
        state = formats.convert(coo, cfg).to(dev)
        x = torch.from_numpy(np.random.default_rng(0).uniform(
            -1, 1, coo.n_col).astype(np.float32)).to(dev)
        x = x.to(getattr(torch, dtype))
        fn = formats.spmv_fn(cfg)
        busy = busy_seconds(lambda: fn(state, x), "", 20, None,
                            log=lambda m: None)
        print(json.dumps({
            "name": name, "format": fmt, "dtype": dtype,
            "verify": rep["Verify"],
            "time_us": rep["Time(s)"] * 1e6,
            "busy_us": None if busy is None else busy * 1e6,
            "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
