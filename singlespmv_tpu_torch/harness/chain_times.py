"""Chained spmv times of the port's formats on the card, for two trees side
by side.

    python singlespmv_tpu_torch/harness/chain_times.py raefsky3:bkt g7jac200sc:bkt_g raefsky3:bkt:bfloat16

Each argument is ``stand-in:format``, or ``stand-in:format:dtype``
(``bkt_g``: bkt at 1024-row buckets; dtype float32 unless named).
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
"""
from __future__ import annotations

import json
import subprocess
import sys


def main(argv) -> int:
    import numpy as np
    import torch

    from singlespmv_tpu_torch import Config, formats
    from singlespmv_tpu_torch.data import synthesize_structured
    from singlespmv_tpu_torch.harness import run_benchmark
    from singlespmv_tpu_torch.harness.driver import busy_seconds

    if not torch.cuda.is_available():
        raise SystemExit("chain_times needs a CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    mats = {}
    for arg in argv:
        name, fmt, dtype = (arg + ":float32").split(":")[:3]
        cfg = Config(format=fmt, dtype=dtype) if fmt != "bkt_g" else \
            Config(format="bkt", dtype=dtype, bkt_row_group=1024)
        cfg = cfg.replace(calibrate_seconds=0.2, n_trials=3)
        if name not in mats:
            mats[name] = synthesize_structured(name)
        coo = mats[name]
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
