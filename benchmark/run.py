"""The benchmark of singlespmv_tpu_torch on NVIDIA GPUs: one run of one
cell, its result as one JSON line, the last of standard output.

    python3 benchmark/run.py --workload graph500-s20.spmv --seed 7 \
        --seconds 10 --trace 0

from the root of a checkout.  ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics.  The numbers compared with
the plain reference are the last lines of standard error and the result's
last key.  A run exits non-zero and prints no result without as many CUDA
devices as the cell asks for, or with jax, jaxlib, flax or singlespmv_tpu
loaded once the window has closed."""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    chips = harness.cell(args.workload)["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); {found} found",
              file=sys.stderr)
        return 2
    out = harness.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), t_start=T_START)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"loaded after the window: {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    for name, v in out["check"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
