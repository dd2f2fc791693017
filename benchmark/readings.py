"""The readings a cell's limits are set from, in one process on the card:
the numbers the check compares, for sound runs of the program over many
seeds, and for its control, the program's own path at the next lower
value type (bfloat16 for float32, float32 for float64), over a few.

    python3 benchmark/readings.py --workload graph500-s20.spmv \
        --seeds 1 2 3 --control-seeds 4 5 6 --seconds 1

Each run is a whole run of the cell (``harness.run``) at its own size and
load with a short window; one JSON line a run."""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

LOWER = {"float32": "bfloat16", "float64": "float32"}


def control_dtype(workload: str) -> str:
    from benchmark import harness

    return LOWER[harness.cell(workload)["config"]["dtype"]]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)

    from benchmark import harness

    runs = [(s, None) for s in args.seeds] + [
        (s, control_dtype(args.workload)) for s in args.control_seeds]
    for seed, dtype in runs:
        t0 = time.perf_counter()
        out = harness.run(args.workload, seed, args.seconds, False,
                          dtype=dtype)
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "control": dtype, "correct": out["correct"],
            "attempted": out["attempted"], "engine": out["engine"],
            "check": {k: v["value"] for k, v in out["check"].items()},
            "metrics": {k: v["value"] for k, v in out["metrics"].items()},
            "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
