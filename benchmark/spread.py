"""Sets of whole runs of one cell, each run its own process as the check
makes them, and the spread of each metric: the distance between the first
and third quartiles (``statistics.quantiles(values, n=4)``) as a share of
the median, per set.

    python3 benchmark/spread.py --workload hpcg-104.cg50 --seconds 10 \
        --seeds 11 12 13 14 15 16 --sets 2 [--trace] [--out runs.jsonl]

Every set runs the same seeds.  Prints one JSON line a run and a summary
line a set."""
import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def spread(values) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sink = open(args.out, "a") if args.out else None
    for k in range(args.sets):
        values = {}
        for seed in args.seeds:
            res = subprocess.run(
                [sys.executable, os.path.join(HERE, "run.py"),
                 "--workload", args.workload, "--seed", str(seed),
                 "--seconds", str(args.seconds),
                 "--trace", "1" if args.trace else "0"],
                capture_output=True, text=True)
            line = res.stdout.strip().splitlines()[-1] if res.stdout.strip() \
                else "null"
            rec = {"set": k, "seed": seed, "rc": res.returncode,
                   "result": json.loads(line),
                   "stderr_tail": res.stderr[-600:]}
            print(json.dumps(rec), flush=True)
            if sink:
                sink.write(json.dumps(rec) + "\n")
                sink.flush()
            if rec["result"]:
                for name, m in rec["result"]["metrics"].items():
                    values.setdefault(name, []).append(m["value"])
        summary = {"set": k, "workload": args.workload,
                   "median": {n: statistics.median(v)
                              for n, v in values.items()},
                   "spread": {n: spread(v) for n, v in values.items()
                              if len(v) >= 2}}
        print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
