"""Command line of the port: ``singlespmv_tpu/cli.py``'s ``bench`` and
``formats``.

    python -m singlespmv_tpu_torch bench matrix.mtx --format=slab
    python -m singlespmv_tpu_torch bench matrix.mtx --device cpu --quick
    python -m singlespmv_tpu_torch formats

``bench`` runs ``harness.driver.run_benchmark`` on one (matrix, config) and
prints the report block; it exits 1 when Verify fails.  It takes the
reference's flags, less the value types the port has no kernels for, plus
``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain versions).
The reference's other subcommands are not ported (ROADMAP A.15).
"""
from __future__ import annotations

import argparse
import sys

from .config import Config


def _add_config_args(p: argparse.ArgumentParser):
    p.add_argument("--format", default="csr",
                   help="storage format (see `formats`)")
    p.add_argument("--variant", default="optimized",
                   choices=["simple", "optimized"])
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64"])
    p.add_argument("--segment-width", type=int, default=2048)
    p.add_argument("--n-block", type=int, default=1)
    p.add_argument("--omega", type=int, default=128)
    p.add_argument("--sigma", type=int, default=0,
                   help="0 = auto-tune from nnz/row")
    p.add_argument("--row-block", type=int, default=8)
    p.add_argument("--index-bits", type=int, default=32, choices=[32, 64])
    p.add_argument("--no-verify", action="store_true")
    p.add_argument("--profiling", action="store_true",
                   help="time each phase (PhaseTime-*, MulPerf, SumPerf)")
    p.add_argument("--calibrate-seconds", type=float, default=1.0)
    p.add_argument("--trials", type=int, default=10)
    p.add_argument("--quick", action="store_true",
                   help="skip calibration: 1 trial x 3 iterations")


def _config_from(args) -> Config:
    return Config(
        format=args.format, variant=args.variant, dtype=args.dtype,
        segment_width=args.segment_width, n_block=args.n_block,
        omega=args.omega, sigma=args.sigma, row_block=args.row_block,
        index_bits=args.index_bits, verify=not args.no_verify,
        profiling=args.profiling, calibrate_seconds=args.calibrate_seconds,
        n_trials=args.trials,
    )


def cmd_bench(args) -> int:
    from .harness.driver import run_benchmark

    cfg = _config_from(args)
    res = run_benchmark(args.matrix, cfg, quick=args.quick,
                        trace_dir=args.trace, device=args.device)
    print(res.block)
    if args.jsonl:
        from .harness.report import to_jsonl

        with open(args.jsonl, "a") as f:
            f.write(to_jsonl(res.report) + "\n")
    return 0 if (res.verify_ok or not cfg.verify) else 1


def cmd_formats(args) -> int:
    from .formats import available_formats

    for f in available_formats():
        print(f)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="singlespmv_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("bench", help="benchmark one (matrix, config)")
    p.add_argument("matrix")
    _add_config_args(p)
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")
    p.add_argument("--jsonl", help="append result to JSONL file")
    p.add_argument("--trace",
                   help="write a torch.profiler trace of the trials here")
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("formats", help="list available formats")
    p.set_defaults(fn=cmd_formats)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
