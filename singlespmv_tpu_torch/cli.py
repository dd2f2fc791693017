"""Command line of the port: ``singlespmv_tpu/cli.py`` on PyTorch.

    python -m singlespmv_tpu_torch bench matrix.mtx --format=slab
    python -m singlespmv_tpu_torch bench matrix.mtx --device cpu --quick
    python -m singlespmv_tpu_torch formats
    python -m singlespmv_tpu_torch info matrix.mtx        # counter.cpp
    python -m singlespmv_tpu_torch spy matrix.mtx         # visualizer.cpp
    python -m singlespmv_tpu_torch gen band 1024 --out m.mtx
    python -m singlespmv_tpu_torch format-logs run.log    # log/format.cpp
    python -m singlespmv_tpu_torch confirm [--device cpu] # confirm_cpu.sh
    python -m singlespmv_tpu_torch suite test --out matrices/
    python -m singlespmv_tpu_torch calibrate [--out PATH]
    python -m singlespmv_tpu_torch sweep --todo todo.csv --matrices m.mtx

``bench`` runs ``harness.driver.run_benchmark`` on one (matrix, config) and
prints the report block; it exits 1 when Verify fails.  It takes the
reference's flags, less the value types the port has no kernels for.  The
commands that run formats (``bench``, ``confirm``, ``sweep``) take
``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain
versions); ``calibrate`` measures the card only.  ``suite natural`` is not
ported: it downloads the SuiteSparse tarballs, and the port runs the suite
as stand-ins (``python -m singlespmv_tpu_torch.bench``).
"""
from __future__ import annotations

import argparse
import sys

from .config import Config
from .core.dtypes import VALUE_TYPES


def _add_config_args(p: argparse.ArgumentParser):
    p.add_argument("--format", default="csr",
                   help="storage format (see `formats`)")
    p.add_argument("--variant", default="optimized",
                   choices=["simple", "optimized"])
    p.add_argument("--dtype", default="float32", choices=VALUE_TYPES)
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


def cmd_info(args) -> int:
    from .core.mmio import read_matrix_market
    from .core.types import matrix_stats

    coo = read_matrix_market(args.matrix, sum_duplicates=True)
    for k, v in matrix_stats(coo).items():
        print(f"{k:>12}\t{v}")
    return 0


def cmd_spy(args) -> int:
    from .core.mmio import read_matrix_market
    from .data.tools import spy_plot

    coo = read_matrix_market(args.matrix, sum_duplicates=True)
    print(spy_plot(coo, size=args.size))
    return 0


def cmd_gen(args) -> int:
    from .core.mmio import write_matrix_market
    from .data.generators import generate, powerlaw

    if args.shape == "powerlaw":
        coo = powerlaw(args.n, args.nnz or args.n * 16, seed=args.seed)
    else:
        coo = generate(args.shape, args.n, args.param, seed=args.seed,
                       artificial=args.artificial)
    out = args.out or f"{args.shape}-{args.n}.mtx"
    write_matrix_market(out, coo)
    print(out)
    return 0


def cmd_format_logs(args) -> int:
    from .harness.logfmt import format_logs, sum_gflops

    if args.log == "-":
        text = sys.stdin.read()
    else:
        with open(args.log) as f:
            text = f.read()
    if args.sum:
        print(f"{sum_gflops(text):.6f}")     # log/sum.sh
    else:
        print(format_logs(text, extra_keys=args.keys))
    return 0


def cmd_confirm(args) -> int:
    """Runs every format over the fixtures and band-64 (confirm_cpu.sh);
    exits 1 on any failure."""
    from .data import fixtures as fx
    from .data.generators import generate
    from .formats import available_formats
    from .harness.driver import run_benchmark

    mats = [(n, f()) for n, f in fx.ALL_FIXTURES.items()]
    mats.append(("band-64", generate("band", 64, 5, seed=1)))
    fmts = args.formats or [f for f in available_formats() if f != "crs"]
    bad = 0
    for fmt in fmts:
        for name, coo in mats:
            cfg = Config(format=fmt, dtype=args.dtype)
            try:
                res = run_benchmark(coo, cfg, name=name, quick=True,
                                    device=args.device, log=lambda m: None)
                ok = res.verify_ok
            except Exception as e:
                print(f"{fmt:>8} {name:<12} ERROR {type(e).__name__}: {e}")
                bad += 1
                continue
            print(f"{fmt:>8} {name:<12} {'PASS' if ok else 'FAIL'}"
                  f"  {res.gflops:.3f} GFLOPS")
            bad += 0 if ok else 1
    print(f"confirm: {'ALL PASS' if bad == 0 else f'{bad} FAILURES'}")
    return 1 if bad else 0


def cmd_suite(args) -> int:
    """Writes a matrix suite as .mtx files (gen.sh's artificial suite, the
    test fixtures)."""
    import os

    from .core.mmio import write_matrix_market

    if args.suite == "natural":
        print("suite natural: not ported, since it downloads the SuiteSparse "
              "tarballs; unpack a staged tarball with "
              "singlespmv_tpu_torch.data.suitesparse.extract_mtx, or run the "
              "stand-ins with python -m singlespmv_tpu_torch.bench",
              file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)
    if args.suite == "artificial":
        from .data.generators import generate

        sizes = args.sizes or [512, 1024, 2048, 4096, 8192, 16384, 32768]
        for kind in ("band", "unbalance", "random"):
            for n in sizes:
                p = os.path.join(args.out, f"{kind}-{n}.mtx")
                if not os.path.exists(p):
                    write_matrix_market(p, generate(kind, n, artificial=True,
                                                    seed=3))
                    print(p)
        for n in (sizes if args.sizes else [512, 1024, 2048, 4096]):
            p = os.path.join(args.out, f"dense-{n}.mtx")
            if not os.path.exists(p) and n <= 4096:
                write_matrix_market(p, generate("dense", n, artificial=True,
                                                seed=3))
                print(p)
        return 0
    from .data import fixtures as fx

    for name, f in fx.ALL_FIXTURES.items():
        p = os.path.join(args.out, f"{name}.mtx")
        write_matrix_market(p, f())
        print(p)
    return 0


def cmd_calibrate(args) -> int:
    from .harness.calibrate import main as cal_main

    cal_main(["--out", args.out] if args.out else [])
    return 0


def cmd_sweep(args) -> int:
    from .harness.sweep import run_sweep

    return 1 if run_sweep(todo=args.todo, matrices=args.matrices,
                          out_dir=args.out, quick=args.quick,
                          device=args.device, dtype=args.dtype) else 0


def _add_device(p):
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="singlespmv_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("bench", help="benchmark one (matrix, config)")
    p.add_argument("matrix")
    _add_config_args(p)
    _add_device(p)
    p.add_argument("--jsonl", help="append result to JSONL file")
    p.add_argument("--trace",
                   help="write a torch.profiler trace of the trials here")
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("formats", help="list available formats")
    p.set_defaults(fn=cmd_formats)

    p = sub.add_parser("info", help="matrix stats (counter.cpp)")
    p.add_argument("matrix")
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("spy", help="ASCII spy plot (visualizer.cpp)")
    p.add_argument("matrix")
    p.add_argument("--size", type=int, default=32)
    p.set_defaults(fn=cmd_spy)

    p = sub.add_parser("gen", help="generate a test/artificial matrix")
    p.add_argument("shape", choices=["band", "dense", "unbalance",
                                     "random_unbalance", "random",
                                     "powerlaw"])
    p.add_argument("n", type=int)
    p.add_argument("param", type=int, nargs="?", default=None,
                   help="shape parameter (band width / nnz / ...)")
    p.add_argument("--nnz", type=int, default=None)
    p.add_argument("--seed", type=int, default=3)
    p.add_argument("--artificial", action="store_true",
                   help="val=1.0 variant")
    p.add_argument("--out")
    p.set_defaults(fn=cmd_gen)

    p = sub.add_parser("format-logs",
                       help="report blocks -> TSV (log/format.cpp)")
    p.add_argument("log", help="log file, or - for stdin")
    p.add_argument("--keys", nargs="*", default=None,
                   help="extra report keys to include as columns")
    p.add_argument("--sum", action="store_true",
                   help="print total GFLOPS instead of the table (log/sum.sh)")
    p.set_defaults(fn=cmd_format_logs)

    p = sub.add_parser("confirm",
                       help="run every format over the fixtures "
                            "(confirm_cpu.sh)")
    p.add_argument("--formats", nargs="*", default=None)
    p.add_argument("--dtype", default="float32", choices=VALUE_TYPES)
    _add_device(p)
    p.set_defaults(fn=cmd_confirm)

    p = sub.add_parser("suite", help="write a matrix suite as .mtx files "
                                     "(natural: not ported, it downloads)")
    p.add_argument("suite", choices=["test", "artificial", "natural"])
    p.add_argument("--out", default="matrices")
    p.add_argument("--sizes", nargs="*", type=int, default=None)
    p.set_defaults(fn=cmd_suite)

    p = sub.add_parser("calibrate",
                       help="measure the card's constants -> "
                            "chip_constants.json (the card only)")
    p.add_argument("--out", default=None)
    p.set_defaults(fn=cmd_calibrate)

    p = sub.add_parser("sweep",
                       help="run a configuration sweep (eval_sbatch)")
    p.add_argument("--todo", required=True,
                   help="sweep table CSV (a path or the text)")
    p.add_argument("--matrices", nargs="+", required=True)
    p.add_argument("--out", default="log")
    p.add_argument("--quick", action="store_true")
    p.add_argument("--dtype", default=None, choices=VALUE_TYPES,
                   help="value type of the rows that name none")
    _add_device(p)
    p.set_defaults(fn=cmd_sweep)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
