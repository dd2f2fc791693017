"""The port's headline benchmark: the root ``bench.py`` on one GPU.  Prints
ONE JSON line, with ``bench.py``'s keys.

    python -m singlespmv_tpu_torch.bench [--names N ...] [--dtype float64]
        [--out FILE.tsv [--append]] [--device cpu] [--prefetch K]

It runs the reference's headline class, the 26 natural-suite matrices as
their structure-matched stand-ins (``data/structgen.py``, seed 0), through
``harness/suite.run_suite`` and the auto planner with ``bench.py``'s
Config (``format="auto"``, ``calibrate_seconds=0.4``, ``n_trials=5``).
GFLOPS is 2·nnz over ``Time(s)``, the driver's chained marginal.  The
metric is the median of the per-matrix ratios to singleSpMV's measured
CSR5-AVX2 GFLOPS (``BASELINE_AVX2``); ``value`` is the median GFLOPS.  A
matrix that raises scores 0 and the run goes on.

Converted states are kept in ``results/state_cache_torch/``
(``formats/cache.py``), so a second run loads them.  ``--names`` runs a
subset, and ``--out`` writes the campaign's TSV (``OptimizeTimeS`` is each
row's convert, trials included); with ``--append`` the rows the TSV holds
already are skipped and the JSON line covers every row of the TSV, so one
campaign can span several processes.  ``--prefetch`` processes synthesize
the next stand-ins while the card runs the current one.  The card's name
and power limit go to stderr first.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

METRIC = "natural_suite_full26_median_vs_csr5avx2"
CACHE_DIR = os.path.join("results", "state_cache_torch")


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the card, or why not."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"no nvidia-smi reading ({type(e).__name__})"


def headline(rows) -> dict:
    """``bench.py``'s JSON line from campaign rows (``TSV_COLS``): a row
    without GFLOPS (the matrix raised) scores 0 and is chosen "ERROR"."""
    import numpy as np

    from .harness.suite import BASELINE_AVX2

    gflops, ratios, chosen = {}, {}, {}
    for r in rows:
        name = r["Matrix"].removeprefix("synth-")
        if not isinstance(r["GFLOPS"], (int, float)):
            gflops[name], ratios[name], chosen[name] = 0.0, 0.0, "ERROR"
            continue
        gflops[name] = round(float(r["GFLOPS"]), 3)
        base = BASELINE_AVX2.get(name)
        if base:
            ratios[name] = round(float(r["GFLOPS"]) / base, 3)
        chosen[name] = r["ChosenFormat"]
    med_ratio = float(np.median(list(ratios.values()))) if ratios else 0.0
    wins = sum(1 for v in ratios.values() if v >= 1.0)
    return {
        "metric": METRIC,
        "value": round(float(np.median(list(gflops.values()))), 3)
        if gflops else 0.0,
        "unit": "GFLOPS",
        "vs_baseline": round(med_ratio, 3),
        "wins": wins,
        "losses": len(ratios) - wins,
        "detail": gflops,
        "per_matrix_ratio": ratios,
        "chosen_format": chosen,
    }


def main(argv=None) -> int:
    from .config import Config
    from .harness.suite import StandIns, read_tsv, run_suite, suite_order

    ap = argparse.ArgumentParser(prog="singlespmv_tpu_torch.bench")
    ap.add_argument("--names", nargs="+", default=None,
                    help="a subset of the 26 suite names")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "float64", "bfloat16"])
    ap.add_argument("--out", default=None, help="the campaign's TSV")
    ap.add_argument("--append", action="store_true",
                    help="skip the rows --out holds; report all of them")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--cache-dir", default=CACHE_DIR)
    ap.add_argument("--prefetch", type=int, default=1,
                    help="processes that synthesize stand-ins ahead "
                         "(0: none)")
    a = ap.parse_args(argv)
    log = lambda m: print(m, file=sys.stderr)   # noqa: E731
    log(f"card: {card_line()}")

    order = suite_order()
    names = [n for n in order if n in a.names] if a.names else order
    unknown = sorted(set(a.names or ()) - set(order))
    if unknown:
        ap.error(f"not suite names: {unknown}")
    cfg = Config(format="auto", dtype=a.dtype, calibrate_seconds=0.4,
                 n_trials=5)
    done = set()
    if a.out and a.append and os.path.exists(a.out):
        done = {r["Matrix"] for r in read_tsv(a.out)}
    todo = [n for n in names if f"synth-{n}" not in done]
    synth = StandIns(todo, workers=a.prefetch, log=log) \
        if a.prefetch > 0 and todo else None
    try:
        rows = run_suite(names, cfg=cfg, out=a.out, append=a.append,
                         cache_dir=a.cache_dir, device=a.device,
                         synth=synth, log=log)
    finally:
        if synth is not None:
            synth.close()
    if a.out and a.append:
        rows = read_tsv(a.out)
    print(json.dumps(headline(rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
