"""Natural-suite campaign: ``singlespmv_tpu/harness/suite.py`` for the port.

The reference's headline is GFLOPS over the 26 SuiteSparse matrices of
singleSpMV's CSR5 results (``BASELINE_AVX2``).  ``run_suite`` benchmarks
each of them through ``run_benchmark`` on ``device``: the real matrix
where ``matrix_dir`` holds <name>.mtx, else its structure-matched stand-in
(``data/structgen.py``; the row is then named synth-<name>).  It writes a
TSV row per matrix with the baseline beside the measured GFLOPS
(``TSV_COLS``), and a matrix that raises gets a row with an ``ERROR:``
Verify while the campaign goes on.  ``StandIns`` builds the stand-ins
ahead in worker processes, so that a campaign's synthesis overlaps its
runs.

Run: ``python -m singlespmv_tpu_torch.harness.suite [--out FILE]
[--matrix-dir DIR] [--append] [--dtype float64] [--device cpu] [names]``;
the headline is ``python -m singlespmv_tpu_torch.bench``.
"""
from __future__ import annotations

import multiprocessing
import os
import shutil
import sys
import tempfile
import traceback
import weakref
from typing import Callable, Dict, List, Optional

from ..config import Config
from ..core.dtypes import VALUE_TYPES

# CSR5 AVX2 double-precision GFLOPS a matrix: the reference's committed
# numbers (BASELINE.md; singleSpMV's opt/Benchmark_SpMV_using_CSR5/
# CSR5_avx2/cpu-15-10-01-13-17.tsv), copied from reference suite.py:26-34
BASELINE_AVX2: Dict[str, float] = {
    "ASIC_680ks": 9.007, "Chebyshev4": 22.072, "Freescale1": 6.821,
    "FullChip": 6.464, "Hamrle3": 5.963, "ML_Geer": 12.568, "PR02R": 8.366,
    "RM07R": 11.475, "TSOPF_RS_b2383_c1": 10.656, "cage15": 10.050,
    "circuit5M": 9.092, "g7jac200sc": 11.977, "laminar_duct3D": 24.429,
    "lhr34": 17.075, "mac_econ_fwd500": 10.019, "ohne2": 10.770,
    "para-4": 13.327, "raefsky3": 22.195, "rajat31": 6.367, "sme3Dc": 14.632,
    "stomach": 17.435, "thermomech_dK": 12.895, "torso1": 6.277,
    "twotone": 13.017, "webbase-1M": 13.099, "xenon2": 17.934,
}

TSV_COLS = ("Matrix", "nRow", "nNnz", "ChosenFormat", "GFLOPS",
            "BaselineGFLOPS", "vsBaseline", "BandwidthGBs", "RooflinePct",
            "AttainPct", "OptimizeTimeS", "Verify")


def suite_order() -> List[str]:
    """The 26 suite names in ascending nnz, the campaign's order."""
    from ..data.structgen import RECIPES

    return sorted(RECIPES, key=lambda n: RECIPES[n][1])


def _synthesize_to(name: str, seed: int, path: str) -> str:
    """Synthesizes stand-in ``name`` into the .npz file ``path``."""
    import numpy as np

    from ..data.structgen import synthesize_structured

    coo = synthesize_structured(name, seed=seed)
    np.savez(path, n_row=coo.n_row, n_col=coo.n_col, row=coo.row,
             col=coo.col, val=coo.val)
    return path


class StandIns(dict):
    """The stand-ins of ``names`` (seed ``seed``), synthesized in spawned
    processes in the order given, so that the card works on the first ones
    while the last ones are built.  ``mats[name]`` waits for its own and
    keeps it; ``synth(name, seed)``, ``run_suite``'s hook, hands it over
    without keeping it (a name it was not given, or another seed, is
    synthesized in place).  Each worker runs on one thread (the native
    sort is OpenMP); ``workers`` defaults to one a name, leaving one core
    free, so that the host-side timings of this process do not compete
    with the synthesis.  A worker hands its matrix over in a file, read
    when it is asked for: a result sent back through the pool would be
    received by a thread of this process, which then holds the GIL against
    the timed loops (a circuit5M-sized one made spmvs 25-180x slower for
    seconds)."""

    def __init__(self, names, seed: int = 0, workers: Optional[int] = None,
                 log=lambda m: print(m, flush=True)):
        super().__init__()
        self.seed, self.log = seed, log
        self.dir = tempfile.mkdtemp(prefix="standins_")
        weakref.finalize(self, shutil.rmtree, self.dir, ignore_errors=True)
        if workers is None:
            workers = min(len(names), (os.cpu_count() or 2) - 1)
        ctx = multiprocessing.get_context("spawn")
        saved = os.environ.get("OMP_NUM_THREADS")
        os.environ["OMP_NUM_THREADS"] = "1"    # read by the workers at start
        try:
            self.pool = ctx.Pool(max(1, workers))
        finally:
            if saved is None:
                del os.environ["OMP_NUM_THREADS"]
            else:
                os.environ["OMP_NUM_THREADS"] = saved
        self.pending = {n: self.pool.apply_async(_synthesize_to, (
            n, seed, os.path.join(self.dir, f"{n}.npz"))) for n in names}

    def _load(self, name: str):
        import time

        import numpy as np

        from ..core.types import COOMatrix

        t0 = time.perf_counter()
        path = self.pending.pop(name).get()
        with np.load(path) as z:
            coo = COOMatrix(n_row=int(z["n_row"]), n_col=int(z["n_col"]),
                            row=z["row"], col=z["col"], val=z["val"])
        os.remove(path)
        waited = time.perf_counter() - t0
        if waited > 1.0:
            self.log(f"waited {waited:.1f} s for the {name} stand-in")
        return coo

    def __missing__(self, name: str):
        self[name] = self._load(name)
        return self[name]

    def __call__(self, name: str, seed: int = 0):
        from ..data.structgen import synthesize_structured

        if seed != self.seed:
            return synthesize_structured(name, seed=seed)
        if name in self:
            return self.pop(name)
        if name in self.pending:
            return self._load(name)
        return synthesize_structured(name, seed=seed)

    def close(self):
        self.pool.terminate()
        self.pool.join()


def read_tsv(path: str) -> List[dict]:
    """The rows of a campaign TSV, numbers as numbers ('' where a matrix
    raised)."""
    rows = []
    with open(path) as f:
        lines = f.read().splitlines()
    for line in lines[1:]:
        if not line.strip():
            continue
        row = dict(zip(TSV_COLS, line.split("\t")))
        for k, v in row.items():
            if k in ("Matrix", "ChosenFormat", "Verify") or v == "":
                continue
            try:
                row[k] = int(v) if k in ("nRow", "nNnz") else float(v)
            except ValueError:
                pass
        rows.append(row)
    return rows


def run_suite(names: Optional[List[str]] = None, *,
              cfg: Optional[Config] = None, out: Optional[str] = None,
              matrix_dir: Optional[str] = None, seed: int = 0,
              append: bool = False, cache_dir: Optional[str] = None,
              device="cuda", synth: Optional[Callable] = None,
              log=lambda m: print(m, file=sys.stderr)) -> List[dict]:
    """Benchmarks the natural suite on ``device``; returns one dict a
    matrix (``TSV_COLS``).

    ``matrix_dir``: where <name>.mtx exists there, the real matrix is
    used, else the stand-in is synthesized by ``synth(name, seed)``
    (``synthesize_structured`` by default; ``StandIns`` builds ahead) and
    the row is named synth-<name>.  With ``out`` and ``append`` a matrix
    whose row ``out`` holds already is skipped, so a campaign can span
    several processes.  ``cache_dir`` keeps the converted states
    (``formats/cache.py``)."""
    from ..data.structgen import synthesize_structured
    from .driver import run_benchmark

    cfg = cfg or Config(format="auto", dtype="float32", verify=True)
    synth = synth or (lambda n, s: synthesize_structured(n, seed=s))
    names = names or suite_order()
    rows: List[dict] = []
    done = set()
    if out and append and os.path.exists(out):
        done = {r["Matrix"] for r in read_tsv(out)}

    def emit(row):
        rows.append(row)
        if out:
            new = not os.path.exists(out) or os.path.getsize(out) == 0
            with open(out, "a") as f:
                if new:
                    f.write("\t".join(TSV_COLS) + "\n")
                f.write("\t".join(str(row[c]) for c in TSV_COLS) + "\n")

    for name in names:
        mtx = os.path.join(matrix_dir, f"{name}.mtx") if matrix_dir else None
        label = name if (mtx and os.path.exists(mtx)) else f"synth-{name}"
        if label in done:
            log(f"{label}: already in {out}, skipping")
            continue
        try:
            log(f"=== {label} ===")
            matrix = mtx if (mtx and os.path.exists(mtx)) \
                else synth(name, seed)
            res = run_benchmark(matrix, cfg, name=label, log=log,
                                cache_dir=cache_dir, device=device)
            base = BASELINE_AVX2.get(name, float("nan"))
            r = res.report
            emit({
                "Matrix": label, "nRow": r["nRow"], "nNnz": r["nNnz"],
                "ChosenFormat": r.get("ChosenFormat", r["MatrixFormat"]),
                "GFLOPS": round(res.gflops, 3),
                "BaselineGFLOPS": base,
                "vsBaseline": round(res.gflops / base, 3) if base else "",
                "BandwidthGBs": round(r.get("Bandwidth(GB/s)") or 0.0, 1),
                "RooflinePct": round(r.get("RooflinePct") or 0.0, 1),
                "AttainPct": round(r.get("AttainablePct") or 0.0, 1),
                "OptimizeTimeS": round(r["OptimizeTime(s)"], 2),
                "Verify": r["Verify"],
            })
            log(f"{label}: {res.gflops:.2f} GFLOPS "
                f"(baseline {base}, x{res.gflops / base:.2f}) "
                f"[{r.get('ChosenFormat', '?')}]")
        except Exception as e:  # noqa: BLE001 — one matrix must not end it
            log(f"{label}: FAILED {type(e).__name__}: {e}")
            traceback.print_exc(file=sys.stderr)
            emit({c: "" for c in TSV_COLS} | {
                "Matrix": label, "Verify": f"ERROR:{type(e).__name__}"})
    return rows


def summarize(rows: List[dict]) -> dict:
    """The campaign's median GFLOPS, median ratio to the baseline, wins
    (ratio ≥ 1) and losses, over the rows that have numbers."""
    import numpy as np

    g = [r["GFLOPS"] for r in rows if isinstance(r["GFLOPS"], (int, float))]
    v = [r["vsBaseline"] for r in rows
         if isinstance(r["vsBaseline"], (int, float))]
    wins = sum(1 for x in v if x >= 1.0)
    return {
        "n": len(rows), "median_gflops": float(np.median(g)) if g else 0.0,
        "median_vs_baseline": float(np.median(v)) if v else 0.0,
        "wins": wins, "losses": len(v) - wins,
    }


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--matrix-dir", default=None)
    ap.add_argument("--append", action="store_true")
    ap.add_argument("--dtype", default="float32", choices=VALUE_TYPES)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("names", nargs="*", default=None)
    a = ap.parse_args()
    cfg = Config(format="auto", dtype=a.dtype, verify=True)
    rows = run_suite(a.names or None, cfg=cfg, out=a.out,
                     matrix_dir=a.matrix_dir, append=a.append,
                     device=a.device)
    print(summarize(rows))
