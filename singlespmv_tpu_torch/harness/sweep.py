"""Sweep runner: ``singlespmv_tpu/harness/sweep.py`` for the port.

singleSpMV farms (arch × format × params) configurations over matrix
suites with SLURM: ``script/todo.csv`` rows drive per-configuration builds
and batch scripts, with ``ln -s`` lockfiles making re-runs idempotent
(``script/coma_eval_sbatch.sh:18-23``, ``gen_todo.sh:1-47``).  Here a todo
table of Config overrides runs in one process through ``run_benchmark``
on ``device`` (the kernels build once), a JSON manifest replaces the
lockfiles, and results append to per-configuration report-block and JSONL
logs.
"""
from __future__ import annotations

import csv
import json
import os
import sys
from typing import Dict, Iterable, List

from ..config import Config
from .report import get_basename, to_jsonl

_BOOL = {"true": True, "false": False, "1": True, "0": False}
_INT_FIELDS = {"segment_width", "n_block", "index_bits", "omega", "sigma",
               "row_block", "lane_width", "n_trials", "max_loop",
               "bkt_group_cols", "bkt_row_group", "spmm_b"}
_FLOAT_FIELDS = {"calibrate_seconds", "bkt_cap_pct"}
_BOOL_FIELDS = {"padding", "verify", "profiling", "measure_step_time",
                "bkt_balance"}


def parse_todo(path_or_text: str) -> List[Dict[str, str]]:
    """Reads a sweep table (a path, or the CSV text itself): a header of
    Config field names and 'prefix'.

    singleSpMV's todo.csv rows are ``arch,prefix,flags``; these name Config
    fields directly (format, variant, segment_width, ...).  A 'prefix'
    column names the output log, like singleSpMV's PREFIX= make variable.
    """
    if os.path.exists(path_or_text):
        f = open(path_or_text, newline="")
    else:
        import io
        f = io.StringIO(path_or_text)
    with f:
        return [dict(r) for r in csv.DictReader(f)]


def config_from_row(row: Dict[str, str]) -> Config:
    """The Config of one todo row (empty cells keep the defaults)."""
    kw = {}
    for k, v in row.items():
        if k in ("prefix", None) or v in (None, ""):
            continue
        if k in _INT_FIELDS:
            kw[k] = int(v)
        elif k in _FLOAT_FIELDS:
            kw[k] = float(v)
        elif k in _BOOL_FIELDS:
            kw[k] = _BOOL[v.strip().lower()]
        else:
            kw[k] = v
    return Config(**kw)


def default_todo() -> str:
    """The reference's sweep (singleSpMV's script/gen_todo.sh:1-47 as the
    reference sized it): CRS and the baselines, SS simple/optimized ×
    widths, CSS × n_block, CSR5 × sigma."""
    rows = ["prefix,format,variant,segment_width,n_block,sigma"]
    rows.append("crs,csr,optimized,,,")
    rows.append("coo,coo,optimized,,,")
    rows.append("ell,ell,optimized,,,")
    rows.append("jds,jds,optimized,,,")
    rows.append("dia,dia,optimized,,,")
    rows.append("dense,dense,optimized,,,")
    rows.append("bcoo,bcoo,optimized,,,")
    rows.append("bsr,bsr,optimized,,,")
    rows.append("bkt,bkt,optimized,,,")
    rows.append("slab,slab,optimized,,,")
    rows.append("hyb,hyb,optimized,,,")
    rows.append("xch,xch,optimized,,,")
    rows.append("auto,auto,optimized,,,")
    for w in (256, 512, 1024, 2048, 4096, 8192, 16384):
        rows.append(f"ss-simple-{w},ss,simple,{w},,")
        rows.append(f"ss-opt-{w},ss,optimized,{w},,")
    for nb in (1, 2, 4, 8, 16):
        rows.append(f"css-{nb},css,optimized,2048,{nb},")
    for sig in (0, 4, 8, 16, 32):
        rows.append(f"csr5-s{sig},csr5,optimized,,,{sig}")
    return "\n".join(rows) + "\n"


def run_sweep(
    todo: str,
    matrices: Iterable[str],
    out_dir: str = "log",
    *,
    quick: bool = False,
    manifest_name: str = "manifest.json",
    device="cuda",
    dtype: str = None,
    log=lambda msg: print(msg, file=sys.stderr),
) -> int:
    """Runs every (todo row × matrix) pair not already in the manifest on
    ``device``; returns the number of failures.  ``dtype`` sets the value
    type of the rows that name none.

    Idempotence: a JSON manifest records finished (prefix, matrix) pairs,
    the analog of singleSpMV's lockfiles, so an interrupted sweep resumes
    where it stopped.  Results append to <out>/<prefix>.log (report blocks)
    and <prefix>.jsonl.
    """
    from .driver import run_benchmark

    rows = parse_todo(todo)
    os.makedirs(out_dir, exist_ok=True)
    mpath = os.path.join(out_dir, manifest_name)
    manifest = {}
    if os.path.exists(mpath):
        with open(mpath) as f:
            manifest = json.load(f)

    failures = 0
    for row in rows:
        prefix = row.get("prefix") or row.get("format", "run")
        cfg = config_from_row(row)
        if dtype and not row.get("dtype"):
            cfg = cfg.replace(dtype=dtype)
        for mat in matrices:
            key = f"{prefix}::{get_basename(mat)}"
            if manifest.get(key) == "done":
                continue
            log(f"[sweep] {key}")
            try:
                res = run_benchmark(mat, cfg, quick=quick, device=device,
                                    log=log)
            except Exception as e:  # keep sweeping; record the failure
                log(f"[sweep] {key} FAILED: {e}")
                manifest[key] = f"error: {e}"
                failures += 1
            else:
                with open(os.path.join(out_dir, f"{prefix}.log"), "a") as f:
                    f.write(res.block + "\n")
                with open(os.path.join(out_dir, f"{prefix}.jsonl"), "a") as f:
                    f.write(to_jsonl(res.report) + "\n")
                manifest[key] = "done" if res.verify_ok else "verify-failed"
                if not res.verify_ok:
                    failures += 1
            with open(mpath, "w") as f:
                json.dump(manifest, f, indent=1, sort_keys=True)
    return failures
