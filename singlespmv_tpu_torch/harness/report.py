"""Benchmark report block: a copy of ``singlespmv_tpu/harness/report.py``'s
``format_block``, ``to_jsonl``, ``FORMAT_NAMES`` (with ``hyb`` added) and
``get_basename`` (that package's ``harness/__init__`` imports jax, so it
cannot be imported here).

The block is ``%25s\\t%s`` key-value rows between a 40×'+' opener and a
40×'-' closer, the reference benchmark's machine-readable output.
"""
from __future__ import annotations

import json
import os
from typing import Dict

OPEN = "+" * 40
CLOSE = "-" * 40

# reference spelling of format names
FORMAT_NAMES = {
    "csr": "CRS", "crs": "CRS", "coo": "COO", "ell": "ELL", "jds": "JDS",
    "dia": "DIA", "ss": "SS", "css": "CSS", "csr5": "CSR5", "dense": "DENSE",
    "bcoo": "BCOO", "bsr": "BSR", "auto": "AUTO", "hyb": "HYB",
}


def get_basename(path: str) -> str:
    """Strip directory and extension ('ASIC_680ks')."""
    base = os.path.basename(str(path))
    if base.endswith(".mtx"):
        base = base[: -len(".mtx")]
    return base


def format_block(data: Dict[str, object]) -> str:
    lines = [OPEN]
    for k, v in data.items():
        if isinstance(v, float):
            v = f"{v:f}"
        lines.append(f"{k:>25}\t{v}")
    lines.append(CLOSE)
    return "\n".join(lines)


def to_jsonl(data: Dict[str, object]) -> str:
    """One JSON line of a report (keys sorted), the CLI's ``--jsonl``;
    numpy scalars become plain numbers."""
    return json.dumps(data, sort_keys=True,
                      default=lambda v: v.item() if hasattr(v, "item")
                      else str(v))
