"""Benchmark report block: a copy of ``singlespmv_tpu/harness/report.py``'s
``format_block``, ``parse_blocks``, ``to_jsonl``, ``FORMAT_NAMES`` (with
``hyb`` added) and ``get_basename`` (that package's ``harness/__init__``
imports jax, so it cannot be imported here).

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


def parse_blocks(text: str):
    """The ++++/---- delimited blocks of ``text`` as dicts of strings (the
    reference's log formatter, ``log/format.cpp:29-43``)."""
    blocks = []
    cur = None
    for line in text.splitlines():
        if line.strip() == OPEN:
            cur = {}
        elif line.strip() == CLOSE:
            if cur is not None:
                blocks.append(cur)
            cur = None
        elif cur is not None and line.strip():
            parts = line.split("\t", 1) if "\t" in line else line.split(None, 1)
            if len(parts) == 2:
                cur[parts[0].strip()] = parts[1].strip()
    return blocks


def to_jsonl(data: Dict[str, object]) -> str:
    """One JSON line of a report (keys sorted), the CLI's ``--jsonl``;
    numpy scalars become plain numbers."""
    return json.dumps(data, sort_keys=True,
                      default=lambda v: v.item() if hasattr(v, "item")
                      else str(v))
