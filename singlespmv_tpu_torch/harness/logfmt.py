"""Log formatter: report blocks to a TSV table, a copy of
``singlespmv_tpu/harness/logfmt.py``.

singleSpMV pipes benchmark output through ``log/format``, which parses the
``++++``/``----`` delimited key-value blocks into rows (Matrix,
Architecture, MatrixFormat, GFLOPS, nRow, nCol, nNnz) sorted by nNnz
(``log/format.cpp:10-50``), and ``log/sum.sh`` totals GFLOPS.  The native
formatter (``core/native/logfmt_native.cpp``) gives the same table as the
Python one here, which stands in where it cannot be built.
"""
from __future__ import annotations

from typing import Iterable, List, Optional

from .report import parse_blocks

# column order of log/format.cpp's TSV output
DEFAULT_KEYS = ["Matrix", "Architecture", "MatrixFormat",
                "Performance(GFLOPS)", "nRow", "nCol", "nNnz"]


def format_logs(text: str, extra_keys: Optional[Iterable[str]] = None,
                use_native: bool = True) -> str:
    """The report blocks of ``text`` as a TSV table sorted by nNnz
    ascending, ``extra_keys`` as columns after the default ones."""
    if use_native:
        from ..core import native

        out = native.format_logs(text, list(extra_keys or []))
        if out is not None:
            return out
    keys = DEFAULT_KEYS + [k for k in (extra_keys or [])
                           if k not in DEFAULT_KEYS]
    blocks = parse_blocks(text)

    def nnz_of(b):
        try:
            return int(b.get("nNnz", 0))
        except ValueError:
            return 0

    blocks.sort(key=nnz_of)
    lines: List[str] = ["\t".join(keys)]
    for b in blocks:
        lines.append("\t".join(str(b.get(k, "")) for k in keys))
    return "\n".join(lines)


def sum_gflops(text: str) -> float:
    """Total Performance(GFLOPS) over all blocks (log/sum.sh)."""
    total = 0.0
    for b in parse_blocks(text):
        try:
            total += float(b.get("Performance(GFLOPS)", 0.0))
        except ValueError:
            pass
    return total
