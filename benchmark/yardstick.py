"""What the benchmark measures the program against, computed from the
matrix it made and never from a format's state: the bytes a product needs
at the least, the card's peaks, and the names of the program's own CUDA
kernels."""
from __future__ import annotations

import json
import os
import re

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
INDEX_BYTES = 4
VALUE_BYTES = {"float64": 8, "float32": 4, "bfloat16": 2}
GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\("
                    r"(?:[^()]|\([^()]*\))*\)\s*)?(\w+)\s*\(")


def csr_min_bytes(n_row: int, n_col: int, nnz: int, dtype: str,
                  columns: int = 1) -> int:
    """Bytes of one product Y = A X in CSR, each read or written once: a
    value and a 4-byte column a nonzero, n_row + 1 4-byte row offsets, X
    (n_col × B) and Y (n_row × B) at the value size."""
    v = VALUE_BYTES[dtype]
    return (nnz * (v + INDEX_BYTES) + (n_row + 1) * INDEX_BYTES
            + (n_col + n_row) * v * columns)


def peaks(device_name: str):
    """The published peaks of the card by its name, or None."""
    with open(os.path.join(BENCH_DIR, "peaks.json")) as f:
        return json.load(f).get(device_name)


def kernel_names(csrc_dir: str) -> frozenset:
    """Names of the ``__global__`` functions of every CUDA source in
    ``csrc_dir``, read as text."""
    names = set()
    for fn in sorted(os.listdir(csrc_dir)):
        if fn.endswith((".cu", ".cuh")):
            with open(os.path.join(csrc_dir, fn)) as f:
                names.update(GLOBAL.findall(f.read()))
    return frozenset(names)


def kernel_of(event_name: str) -> str:
    """The function name of a device event's demangled name:
    ``void (anonymous namespace)::xch_route4_rows_kernel<float>(...)``
    gives ``xch_route4_rows_kernel``."""
    head = op_name(event_name).split("<", 1)[0].strip()
    return head.rsplit(" ", 1)[-1].rsplit("::", 1)[-1]


def op_name(event_name: str) -> str:
    """A device event's name without its argument list."""
    return event_name.replace("(anonymous namespace)::", "").split(
        "(", 1)[0].strip()
