"""A/B of the bucket engine's spmv kernels on the card.

    python -m singlespmv_tpu_torch.harness.bucket_ab     # needs a GPU and nvcc

Builds ``csrc/bucket.cu`` as it is and the variants of ``VARIANTS``, each a
copy of ``csrc/`` with one change (text substitutions, as in
``slab_ab.py``), and times them in turns on the six bucket states of the
structure-matched stand-ins (seed 0) that ``chip_smoke.py`` checks (the
bkt_g states, 1024-row buckets, of g7jac200sc, lhr34, twotone, raefsky3
and thermomech_dK and the bkt state, 128-row buckets, of raefsky3) and on
the ellg states of raefsky3 and g7jac200sc.  Over two passes (the
variants in order, then reversed) it times, as device busy µs from
complete torch.profiler traces (``driver.busy_seconds``), one call of:

- the fused stage A + B ``bucket_fused_rows`` (the products made in
  registers): as built (the design ``route_rows`` chose), and each design
  on every state: (a) ``direct``, a warp a stream row and a reduction a
  run end; (b) ``merge``, blocks of a unit summing their rows in shared
  memory before one reduction a y row, at 1, 2, 4 and 16 rows a warp; (c)
  the direct kernel on fewer blocks, each warp taking 4 and 16 rows in
  turn, a grid's width of rows apart (the build's ``bucket_rows`` changes
  with it);
- the unfused pair it replaced, the first port: stage A
  ``block_gather_mul`` (the product grid in device memory), stage B
  ``bucket_rows`` reading it back (as built), each alone;
- the whole spmv, busy and on the device's clock (CUDA events, 20 calls,
  host gaps included), with the device operations (kernels, memsets,
  copies) a call makes;
- torch's ``A_csr @ x`` (cuSPARSE), once a pass;
- on the ellg states: ``ellg_rows`` (every pass in one launch) and the
  first port of the passes (stage A at gran 128 a pass, then the row sums
  and y-table adds in torch), and ellg's whole spmv.

Every variant computes the same function and is held to the plain version
within 1e-5·max|y|.  It prints the card's name and power limit, each
build's registers and shared memory for the bucket kernels (ptxas) and the
count of global reductions (``REDG``) and global atomics (``ATOMG``) in
their SASS, and each state's shape (units, stream rows a unit, K, slots,
run ends).
"""
from __future__ import annotations

import os
import re
import subprocess

import numpy as np
import torch

from .. import Config
from ..core.types import cdiv
from ..data import synthesize_structured
from ..formats import bkt, ellg
from ..ops import _build
from ..ops import bucket as bops
from .driver import busy_seconds
from .panel_ab import build_variant
from .slab_ab import device_ops
from .xch_ab import _cuda_ms, sass_counts

# the direct kernel's first row and its grid in csrc/bucket.cu
DIRECT_ROW = ("  const int r = blockIdx.x * kWarps + warp;\n"
              "  if (r >= H) return;  // uniform over the warp\n")
DIRECT_GRID = "const unsigned blocks = (unsigned)((H + kWarps - 1) / kWarps);"


def rows_a_warp(n: int) -> dict:
    """Design (c)'s substitutions: the direct kernel's body (a warp a
    stream row) made a loop in which each warp takes a row, then the row
    gridDim.x · 8 rows on, on 1/n of the blocks (n rows a warp)."""
    with open(os.path.join(_build.CSRC_DIR, "bucket.cu")) as f:
        src = f.read()
    body = src[src.index(DIRECT_ROW):]
    body = body[: body.index("\n}\n") + 1]
    rest = body[len(DIRECT_ROW):]
    loop = ("  for (int r = blockIdx.x * kWarps + warp; r < H;\n"
            "       r += gridDim.x * kWarps) {\n"
            + "".join("  " + ln + "\n" for ln in rest.splitlines())
            + "  }\n")
    return {body: loop,
            DIRECT_GRID: "const unsigned blocks = (unsigned)((H + kWarps * "
                         f"{n} - 1) / (kWarps * {n}));"}


VARIANTS = {
    "as built": {},
    "4 rows a warp": rows_a_warp(4),
    "16 rows a warp": rows_a_warp(16),
}
KERNELS = ("block_gather_mul_kernel", "bucket_rows_kernel",
           "bucket_rows_merge_kernel", "ellg_rows_kernel")
SASS = ("REDG", "ATOMG")
MATS = (("g7jac200sc", 1024), ("lhr34", 1024), ("twotone", 1024),
        ("raefsky3", 1024), ("thermomech_dK", 1024), ("raefsky3", 128))
ELLG_MATS = ("raefsky3", "g7jac200sc")
REPS = 20
TOL = 1e-5


def parts_for(g: int, rows_a_warp: int) -> int:
    """Blocks a unit of ``g`` stream rows so that each warp takes about
    ``rows_a_warp`` rows."""
    return max(1, cdiv(g, 8 * rows_a_warp))


def ptxas_usage(log: str, kernels=KERNELS) -> dict:
    """{kernel entry: (registers, shared bytes)} from nvcc's ptxas output,
    an entry named by its kernel and its template arguments' mangled
    letters."""
    out, current = {}, None
    for line in log.splitlines():
        if "Compiling entry" in line:
            name = re.search(r"'(\w+)'", line)
            k = next((k for k in kernels if k in line), None)
            current = None if k is None or not name else \
                k + name[1].split(k, 1)[1][:24]
        elif current and "registers" in line:
            smem = re.search(r"(\d+) bytes smem", line)
            out[current] = (int(re.search(r"(\d+) registers", line)[1]),
                            int(smem[1]) if smem else 0)
            current = None
    return out


def _csr(coo, dev):
    return torch.sparse_coo_tensor(
        torch.stack([torch.from_numpy(coo.row.astype(np.int64)),
                     torch.from_numpy(coo.col.astype(np.int64))]),
        torch.from_numpy(coo.val.astype(np.float32)),
        (coo.n_row, coo.n_col)).coalesce().to_sparse_csr().to(dev)


class Case:
    """One bucket state's inputs and the calls each variant times."""

    def __init__(self, label, coo, state, x):
        self.label, self.st, self.x = label, state, x
        st = state
        self.nu_pad, self.sh, self.g, self.h = bkt._unit_rows(st)
        self.a = (st.members, st.lane, st.src, st.val, bkt.x_table(st, x),
                  st.m)
        self.y = torch.zeros(st.n_row, dtype=torch.float32, device=x.device)
        self.a_csr = _csr(coo, x.device)
        self.want = self.fused(0, bops.bucket_fused_rows_ref).clone()
        self.designs = {
            "fused as built": ("as built", st.parts),
            "(a) fused direct": ("as built", 0),
            "(b) fused merge, 1 row a warp": ("as built",
                                              parts_for(self.g, 1)),
            "(b) fused merge, 2 rows a warp": ("as built",
                                               parts_for(self.g, 2)),
            "(b) fused merge, 4 rows a warp": ("as built",
                                               parts_for(self.g, 4)),
            "(b) fused merge, 16 rows a warp": ("as built",
                                                parts_for(self.g, 16)),
            "(c) fused direct, 4 rows a warp": ("4 rows a warp", 0),
            "(c) fused direct, 16 rows a warp": ("16 rows a warp", 0),
        }

    def fused(self, parts, fn=bops.bucket_fused_rows):
        st = self.st
        return fn(*self.a, st.hm1r, st.dest, st.yrow, self.y.zero_(),
                  self.sh, self.nu_pad, parts)

    def stage_a(self):
        return bops.block_gather_mul(*self.a)

    def pair(self):
        st = self.st
        return bops.bucket_rows(self.stage_a().view(self.h, 128), st.hm1r,
                                st.dest, st.yrow, self.y.zero_(), self.sh,
                                self.nu_pad, st.parts)


class EllgCase:
    """One ellg state's inputs: its passes and the zero-padded x."""

    def __init__(self, label, state, x):
        self.label, self.st, self.x = label, state, x
        self.table = ellg.row_passes(state.passes)
        self.xp = torch.zeros(cdiv(state.n_col, 128) * 128, device=x.device)
        self.xp[: state.n_col] = x
        self.y = torch.zeros(state.n_row, device=x.device)
        self.want = self.rows(bops.ellg_rows_ref).clone()

    def rows(self, fn=bops.ellg_rows):
        return fn(self.table, self.xp, self.y.zero_())

    def first_port(self):
        """Stage A at gran 128 a pass, the row sums and adds in torch."""
        return bops.ellg_rows_ref(self.table, self.xp, self.y.zero_(),
                                  stage_a=bops.block_gather_mul)


def _close(got, want, label):
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if err > TOL * scale:
        raise SystemExit(f"{label}: off the plain version by {err} "
                         f"(max |y| {scale})")


def _busy_us(fn, match="", launches=None) -> float:
    sec = busy_seconds(fn, match, REPS, launches,
                       log=lambda m: print(m, flush=True))
    return float("nan") if sec is None else sec * 1e6


def _whole(times, row, label, fn):
    times.setdefault((row + " busy", label), []).append(_busy_us(fn))
    times.setdefault((row + " wall", label), []).append(_cuda_ms(fn) * 1e3)
    times.setdefault((row + " device ops", label), []).append(device_ops(fn))


def run_variant(name, case, times):
    """Times and checks the variant's calls on one case; appends to
    ``times[(row, label)]``."""
    fused_launched = lambda: bops.bucket_fused_rows.launches  # noqa: E731
    rows = [(design, lambda p=p: case.fused(p))
            for design, (build, p) in case.designs.items() if build == name]
    for row, fn in rows:
        _close(fn(), case.want, f"{name} {case.label} {row}")
        times.setdefault((row, case.label), []).append(
            _busy_us(fn, "GatherProducts", fused_launched))
    if name != "as built":
        return
    _close(case.pair(), case.want, f"{case.label} pair")
    a = _busy_us(case.stage_a, "block_gather_mul_kernel",
                 lambda: bops.block_gather_mul.launches)
    prod = case.stage_a().view(case.h, 128)
    st = case.st

    def stage_b():
        return bops.bucket_rows(prod, st.hm1r, st.dest, st.yrow,
                                case.y.zero_(), case.sh, case.nu_pad,
                                st.parts)

    b = _busy_us(stage_b, "StreamProducts", lambda: bops.bucket_rows.launches)
    for row, t in (("pair: stage A", a), ("pair: stage B", b),
                   ("pair: A + B", a + b)):
        times.setdefault((row, case.label), []).append(t)
    _close(bkt.spmv(st, case.x), case.want, f"{case.label} spmv")
    _whole(times, "spmv", case.label, lambda: bkt.spmv(st, case.x))
    times.setdefault(("A_csr @ x (cuSPARSE) busy", case.label), []).append(
        _busy_us(lambda: case.a_csr @ case.x, "cusparse"))


def run_ellg(case, times):
    _close(case.rows(), case.want, f"{case.label} ellg_rows")
    _close(case.first_port(), case.want, f"{case.label} first port")
    times.setdefault(("ellg_rows", case.label), []).append(_busy_us(
        case.rows, "ellg_rows_kernel", lambda: bops.ellg_rows.launches))
    times.setdefault(("ellg passes, first port", case.label), []).append(
        _busy_us(case.first_port))
    _whole(times, "ellg spmv", case.label,
           lambda: ellg.spmv(case.st, case.x))


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("bucket_ab needs a CUDA device")
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    builds = {}
    for name, subs in VARIANTS.items():
        lib, _, _ = build_variant(name, subs, ("bucket.cu",), KERNELS)
        builds[name] = lib
        print(f"build {name!r}: registers, smem "
              f"{ptxas_usage(lib.ptxas_log)}; SASS "
              f"{sass_counts(lib._name, KERNELS, SASS)}", flush=True)
    cases, ellg_cases = [], []
    saved = _build._lib
    _build._lib = builds["as built"]
    try:
        mats = {}
        for name, rg in MATS:
            if name not in mats:
                mats[name] = synthesize_structured(name)
            coo = mats[name]
            st = bkt.convert(coo, Config(format="bkt", bkt_row_group=rg))
            x = torch.from_numpy(np.random.default_rng(0).uniform(
                -1, 1, coo.n_col).astype(np.float32)).to(dev)
            label = f"{name} {'bkt_g' if rg == 1024 else 'bkt'}"
            cases.append(Case(label, coo, st.to(dev), x))
            c = cases[-1]
            ends = int((c.st.dest >= 0).sum())
            print(f"{label}: units {c.nu_pad} stream rows a unit {c.g} "
                  f"K {st.k} m {st.m} slots {st.n_slots} run ends {ends} "
                  f"({ends / c.h:.1f} a row) balanced {st.balanced} "
                  f"(build, parts) of each design {c.designs}", flush=True)
        for name in ELLG_MATS:
            coo = mats[name]
            st = ellg.convert(coo, Config(format="ellg"))
            x = torch.from_numpy(np.random.default_rng(0).uniform(
                -1, 1, coo.n_col).astype(np.float32)).to(dev)
            ellg_cases.append(EllgCase(f"{name} ellg", st.to(dev), x))
            print(f"{name} ellg: passes "
                  f"{[(p.t, p.m, p.full, p.n_blocks) for p in st.passes]} "
                  f"rest {st.rest_fmt} {st.rest_nnz}", flush=True)
        times = {}
        for order in (list(VARIANTS), list(VARIANTS)[::-1]):
            for name in order:
                _build._lib = builds[name]
                for case in cases:
                    run_variant(name, case, times)
            _build._lib = builds["as built"]
            for case in ellg_cases:
                run_ellg(case, times)
    finally:
        _build._lib = saved
    labels = [c.label for c in cases + ellg_cases]
    print("busy µs (walls: µs on CUDA events; device ops a call), "
          "pass 1 / pass 2")
    print("row".ljust(34) + "".join(f"{lb:>24}" for lb in labels))
    for row in dict.fromkeys(r for r, _ in times):
        print(row.ljust(34) + "".join(
            f"{' / '.join(f'{t:.2f}' for t in times.get((row, lb), [])):>24}"
            for lb in labels), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
