"""A/B of bkt's stage B on the card.

    python -m singlespmv_tpu_torch.harness.bucket_ab     # needs a GPU and nvcc

Builds ``csrc/bucket.cu`` as it is and the variants of ``VARIANTS``, each a
copy of ``csrc/`` with one change (text substitutions, as in
``slab_ab.py``), and times them in turns on the six bucket states of the
structure-matched stand-ins (seed 0) that ``chip_smoke.py`` checks: the
bkt_g states (1024-row buckets) of g7jac200sc, lhr34, twotone, raefsky3 and
thermomech_dK and the bkt state (128-row buckets) of raefsky3.  Over two
passes (the variants in order, then reversed) it times, as device busy µs
from complete torch.profiler traces (``driver.busy_seconds``), one call of:

- stage B: ``bucket_rows`` as built (the design ``route_rows`` chose), and
  each design on every state: (a) ``direct``, a warp a stream row and a
  reduction a run end; (b) ``merge``, blocks of a unit summing their rows
  in shared memory before one reduction a y row, at 4 and at 16 rows a
  warp; (c) ``cluster`` (the merge kernel made deterministic: the blocks
  of a unit form one thread block cluster, of 8 and of 4 blocks, that sums
  their partials over distributed shared memory in rank order and adds
  each y row once, no atomics; y must repeat bitwise); (d) ``two rows in
  flight`` (the direct kernel, a warp loading two rows before the first
  one's prefix); (e) ``int32 dest`` (the direct kernel on absolute int32 y
  rows, yrow unread); (f) ``first port``, ``bucket_reduce`` or
  ``bucket_reduce_grouped`` on the idx planes;
- the whole spmv: as built, and ``as before`` (the first port's stage B
  and its glue: the relayout of the products, the transposed zeroed row
  table, ``lane_unpermute``, the copy back), busy and on the device's clock
  (CUDA events, 20 calls, host gaps included), with the device operations
  (kernels, memsets, copies) a call makes;
- torch's ``A_csr @ x`` (cuSPARSE), once a pass.

Every variant computes the same function and is held to the plain version
within 1e-5·max|y|.  It prints the
card's name and power limit, each build's registers and shared memory for
the stage-B kernels (ptxas) and the count of global reductions (``REDG``),
global atomics (``ATOMG``) and shared-memory compare-and-swap loops
(``ATOMS.CAST``) in their SASS, and each state's shape (units, stream rows
a unit, K, slots, run ends).
"""
from __future__ import annotations

import ctypes
import re
import subprocess

import numpy as np
import torch

from .. import Config
from ..core.types import cdiv
from ..data import synthesize_structured
from ..formats import bkt
from ..ops import _build
from ..ops import bucket as bops
from .driver import busy_seconds
from .panel_ab import build_variant
from .slab_ab import device_ops
from .xch_ab import _cuda_ms, sass_counts

# (c): the merge kernel's flush becomes a cluster sum in rank order, and
# its launch a cluster launch of the unit's `parts` blocks
CLUSTER = {
    '#include "stream_row.cuh"\n\nnamespace {\n\nconstexpr int kSigmas':
        '#include <cooperative_groups.h>\n\n#include "stream_row.cuh"\n\n'
        'namespace cg = cooperative_groups;\n\nnamespace {\n\n'
        'constexpr int kSigmas',
    """    const int pos = __ldg(yr + i);
    if (s != 0.f && pos >= 0 && pos < n_y) atomicAdd(y + pos, s);  // RED.ADD
  }
}""": """    acc[0][i] = s;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  for (int i = part + parts * threadIdx.x; i < RG; i += parts * kThreads) {
    float t = 0.f;
    for (int q = 0; q < parts; ++q)
      t += cluster.map_shared_rank(&acc[0][0], q)[i];
    const int pos = __ldg(yr + i);
    if (pos >= 0 && pos < n_y) y[pos] += t;
  }
  cluster.sync();
}""",
    """  bucket_rows_merge_kernel<D, RG><<<(unsigned)nu_pad * parts, kThreads, 0,
                                    stream>>>(
      (const float*)prod, (const int8_t*)hm1r, (const D*)dest,
      (const int32_t*)yrow, (float*)y, G, sh, nu_pad, parts, n_y);
  return (int)cudaGetLastError();""": """  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)nu_pad * parts);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = parts;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(
      &cfg, bucket_rows_merge_kernel<D, RG>, (const float*)prod,
      (const int8_t*)hm1r, (const D*)dest, (const int32_t*)yrow, (float*)y,
      G, sh, nu_pad, parts, n_y);
  return rc != cudaSuccess ? (int)rc : (int)cudaGetLastError();""",
}
VARIANTS = {
    "as built": {},
    "cluster": CLUSTER,
    "two rows in flight": {"constexpr int kRowsAWarp = 1;":
                           "constexpr int kRowsAWarp = 2;"},
    "int32 dest": {"using GroupDest = int16_t;": "using GroupDest = int32_t;",
                   "using BlockDest = int8_t;": "using BlockDest = int32_t;"},
}
KERNELS = ("bucket_rows_kernel", "bucket_rows_merge_kernelIaLi128E",
           "bucket_rows_merge_kernelIsLi1024E", "bucket_reduce_kernel",
           "bucket_reduce_grouped_kernel")
SASS = ("REDG", "ATOMG", "ATOMS.CAST")
MATS = (("g7jac200sc", 1024), ("lhr34", 1024), ("twotone", 1024),
        ("raefsky3", 1024), ("thermomech_dK", 1024), ("raefsky3", 128))
REPS = 20
TOL = 1e-5


def parts_for(g: int, rows_a_warp: int, cap: int = 0) -> int:
    """Blocks a unit of ``g`` stream rows so that each warp takes about
    ``rows_a_warp`` rows, at most ``cap`` (0: no cap)."""
    p = max(1, cdiv(g, 8 * rows_a_warp))
    return min(p, cap) if cap else p


def spmv_before(state, x):
    """The first port's spmv: stage A, the relayout of the products, the
    idx-plane stage B into a row table, and where balanced the transposed
    zeroed table, ``lane_unpermute`` and the copy back."""
    nu_pad = state.rb_pad // (state.row_group // 128)
    prod = bops.block_gather_mul(state.members, state.lane, state.src,
                                 state.val, bkt.x_table(state, x), state.m)
    if state.row_group == 1024:
        y_tab = bops.bucket_reduce_grouped(bkt.stage_b_input(state, prod),
                                           state.hm1, state.idx, nu_pad,
                                           state.n_chunks)
    else:
        y_tab = bops.bucket_reduce(bkt.stage_b_input(state, prod), state.hm1,
                                   state.idx, nu_pad)
    if state.balanced:
        y_tab = bops.lane_unpermute(bkt.y_table_t(state, y_tab),
                                    state.src_lane, state.src_chunk
                                    )[:, : state.rb_pad].T
    return y_tab.reshape(-1)[: state.n_row]


def ptxas_usage(log: str, kernels=KERNELS) -> dict:
    """{kernel: (registers, shared bytes)} from nvcc's ptxas output."""
    out, current = {}, None
    for line in log.splitlines():
        if "Compiling entry" in line:
            current = next((k for k in kernels if k in line), None)
            if current and "bucket_rows_kernel" in line:
                current += re.search(r"bucket_rows_kernelI(\w)", line)[1]
        elif current and "registers" in line:
            smem = re.search(r"(\d+) bytes smem", line)
            out[current] = (int(re.search(r"(\d+) registers", line)[1]),
                            int(smem[1]) if smem else 0)
            current = None
    return out


class Case:
    """One state's inputs and the calls each variant times."""

    def __init__(self, label, coo, state, x):
        self.label, self.st, self.x = label, state, x
        st = state
        self.nu_pad, self.sh, self.g, self.h = bkt._unit_rows(st)
        self.prod = bops.block_gather_mul(
            st.members, st.lane, st.src, st.val, bkt.x_table(st, x),
            st.m).view(self.h, 128)
        self.y = torch.zeros(st.n_row, dtype=torch.float32, device=x.device)
        unit = (torch.arange(self.h, device=x.device) // self.sh) \
            % self.nu_pad
        d = st.dest.long()
        rg = st.row_group
        pos = st.yrow.long()[unit[:, None] * rg + d.clamp(min=0)]
        self.d32 = torch.where(d >= 0, pos, -1).int().contiguous()
        self.a_csr = torch.sparse_coo_tensor(
            torch.stack([torch.from_numpy(coo.row.astype(np.int64)),
                         torch.from_numpy(coo.col.astype(np.int64))]),
            torch.from_numpy(coo.val.astype(np.float32)),
            (coo.n_row, coo.n_col)).coalesce().to_sparse_csr().to(x.device)
        self.want = self.rows(0, bops.bucket_rows_ref).clone()
        # parts a unit of each design; the cluster build's merge launches
        # are cluster launches
        self.designs = {
            "as built": ("as built", st.parts),
            "(a) direct": ("as built", 0),
            "(b) merge, 4 rows a warp": ("as built", parts_for(self.g, 4)),
            "(b) merge, 16 rows a warp": ("as built", parts_for(self.g, 16)),
            "(c) cluster of 8": ("cluster", parts_for(self.g, 4, 8)),
            "(c) cluster of 4": ("cluster", parts_for(self.g, 4, 4)),
            "(d) two rows in flight": ("two rows in flight", 0),
        }

    def rows(self, parts, fn=bops.bucket_rows):
        st, y = self.st, self.y
        y.zero_()
        return fn(self.prod, st.hm1r, st.dest, st.yrow, y, self.sh,
                  self.nu_pad, parts)

    def rows32(self):
        """The C entry on absolute int32 y rows (the ``int32 dest``
        build), past the wrapper's dest-type check."""
        st, y = self.st, self.y
        y.zero_()
        rc = _build.load().bucket_rows_f32(
            *(ctypes.c_void_p(t.data_ptr()) for t in (
                self.prod, st.hm1r, self.d32, st.yrow, y)),
            self.h, self.sh, self.nu_pad, st.row_group, y.numel(), 0,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if rc:
            raise _build.KernelError(f"int32 dest bucket_rows: cudaError {rc}")
        return y

    def first_port(self):
        st, nu_pad = self.st, self.nu_pad
        b_in = bkt.stage_b_input(st, self.prod)
        if st.row_group == 1024:
            return bops.bucket_reduce_grouped(b_in, st.hm1, st.idx, nu_pad,
                                              st.n_chunks)
        return bops.bucket_reduce(b_in, st.hm1, st.idx, nu_pad)


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


def run_variant(name, case, times):
    """Times and checks the variant's calls on one case; appends to
    ``times[(row, label)]``."""
    rows_launched = lambda: bops.bucket_rows.launches   # noqa: E731
    rows = [(design, lambda p=p: case.rows(p))
            for design, (build, p) in case.designs.items() if build == name]
    for row, fn in rows:
        _close(fn(), case.want, f"{name} {case.label} {row}")
        times.setdefault((row, case.label), []).append(
            _busy_us(fn, "bucket_rows", rows_launched))
        if "cluster" in row:
            a, b = fn().clone(), fn().clone()
            if not torch.equal(a, b):
                raise SystemExit(f"{case.label} {row}: y did not repeat "
                                 "bitwise")
    if name == "int32 dest":
        _close(case.rows32(), case.want, f"{case.label} int32 dest")
        times.setdefault(("(e) int32 dest", case.label), []).append(
            _busy_us(case.rows32, "bucket_rows"))
    if name != "as built":
        return
    first = ((bops.bucket_reduce_grouped if case.st.row_group == 1024
              else bops.bucket_reduce),)
    times.setdefault(("(f) first port (idx planes)", case.label),
                     []).append(_busy_us(
                         case.first_port, "bucket_reduce",
                         lambda: sum(w.launches for w in first)))
    st, x = case.st, case.x
    for row, fn in (("spmv as built", lambda: bkt.spmv(st, x)),
                    ("spmv as before", lambda: spmv_before(st, x))):
        _close(fn(), case.want, f"{case.label} {row}")
        times.setdefault((row + " busy", case.label), []).append(
            _busy_us(fn))
        times.setdefault((row + " wall", case.label), []).append(
            _cuda_ms(fn) * 1e3)
        times.setdefault((row + " device ops", case.label), []).append(
            device_ops(fn))
    times.setdefault(("A_csr @ x (cuSPARSE) busy", case.label), []).append(
        _busy_us(lambda: case.a_csr @ case.x, "cusparse"))


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
    cases = []
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
        times = {}
        for order in (list(VARIANTS), list(VARIANTS)[::-1]):
            for name in order:
                _build._lib = builds[name]
                for case in cases:
                    run_variant(name, case, times)
    finally:
        _build._lib = saved
    labels = [c.label for c in cases]
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
