"""A/B of the two unit route kernels redesigned for the card with
lane-owned accumulators (``csrc/unit_acc.cuh``): ``probe_slab_kernel``
(``csrc/probe_slab.cu``, ``ops.probes.slab_step``) and ``xch_route_kernel``
(``csrc/xch.cu``, ``ops.xch.xch_route``).

    python -m singlespmv_tpu_torch.harness.route_ab [variant ...]
                                          # needs a GPU and nvcc

Builds ``csrc/`` as it is and the build variants of ``BUILDS``, each a
copy of ``csrc/`` with text substitutions (``panel_ab.build_variant``, in
parallel): the first port's two kernels (a block of rpb <= 32 rows of one
step, a shared accumulator of float atomics, one global atomic an entry a
block), kept here as text; a plain store, in place of the reduction, of
each float4 of a segment that holds its whole unit; four scalar REDs in place of a float4 one; the partials in warp-private slices
of shared memory with plain adds in place of registers; the probe kernel
without its bound of 64 registers (4 blocks an SM), the route kernel with
one; thread block clusters of 2 and 4 blocks that sum their
blocks' partials over distributed shared memory.  The schedule variants of
``SCHEDULES`` run the build as it is at a forced chunk of R rows a block
(``probes.unit_rows``).  Cases: ``slab_step`` at the rows of
``probe_slab.ROWS`` that route (T 16, 32, 64 at S8 8, T 32 at S8 2) and
stage "route", on ``probe_slab.make_inputs``; ``xch_route`` on calibrate's
``_route_args`` at 16 and 8 planes and on the smoke's pruned case (m 8,
g_grp 2, pg 4, sg0/sg1 drawn per step).  Each variant is held to the plain
version within 1e-5·max|out| before it is timed; a time is the kernel's
busy µs per call from a complete torch.profiler trace
(``driver.busy_seconds``; the wrapper's memset of out apart), over two
passes (the variants in order, then reversed).  Beside them the bound
(each input read once, out written once, at 3.35 TB/s).  It prints the
card's name and power limit and, for each build's kernels, ptxas's
registers, spill bytes and static shared memory and the counts of
``ATOMS.CAST``, ``RED`` and ``ATOM`` instructions in the SASS.
"""
from __future__ import annotations

import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..ops import _build, probes
from ..ops import xch as xops
from . import calibrate
from . import probe_slab as pslab
from .panel_ab import build_variant
from .driver import busy_seconds

HBM_BPS = 3.35e12   # H100 SXM device memory, NVIDIA's data sheet
TOL = 1e-5
KERNELS = ("probe_slab", "xch_route_")

# the first port's probe kernel: a block rpb rows of one step, a shared
# (8, 128) accumulator of float atomics, one global atomic an entry a block
FIRST_PROBE = r"""
__global__ void __launch_bounds__(kThreads) probe_slab_first_kernel(
    const int32_t* __restrict__ uids, const int32_t* __restrict__ base,
    const int8_t* __restrict__ lane, const int8_t* __restrict__ sub,
    const float* __restrict__ val, const int8_t* __restrict__ hm1,
    const int8_t* __restrict__ idx, const float* __restrict__ x,
    float* __restrict__ out, int H, int T, int rpb, int S8, int NU,
    int stage) {
  __shared__ float acc[kMaxS8 * kLanes];
  __shared__ __align__(16) float wbuf[kWarps][kLanes];
  const int warp = threadIdx.x >> 5, k = threadIdx.x & 31;
  const int r0 = blockIdx.x * rpb;
  const int t = r0 / T;
  const int u = uids[t];
  if (u < 0 || u >= NU) return;
  const bool routes = stage == kAll || stage == kRoute || stage == kRouteOnly;
  const bool totals = stage == kAll || stage == kPrefix || stage == kRoute;
  for (int i = threadIdx.x; i < kMaxS8 * kLanes; i += kThreads) acc[i] = 0.f;
  __syncthreads();
  for (int r = r0 + warp; r < r0 + rpb; r += kWarps) {
    const size_t off = (size_t)r * kLanes + 4 * k;
    float4 v = load4(val + off);
    if (stage <= kSelect) {
      const float* xw = x + (size_t)base[r] * kLanes;
      float4 g;
      if (stage == kWindow) {
        g = load4(xw + 4 * k);
      } else {
        const char4 ln = load_c4(lane + off);
        if (stage == kGather) {
          g = make_float4(__ldg(xw + ln.x), __ldg(xw + ln.y),
                          __ldg(xw + ln.z), __ldg(xw + ln.w));
        } else {
          const char4 sb = load_c4(sub + off);
          g = make_float4(pick8(xw, ln.x, sb.x), pick8(xw, ln.y, sb.y),
                          pick8(xw, ln.z, sb.z), pick8(xw, ln.w, sb.w));
        }
      }
      v = mul4(v, g);
    }
    if (totals) {
      run_totals<float>(r, v, hm1, wbuf[warp]);
      if (!routes) v = load4(wbuf[warp] + 4 * k);
    } else if (routes) {
      __syncwarp();
      store4(wbuf[warp] + 4 * k, v);
      __syncwarp();
    }
    if (routes) {
      for (int s = 0; s < S8; ++s)
        route4(idx + ((size_t)s * H + r) * kLanes + 4 * k, wbuf[warp],
               acc + s * kLanes + 4 * k);
    } else {
      atomicAdd(acc + 4 * k + 0, v.x);
      atomicAdd(acc + 4 * k + 1, v.y);
      atomicAdd(acc + 4 * k + 2, v.z);
      atomicAdd(acc + 4 * k + 3, v.w);
    }
  }
  __syncthreads();
  float* ob = out + (size_t)u * kMaxS8 * kLanes;
  if (routes) {
    flush(acc, 0, S8 - 1, ob);
  } else {
    for (int i = threadIdx.x; i < kMaxS8 * kLanes; i += kThreads) {
      const float s = acc[i & (kLanes - 1)];
      if (s != 0.f) atomicAdd(ob + i, s);
    }
  }
}
"""
# the first port's v3 route: a block rpb rows of one step, a (planes, 128)
# accumulator of shared float atomics, one global atomic an entry a block
FIRST_ROUTE = r"""
__global__ void __launch_bounds__(kThreads) xch_route_first_kernel(
    const int32_t* __restrict__ uids, const int32_t* __restrict__ cs,
    const int32_t* __restrict__ sg0, const int32_t* __restrict__ sg1,
    const int32_t* __restrict__ win, const int8_t* __restrict__ lane,
    const int8_t* __restrict__ sub, const int8_t* __restrict__ hm1,
    const int8_t* __restrict__ idx, const float* __restrict__ prod,
    float* __restrict__ out, int H, int T, int rpb, int m, int planes,
    int pg, int p1, long long n_out) {
  extern __shared__ float acc[];
  __shared__ __align__(16) float wbuf[kWarps][kLanes];
  const int warp = threadIdx.x >> 5, k = threadIdx.x & 31;
  const int r0 = blockIdx.x * rpb;
  const int t = r0 / T;
  int lo = planes, hi = -1;
  for (int g0 = 0; g0 < planes; g0 += pg) {
    const int n_p = min(pg, planes - g0);
    if (sg0[t] < g0 + n_p && sg1[t] >= g0) {
      lo = min(lo, g0);
      hi = g0 + n_p - 1;
    }
  }
  const long long base = (long long)uids[t] * planes;
  const long long room = n_out - 1 - base;
  const int last = room < hi ? (int)room : hi;
  if (lo > hi || base < 0 || last < lo) return;
  for (int i = lo * kLanes + threadIdx.x; i < (hi + 1) * kLanes;
       i += kThreads)
    acc[i] = 0.f;
  __syncthreads();
  const float* x = prod + (size_t)cs[t] * p1 * kLanes;
  for (int r = r0 + warp; r < r0 + rpb; r += kWarps) {
    run_totals<float>(r, gather4<float>(r, m, win, lane, sub, x), hm1,
                      wbuf[warp]);
    for (int s = lo; s <= hi; ++s)
      route4(idx + ((size_t)s * H + r) * kLanes + 4 * k, wbuf[warp],
             acc + s * kLanes + 4 * k);
  }
  __syncthreads();
  flush(acc, lo, last, out + base * kLanes);
}
"""
PROBE_ENTRY = "  if (H == 0) return 0;\n  return launch_stage("
PROBE_KERNEL = "template <int kStage>\nint launch("
ROUTE_ENTRY = ("  const cudaStream_t st = (cudaStream_t)stream;\n"
               "  if (planes <= 8)")
ROUTE_KERNEL = "template <int G, typename S>\nint launch_route("
FIRST = {
    PROBE_KERNEL: FIRST_PROBE + "\n" + PROBE_KERNEL,
    PROBE_ENTRY: "  if (H == 0) return 0;\n  if (1) {\n    const int rpb = rows_per_block(T);\n"
                 "    probe_slab_first_kernel<<<H / rpb, kThreads, 0, "
                 "(cudaStream_t)stream>>>((const int32_t*)uids, (const "
                 "int32_t*)base, (const int8_t*)lane, (const int8_t*)sub, "
                 "(const float*)val, (const int8_t*)hm1, (const int8_t*)idx, "
                 "(const float*)x, (float*)out, H, T, rpb, S8, NU, stage);\n"
                 "    return (int)cudaGetLastError();\n  }\n" + PROBE_ENTRY,
    ROUTE_KERNEL: FIRST_ROUTE + "\n" + ROUTE_KERNEL,
    ROUTE_ENTRY: "  if (1) {\n    const int rpb = rows_per_block(T);\n"
                 "    xch_route_first_kernel<<<H / rpb, kThreads, (size_t)"
                 "planes * kLanes * 4, (cudaStream_t)stream>>>((const "
                 "int32_t*)uids, (const int32_t*)cs, (const int32_t*)sg0, "
                 "(const int32_t*)sg1, (const int32_t*)win, (const int8_t*)"
                 "lane, (const int8_t*)sub, (const int8_t*)hm1, (const "
                 "int8_t*)idx, (const float*)prod, (float*)out, H, T, rpb, m, "
                 "planes, pg, p1, (long long)n_out);\n"
                 "    return (int)cudaGetLastError();\n  }\n" + ROUTE_ENTRY,
}


# a thread block cluster of C blocks a chunk of C·R rows: its warps dealt
# the segment's rows in turn, each block summing a share of the entries
# over the blocks' partials in distributed shared memory, then one write
CLUSTER_HELPERS = r"""
}  // namespace

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kUnitCluster = %d;

__device__ __forceinline__ int2 cluster_place() {
  cg::cluster_group cluster = cg::this_cluster();
  return make_int2((int)cluster.block_rank(), (int)cluster.num_blocks());
}

template <typename... Params, typename... Args>
void launch_cluster(void (*kernel)(Params...), int H, int R, int smem,
                    cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((H + kUnitCluster * R - 1) /
                                (kUnitCluster * R) * kUnitCluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kUnitCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, kernel, ((Params)args)...);
}
"""
# a plain store, in place of a reduction, of each float4 of a segment that
# holds every step of its unit (the chunk's first and last segments check
# their unit against the neighbouring steps, loaded once a block)
PLAIN_STORES = {
    "constexpr uint32_t kNoEnds = 0xffffffffu;": r"""constexpr uint32_t kNoEnds = 0xffffffffu;

struct ChunkEdges {
  int t0, t1, prev, next;
  bool has_prev, has_next;

  __device__ __forceinline__ ChunkEdges(const int32_t* __restrict__ uids,
                                        int t0_, int t1_, int n_steps)
      : t0(t0_), t1(t1_), has_prev(t0_ > 0), has_next(t1_ < n_steps) {
    prev = has_prev ? __ldg(uids + t0 - 1) : 0;
    next = has_next ? __ldg(uids + t1) : 0;
  }

  __device__ __forceinline__ bool whole(int t, int e, int u) const {
    return (t > t0 || !has_prev || prev != u) &&
           (e < t1 || !has_next || next != u);
  }
};

__device__ __forceinline__ void put4(float* p, float4 v, bool whole) {
  if (whole)
    store4(p, v);
  else if (v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f)
    atomicAdd(reinterpret_cast<float4*>(p), v);
}""",
    "  const int t1 = min(r0 + R, H) / T;\n":
        "  const int t1 = min(r0 + R, H) / T;\n"
        "  const ChunkEdges edges(uids, r0 / T, t1, H / T);\n",
    "red4(ob + 4 * i, s);": "put4(ob + 4 * i, s, edges.whole(t, e, u));",
    "red4(ob + j * kLanes + 4 * i, s);":
        "put4(ob + j * kLanes + 4 * i, s, edges.whole(t, e, u));",
}
REDUCE = """template <int P, typename Put>
__device__ __forceinline__ void reduce_unit(float* part, int n4, Put put) {
  for (int i = threadIdx.x; i < n4; i += kThreads) put(i, warp_sum4<P>(part, i));
  __syncthreads();
}"""
CLUSTER_REDUCE = """template <int P, typename Put>
__device__ __forceinline__ void reduce_unit(float* part, int n4, Put put) {
  cg::cluster_group cluster = cg::this_cluster();
  for (int i = threadIdx.x; i < n4; i += kThreads)
    store4(part + 4 * i, warp_sum4<P>(part, i));  // into warp 0's slice
  cluster.sync();
  const int q = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  for (int i = rank * kThreads + threadIdx.x; i < n4; i += q * kThreads) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int b = 0; b < q; ++b) {
      const float4 v = load4(cluster.map_shared_rank(part, b) + 4 * i);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    put(i, s);
  }
  cluster.sync();
}"""


def _min_blocks(n: int) -> dict:
    """Substitutions that ask ptxas to fit ``n`` blocks of xch_route_kernel
    on an SM (registers capped at 65,536 / (256 n))."""
    return {"__launch_bounds__(kThreads) xch_route_kernel(":
            f"__launch_bounds__(kThreads, {n}) xch_route_kernel("}


def _cluster(c: int) -> dict:
    """Substitutions that make both unit kernels run as thread block
    clusters of ``c`` blocks."""
    return {
        "constexpr int kMaxUnitDevices = 64;":
            "constexpr int kMaxUnitDevices = 64;\n" + CLUSTER_HELPERS % c,
        REDUCE: CLUSTER_REDUCE,
        "  const int r0 = blockIdx.x * R;\n  const int t1 = min(r0 + R, H) / T;":
            "  const int2 place = cluster_place();\n"
            "  const int r0 = (blockIdx.x / place.y) * place.y * R;\n"
            "  const int t1 = min(r0 + place.y * R, H) / T;",
        "for (int r = t * T + warp; r < e * T; r += kWarps) {":
            "for (int r = t * T + place.x * kWarps + warp; r < e * T;\n"
            "           r += place.y * kWarps) {",
        "probe_slab_kernel<kStage><<<(H + R - 1) / R, kThreads, smem, "
        "stream>>>(": "launch_cluster(probe_slab_kernel<kStage>, H, R, smem, "
                     "stream, ",
        "xch_route_kernel<G, S><<<(H + R - 1) / R, kThreads, smem, "
        "stream>>>(":
            "launch_cluster(xch_route_kernel<G, S>, H, R, smem, stream, ",
    }


# the partials in the warp's slice of shared memory, added with plain
# loads and stores (a lane's columns are its own), in place of registers;
# the block's sum zeroes them for the next segment
SHARED_SLICES = {
    "  float4 a[P];\n": "",
    "#pragma unroll\n    for (int s = 0; s < P; ++s) a[s] = make_float4(0.f, "
    "0.f, 0.f, 0.f);":
        "#pragma unroll\n    for (int s = 0; s < P; ++s)\n      store4(slice + "
        "s * kLanes + 4 * (threadIdx.x & 31), make_float4(0.f, 0.f, 0.f, "
        "0.f));",
    "    a[s].x += v.x;\n    a[s].y += v.y;\n    a[s].z += v.z;\n"
    "    a[s].w += v.w;":
        "    float* p = slice + s * kLanes + 4 * (threadIdx.x & 31);\n"
        "    const float4 o = load4(p);\n"
        "    store4(p, make_float4(o.x + v.x, o.y + v.y, o.z + v.z, "
        "o.w + v.w));",
    "      if (s < n) store4(slice + s * kLanes + 4 * k, a[s]);\n"
    "      a[s] = make_float4(0.f, 0.f, 0.f, 0.f);\n": "",
    "__device__ __forceinline__ float4 warp_sum4(const float* part, int i) {":
        "__device__ __forceinline__ float4 warp_sum4(float* part, int i) {",
    "    const float4 v = load4(part + w * P * kLanes + 4 * i);":
        "    float* p = part + w * P * kLanes + 4 * i;\n"
        "    const float4 v = load4(p);\n"
        "    store4(p, make_float4(0.f, 0.f, 0.f, 0.f));",
}
# xch_route loading the end lanes of every plane of the group before its
# step's sg0/sg1 are known, and masking them by the active planes at use
EARLY_ENDS_OLD = r"""        if (act.y < p0 || act.x >= p0 + G) continue;  // uniform over the warp
        // every active plane's end lanes first: their loads overlap the
        // gather
        uint32_t ends[G];
#pragma unroll
        for (int s = 0; s < G; ++s)
          ends[s] = p0 + s >= act.x && p0 + s <= act.y
                        ? load_ends(idx + ((size_t)(p0 + s) * H + r) * kLanes +
                                    4 * k)
                        : kNoEnds;
        const S* x = prod + (size_t)__ldg(cs + st) * p1 * kLanes;
        run_totals<float>(r, gather4<S>(r, m, win, lane, sub, x), hm1,
                          wbuf[warp]);
#pragma unroll
        for (int s = 0; s < G; ++s) acc.route(s, ends[s], wbuf[warp]);"""
EARLY_ENDS_NEW = r"""        uint32_t ends[G];
#pragma unroll
        for (int s = 0; s < G; ++s)
          ends[s] = p0 + s < planes
                        ? load_ends(idx + ((size_t)(p0 + s) * H + r) * kLanes +
                                    4 * k)
                        : kNoEnds;
        if (act.y < p0 || act.x >= p0 + G) continue;
        const S* x = prod + (size_t)__ldg(cs + st) * p1 * kLanes;
        run_totals<float>(r, gather4<S>(r, m, win, lane, sub, x), hm1,
                          wbuf[warp]);
#pragma unroll
        for (int s = 0; s < G; ++s)
          if (p0 + s >= act.x && p0 + s <= act.y)
            acc.route(s, ends[s], wbuf[warp]);"""
BUILDS = {   # name → substitutions in csrc/
    "as built": {},
    "first port": FIRST,
    "plain stores for whole units": PLAIN_STORES,
    "warp-private shared slices": SHARED_SLICES,
    "scalar REDs": {"    atomicAdd(reinterpret_cast<float4*>(p), v);  "
                    "// result unused: RED":
                    "    for (int j = 0; j < 4; ++j)\n"
                    "      if ((&v.x)[j] != 0.f) atomicAdd(p + j, (&v.x)[j]);"},
    "xch_route end lanes of every plane, masked at use": {
        EARLY_ENDS_OLD: EARLY_ENDS_NEW},
    "cluster of 2": _cluster(2),
    "cluster of 4": _cluster(4),
    "probe_slab with no occupancy bound": {
        "__launch_bounds__(kThreads, kStage == kRoute ? 3 : 4)":
            "__launch_bounds__(kThreads)"},
    "xch_route asked for 4 blocks an SM": _min_blocks(4),
}
# name → R, the rows a block takes (rounded up to a multiple of T), on the
# build as it is
SCHEDULES = {f"R {r}": r for r in (32, 64, 128, 256, 512)}
VARIANTS = list(BUILDS) + list(SCHEDULES)


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def cases(dev) -> list:
    """(label, match, call, plain call, bound µs) of every timed case."""
    out = []
    for T, s8, stage in [r for r in pslab.ROWS if r[2] in probes.ROUTE_STAGES
                         ] + [(32, 8, "route")]:
        n_steps = 3200 // (T // 8)
        a = [torch.from_numpy(v).to(dev) for v in pslab.make_inputs(
            np.random.default_rng(7), n_steps, T, s8, pslab.CB, pslab.NU)]
        uids, base, lane, sub, val, hm1, idx, x = a
        nbytes = _nbytes(uids, base, val, x, idx) + pslab.NU * 8 * 512
        nbytes += _nbytes(hm1) if stage in probes.TOTALS_STAGES else 0
        nbytes += _nbytes(lane, sub) if stage == "all" else 0
        out.append((f"probe_slab T {T} S8 {s8} {stage}", "probe_slab",
                    lambda a=a, T=T, st=stage: probes.slab_step(
                        *a, pslab.NU, T, st),
                    lambda a=a, T=T, st=stage: probes.slab_step_ref(
                        *a, pslab.NU, T, st),
                    nbytes / HBM_BPS * 1e6))
    rng = np.random.default_rng(0)
    for planes in (16, 8, "pruned"):
        if planes == "pruned":
            a, _ = calibrate._route_args(rng, 16 * 1024, 16, 8, 64,
                                         device=dev)
            a[1] = (a[0] // 2).contiguous()
            n = a[0].shape[0]
            a[3] = torch.from_numpy(rng.integers(-2, 18, n).astype(
                np.int32)).to(dev)
            a[4] = torch.from_numpy(rng.integers(-2, 18, n).astype(
                np.int32)).to(dev)
            args = (int(a[1][-1]) + 1, 8, 16, 64, 2, 4)
        else:
            a, ngb = calibrate._route_args(rng, 16 * 1024, planes, 1, 64,
                                           device=dev)
            args = (ngb, 1, planes, 64, 16, 8)
        ngb, m, p, T, g_grp, pg = args
        uids, _, cs, sg0, sg1, win, lane, sub, hm1, idx, prod3 = a
        act = xops._active_planes(sg0, sg1, p, pg)
        nbytes = (_nbytes(uids, cs, sg0, sg1, win, lane, hm1, prod3)
                  + int(act.sum()) * T * 128 + ngb * g_grp * p * 512
                  + (_nbytes(sub) if m > 1 else 0))
        out.append((f"xch_route planes {planes}", "xch_route_",
                    lambda a=a, args=args: xops.xch_route(*a, *args),
                    lambda a=a, args=args: xops.xch_route_ref(*a, *args),
                    nbytes / HBM_BPS * 1e6))
    return out


def facts(lib, match: str) -> dict:
    """{kernel: (registers, spill store bytes, spill load bytes, static
    shared bytes, ATOMS.CAST, RED, ATOM)} of ``lib``'s kernels whose mangled
    names hold ``match``, from ptxas's log and the SASS (cuobjdump), each
    named as cu++filt demangles it, template arguments kept."""
    found, current = {}, None
    for line in lib.ptxas_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            current = m.group(1) if match in m.group(1) else None
            if current:
                found[current] = [0, 0, 0, 0, 0, 0, 0]
            continue
        sp = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                       line)
        if current and sp:
            found[current][1:3] = int(sp.group(1)), int(sp.group(2))
        used = re.search(r"Used (\d+) registers", line)
        if current and used:
            smem = re.search(r"(\d+) bytes smem", line)
            found[current][0] = int(used.group(1))
            found[current][3] = int(smem.group(1)) if smem else 0
            current = None
    for line in lib.sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            current = m.group(1) if m.group(1) in found else None
            continue
        op = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                       line)
        if current and op:
            name = op.group(1)
            slot = (4 if name.startswith("ATOMS.CAST") else
                    5 if name.startswith("RED") else
                    6 if name.startswith(("ATOMG", "ATOM.")) else None)
            if slot:
                found[current][slot] += 1
    names = list(found)
    filt = os.path.join(os.path.dirname(_build.nvcc()), "cu++filt")
    if names and os.path.exists(filt):
        shown = subprocess.run([filt, *names], capture_output=True,
                               text=True).stdout.splitlines()
        if len(shown) == len(names):
            names = [re.sub(r"^void |\(anonymous namespace\)::", "", n)
                     for n in shown]
            names = [n[:n.index(">(") + 1] if ">(" in n else n.split("(")[0]
                     for n in names]
    return dict(zip(names, map(tuple, found.values())))


def _busy_us(fn, match: str) -> float:
    sec = busy_seconds(fn, match, log=lambda m: print(m, flush=True))
    return float("nan") if sec is None else sec * 1e6


def _build_one(item):
    name, subs = item
    try:
        return name, build_variant(name, subs,
                                   sources=("probe_slab.cu", "xch.cu"),
                                   kernels=KERNELS)
    except _build.KernelError as e:
        return name, e


def main(argv=None) -> int:
    """Runs "as built" and the variants named in ``argv`` (all without)."""
    names = (sys.argv[1:] if argv is None else argv) or VARIANTS
    unknown = set(names) - set(VARIANTS)
    if unknown:
        raise SystemExit(f"no such variants: {sorted(unknown)}")
    if not torch.cuda.is_available():
        raise SystemExit("route_ab needs a CUDA device")
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    wanted = [(n, s) for n, s in BUILDS.items()
              if n == "as built" or n in names]
    with ThreadPoolExecutor(4) as pool:
        built = list(pool.map(_build_one, wanted))
    builds = {}
    for name, res in built:
        if isinstance(res, Exception):
            if name == "as built":
                raise res
            print(f"build {name!r} failed, left out:\n{res}", flush=True)
            continue
        builds[name] = res[0]
        for match in KERNELS:
            for kern, f in facts(res[0], match).items():
                print(f"build {name!r} {kern}: {f[0]} registers, spills "
                      f"{f[1]} B stored / {f[2]} B loaded, {f[3]} B static "
                      f"shared, ATOMS.CAST {f[4]}, RED {f[5]}, ATOM {f[6]}",
                      flush=True)
    runs = [(n, n, None) for n in builds] + [
        (n, "as built", SCHEDULES[n]) for n in names if n in SCHEDULES]
    todo = cases(dev)
    wants = {label: ref() for label, _, _, ref, _ in todo}
    times = {}
    saved, rows = _build._lib, probes.unit_rows
    try:
        for order in (runs, runs[::-1]):
            for name, lib, sched in order:
                _build._lib = builds[lib]
                for label, match, call, _, _ in todo:
                    T = int(re.search(r"T (\d+)", label).group(1)) \
                        if "T " in label else 64
                    probes.unit_rows = rows if sched is None else (
                        lambda h, t, d, R=-(-sched // T) * T: R)
                    got, want = call(), wants[label]
                    torch.cuda.synchronize()
                    err = float((got - want).abs().max())
                    if err > TOL * float(want.abs().max()):
                        raise SystemExit(f"{name} {label}: off the plain "
                                         f"version by {err}")
                    times.setdefault((name, label), []).append(
                        _busy_us(call, match))
    finally:
        _build._lib, probes.unit_rows = saved, rows
    print("busy µs, pass 1 / pass 2, by case", flush=True)
    for label, _, _, _, bound in todo:
        print(f"{label}: bound {bound:.2f}")
        for name, _, _ in runs:
            if (name, label) in times:
                print(f"  {name}: " + " / ".join(
                    f"{t:.2f}" for t in times[(name, label)]), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
