// The staged slab-step probe for Hopper (sm_90a), bound through a plain C
// interface (ops/_build.py builds this file with ctypes, ops/probes.py
// calls it).
//
//   probe_slab_kernel replaces the kernel of make_call, the reference's
//     staged slab probe (scripts/probe_slab.py:28, pallas_call :116).
//
// Per stream row r of 128 slots l in step t = r / T, by stage:
//   multiply  all, select: g[l] = x[base[r] + sub[r,l], lane[r,l]] where
//             0 <= sub < 8, else 0 (the 8-row window, the lane gather and
//             the 8-way select); gather: x[base[r], lane[r,l]]; window:
//             x[base[r], l]; v = val * g.  prefix, route, routeonly: v = val;
//   totals    all, prefix, route: W = the run totals of v by hm1, as slab
//             takes them; else W = v;
//   route     all, route, routeonly: o[s, l] = sum over the step's rows of
//             W[r, idx[s,r,l]] (idx >= 0) for s < S8, rows S8..7 zero;
//             else every row of o is the sum of W over the step's rows;
//   out[uids[t]*8 + i, l] += o[i, l].
// The TPU kernel zeroes the unit's out block when uids changes and leaves
// blocks that no step visits unwritten; here the wrapper zeroes out, the
// same function for non-decreasing uids (the probe's), with unvisited units
// 0.  Units outside [0, NU) are dropped.
//
// Design (redesigned for Hopper): the lane-owned unit accumulators of
// unit_acc.cuh.  A block takes a chunk of R rows and walks it a segment
// (one unit's steps) at a time, a warp a row with the gather, prefix and
// route of stream_row.cuh; lane k keeps columns 4k..4k+3 of the S8 planes
// (of the column sum, in the stages that do not route) in registers, 64
// registers a thread so that 4 blocks share an SM.  At a segment's end the
// block sums its 8 warps' partials in shared memory (32 KB at S8 8) and
// adds each float4 of the unit's block into out once, by one reduction.
// The first port (a block rpb <= 32 rows of one step, shared float
// atomics, a global atomic an entry a block) is the "first port" variant
// of harness/route_ab.py.
//
// Bound.  Per slot the probe streams 4 B of val, 2-3 B of lane, sub and hm1
// (by stage) and S8 B of idx (route stages), x (1,700 x 128 floats, 0.9 MB)
// once, and writes out once: at the probe's 25,600 rows and S8 8, 51 MB, a
// bound of 15.2 us at 3.35 TB/s (chip_smoke.py's _bound).

#include "unit_acc.cuh"

namespace {

enum Stage { kAll = 0, kWindow = 1, kGather = 2, kSelect = 3, kPrefix = 4,
             kRoute = 5, kRouteOnly = 6 };
constexpr int kMaxS8 = 8;

__device__ __forceinline__ float pick8(const float* xw, int ln, int sb) {
  return (unsigned)sb < 8u ? __ldg(xw + sb * kLanes + ln) : 0.f;
}

// The stage is a template parameter, so that every load of a row issues
// before the first of them is used.  The route stages (all, route,
// routeonly) collect S8 planes; the others the column sum (one plane),
// broadcast into the 8 rows of the unit's block.  64 registers let 4
// blocks share an SM (80 and 3 at stage route, which would spill).
template <int kStage>
__global__ void __launch_bounds__(kThreads, kStage == kRoute ? 3 : 4)
    probe_slab_kernel(
    const int32_t* __restrict__ uids, const int32_t* __restrict__ base,
    const int8_t* __restrict__ lane, const int8_t* __restrict__ sub,
    const float* __restrict__ val, const int8_t* __restrict__ hm1,
    const int8_t* __restrict__ idx, const float* __restrict__ x,
    float* __restrict__ out, int H, int T, int R, int S8, int NU) {
  constexpr bool kRoutes =
      kStage == kAll || kStage == kRoute || kStage == kRouteOnly;
  constexpr bool kTotals =
      kStage == kAll || kStage == kPrefix || kStage == kRoute;
  constexpr int P = kRoutes ? kMaxS8 : 1;
  extern __shared__ float4 part4[];  // (kWarps, P, 128) partials
  float* part = reinterpret_cast<float*>(part4);
  __shared__ __align__(16) float wbuf[kWarps][kLanes];
  const int warp = threadIdx.x >> 5, k = threadIdx.x & 31;
  const int r0 = blockIdx.x * R;
  const int t1 = min(r0 + R, H) / T;
  LaneAcc<P> acc;
  acc.init(part);
  for (int t = r0 / T; t < t1;) {
    const int e = segment_end(uids, t, t1);
    const int u = __ldg(uids + t);
    if (u >= 0 && u < NU) {  // uniform over the block
      for (int r = t * T + warp; r < e * T; r += kWarps) {
        const size_t off = (size_t)r * kLanes + 4 * k;
        uint32_t ends[P];
#pragma unroll
        for (int s = 0; s < P; ++s)
          ends[s] = kRoutes && s < S8
                        ? load_ends(idx + ((size_t)s * H + r) * kLanes + 4 * k)
                        : kNoEnds;
        float4 v = load4(val + off);
        if constexpr (kStage <= kSelect) {  // gather and multiply
          const float* xw = x + (size_t)__ldg(base + r) * kLanes;
          float4 g;
          if constexpr (kStage == kWindow) {
            g = load4(xw + 4 * k);
          } else {
            const char4 ln = load_c4(lane + off);
            if constexpr (kStage == kGather) {
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
        if constexpr (kRoutes) {
          if constexpr (kTotals) {
            run_totals<float>(r, v, hm1, wbuf[warp]);
          } else {
            __syncwarp();  // the previous row's route has finished reading
            store4(wbuf[warp] + 4 * k, v);
            __syncwarp();
          }
#pragma unroll
          for (int s = 0; s < P; ++s)
            if (s < S8) acc.route(s, ends[s], wbuf[warp]);
        } else {
          if constexpr (kTotals)
            v = lane_totals<float>(v, load_c4(hm1 + off), wbuf[warp]);
          acc.add(0, v);
        }
      }
      acc.stage(kRoutes ? S8 : 1);
      float* ob = out + (size_t)u * kMaxS8 * kLanes;
      if constexpr (kRoutes) {
        reduce_unit<P>(part, S8 * kLanes / 4, [&](int i, float4 s) {
          red4(ob + 4 * i, s);
        });
      } else {  // the column sum into all 8 rows of the block
        reduce_unit<P>(part, kLanes / 4, [&](int i, float4 s) {
#pragma unroll
          for (int j = 0; j < kMaxS8; ++j)
            red4(ob + j * kLanes + 4 * i, s);
        });
      }
    }
    t = e;
  }
}

template <int kStage>
int launch(const void* uids, const void* base, const void* lane,
           const void* sub, const void* val, const void* hm1,
           const void* idx, const void* x, void* out, int H, int T, int S8,
           int NU, int R, cudaStream_t stream) {
  constexpr bool kRoutes =
      kStage == kAll || kStage == kRoute || kStage == kRouteOnly;
  static int allowed[kMaxUnitDevices] = {};
  const int smem = kWarps * (kRoutes ? kMaxS8 : 1) * kLanes * 4;
  const cudaError_t err = allow_unit_smem(
      (const void*)probe_slab_kernel<kStage>, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  probe_slab_kernel<kStage><<<(H + R - 1) / R, kThreads, smem, stream>>>(
      (const int32_t*)uids, (const int32_t*)base, (const int8_t*)lane,
      (const int8_t*)sub, (const float*)val, (const int8_t*)hm1,
      (const int8_t*)idx, (const float*)x, (float*)out, H, T, R, S8, NU);
  return (int)cudaGetLastError();
}

int launch_stage(const void* uids, const void* base, const void* lane,
                 const void* sub, const void* val, const void* hm1,
                 const void* idx, const void* x, void* out, int H, int T,
                 int S8, int NU, int stage, int R, cudaStream_t stream) {
#define PROBE_SLAB_STAGE(S)                                                  \
  case S:                                                                    \
    return launch<S>(uids, base, lane, sub, val, hm1, idx, x, out, H, T, S8, \
                     NU, R, stream);
  switch (stage) {
    PROBE_SLAB_STAGE(kAll)
    PROBE_SLAB_STAGE(kWindow)
    PROBE_SLAB_STAGE(kGather)
    PROBE_SLAB_STAGE(kSelect)
    PROBE_SLAB_STAGE(kPrefix)
    PROBE_SLAB_STAGE(kRoute)
    PROBE_SLAB_STAGE(kRouteOnly)
  }
#undef PROBE_SLAB_STAGE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError().  Pointers
// are device pointers to contiguous arrays in the layout of ops/probes.py:
// uids (H / T,) int32, non-decreasing; base (H,) int32; lane, sub, hm1
// (H, 128) int8; val (H, 128), x (CB, 128) float32; idx (S8, H, 128) int8;
// `out` (NU * 8, 128) float32 must be zeroed.  R is the chunk of rows a
// block takes, a multiple of T.
extern "C" int probe_slab_f32(const void* uids, const void* base,
                              const void* lane, const void* sub,
                              const void* val, const void* hm1,
                              const void* idx, const void* x, void* out,
                              int H, int T, int S8, int NU, int stage, int R,
                              void* stream) {
  if (S8 < 1 || S8 > kMaxS8 || T < 1 || H < 0 || H % T || NU < 0 ||
      stage < kAll || stage > kRouteOnly || R < T || R % T)
    return (int)cudaErrorInvalidValue;
  if (H == 0) return 0;
  return launch_stage(uids, base, lane, sub, val, hm1, idx, x, out, H, T, S8,
                      NU, stage, R, (cudaStream_t)stream);
}
