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
// blocks that no step visits unwritten; here the wrapper zeroes out and the
// steps add with atomics, the same function for non-decreasing uids (the
// probe's), with unvisited units 0.  Units outside [0, NU) are dropped.
//
// Design: slab_unit_kernel's (slab.cu): a block of 8 warps takes rpb rows of
// one step, a warp a row with the gather, prefix and route of
// stream_row.cuh; the (8, 128) step block collects in shared memory and goes
// to out with one global atomicAdd per nonzero entry.
//
// Bound.  Per slot the probe streams 4 B of val, 2-3 B of lane, sub and hm1
// (by stage) and S8 B of idx (route stages), x (1,700 x 128 floats, 0.9 MB)
// stays in L2: at the probe's 25,600 rows and S8 8, ~38 MB, ~11 us.  This
// first version aims to be right: no TMA, no software pipelining.

#include "stream_row.cuh"

namespace {

enum Stage { kAll = 0, kWindow = 1, kGather = 2, kSelect = 3, kPrefix = 4,
             kRoute = 5, kRouteOnly = 6 };
constexpr int kMaxS8 = 8;

__device__ __forceinline__ float pick8(const float* xw, int ln, int sb) {
  return (unsigned)sb < 8u ? __ldg(xw + sb * kLanes + ln) : 0.f;
}

__global__ void __launch_bounds__(kThreads) probe_slab_kernel(
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
  if (u < 0 || u >= NU) return;  // uniform over the block
  const bool routes = stage == kAll || stage == kRoute || stage == kRouteOnly;
  const bool totals = stage == kAll || stage == kPrefix || stage == kRoute;
  for (int i = threadIdx.x; i < kMaxS8 * kLanes; i += kThreads) acc[i] = 0.f;
  __syncthreads();
  for (int r = r0 + warp; r < r0 + rpb; r += kWarps) {
    const size_t off = (size_t)r * kLanes + 4 * k;
    float4 v = load4(val + off);
    if (stage <= kSelect) {  // the stages that gather and multiply
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
      __syncwarp();  // the previous row's route has finished reading wbuf
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
  } else {  // the row sum into all 8 rows of the block
    for (int i = threadIdx.x; i < kMaxS8 * kLanes; i += kThreads) {
      const float s = acc[i & (kLanes - 1)];
      if (s != 0.f) atomicAdd(ob + i, s);
    }
  }
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError().  Pointers
// are device pointers to contiguous arrays in the layout of ops/probes.py:
// uids (H / T,), base (H,) int32; lane, sub, hm1 (H, 128) int8; val
// (H, 128), x (CB, 128) float32; idx (S8, H, 128) int8; `out` (NU * 8, 128)
// float32 must be zeroed.
extern "C" int probe_slab_f32(const void* uids, const void* base,
                              const void* lane, const void* sub,
                              const void* val, const void* hm1,
                              const void* idx, const void* x, void* out,
                              int H, int T, int S8, int NU, int stage,
                              void* stream) {
  if (S8 < 1 || S8 > kMaxS8 || T < 1 || H < 0 || H % T || NU < 0 ||
      stage < kAll || stage > kRouteOnly)
    return (int)cudaErrorInvalidValue;
  if (H == 0) return 0;
  const int rpb = rows_per_block(T);
  probe_slab_kernel<<<H / rpb, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)uids, (const int32_t*)base, (const int8_t*)lane,
      (const int8_t*)sub, (const float*)val, (const int8_t*)hm1,
      (const int8_t*)idx, (const float*)x, (float*)out, H, T, rpb, S8, NU,
      stage);
  return (int)cudaGetLastError();
}
