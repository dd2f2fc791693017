// Stream-row machinery shared by the slab kernels (slab.cu) and the xch
// kernels (xch.cu).
//
// A stream row holds 128 slots.  A warp owns a whole row: lane k of the warp
// holds slots 4k..4k+3, so every stream load is one 4-byte (int8 x4) or
// 16-byte (float x4) access.  Per row:
//   gather   g[l] = x[(win[r] + sub[r,l]) * 128 + lane[r,l]]  (sub unread if
//            m == 1): the TPU's window copy plus m-way one-hot select become
//            one indexed load, served from L2 for the tables of the main path;
//   runs     W[l] = P[l] - P[hm1[r,l]], P the inclusive prefix of the row's
//            values (hm1 < 0: subtract nothing); at a run's end lane W is the
//            run's total.  The prefix is a serial sum of 4 plus a 5-step
//            shuffle scan, in place of the TPU's triangle matmul;
//   route    an end-lane e of plane j adds W[e] into a shared accumulator row
//            (route4), which a block then adds into global memory (flush).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;

// The four gathered values of stream row r held by the calling lane.
__device__ __forceinline__ float4 gather4(int r, int m,
                                          const int32_t* __restrict__ win,
                                          const int8_t* __restrict__ lane,
                                          const int8_t* __restrict__ sub,
                                          const float* __restrict__ x) {
  const int k = threadIdx.x & 31;
  const size_t off = (size_t)r * kLanes + 4 * k;
  const char4 ln = *reinterpret_cast<const char4*>(lane + off);
  const float* xw = x + (size_t)win[r] * kLanes;
  int c0 = ln.x, c1 = ln.y, c2 = ln.z, c3 = ln.w;
  if (m > 1) {
    const char4 sb = *reinterpret_cast<const char4*>(sub + off);
    c0 += sb.x * kLanes;
    c1 += sb.y * kLanes;
    c2 += sb.z * kLanes;
    c3 += sb.w * kLanes;
  }
  return make_float4(__ldg(xw + c0), __ldg(xw + c1), __ldg(xw + c2),
                     __ldg(xw + c3));
}

// Run totals of stream row r from the calling lane's four values a.  On
// return w[0..127] holds W of the row, visible to the whole warp.
__device__ __forceinline__ void run_totals(int r, float4 a,
                                           const int8_t* __restrict__ hm1,
                                           float* w) {
  const int k = threadIdx.x & 31;
  const char4 hd =
      *reinterpret_cast<const char4*>(hm1 + (size_t)r * kLanes + 4 * k);
  const float a1 = a.x + a.y;
  const float a2 = a1 + a.z;
  const float a3 = a2 + a.w;
  float incl = a3;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float up = __shfl_up_sync(kFull, incl, d);
    if (k >= d) incl += up;
  }
  float excl = __shfl_up_sync(kFull, incl, 1);
  if (k == 0) excl = 0.f;
  const float4 p = make_float4(excl + a.x, excl + a1, excl + a2, excl + a3);
  __syncwarp();  // the previous row's route has finished reading w
  reinterpret_cast<float4*>(w)[k] = p;
  __syncwarp();
  const float4 tot = make_float4(p.x - (hd.x >= 0 ? w[hd.x] : 0.f),
                                 p.y - (hd.y >= 0 ? w[hd.y] : 0.f),
                                 p.z - (hd.z >= 0 ? w[hd.z] : 0.f),
                                 p.w - (hd.w >= 0 ? w[hd.w] : 0.f));
  __syncwarp();
  reinterpret_cast<float4*>(w)[k] = tot;
  __syncwarp();
}

// acc[4k + i] += w[e_i] for the four end-lanes e of lane k (e < 0: none).
__device__ __forceinline__ void route4(const int8_t* __restrict__ e4,
                                       const float* w, float* acc_row) {
  const char4 e = *reinterpret_cast<const char4*>(e4);
  if (e.x >= 0) atomicAdd(acc_row + 0, w[e.x]);
  if (e.y >= 0) atomicAdd(acc_row + 1, w[e.y]);
  if (e.z >= 0) atomicAdd(acc_row + 2, w[e.z]);
  if (e.w >= 0) atomicAdd(acc_row + 3, w[e.w]);
}

// Adds the nonzero entries of acc[lo*128, (hi+1)*128) into out_block.
__device__ __forceinline__ void flush(const float* acc, int lo, int hi,
                                      float* __restrict__ out_block) {
  for (int i = lo * kLanes + threadIdx.x; i < (hi + 1) * kLanes;
       i += kThreads) {
    const float v = acc[i];
    if (v != 0.f) atomicAdd(out_block + i, v);
  }
}

// Rows per block: the largest power of two up to 32 that divides T.
int rows_per_block(int T) {
  int r = 32;
  while (T % r) r >>= 1;
  return r;
}

}  // namespace
