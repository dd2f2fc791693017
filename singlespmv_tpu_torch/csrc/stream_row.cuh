// Stream-row machinery shared by the slab kernels (slab.cu) and the xch
// kernels (xch.cu), for storage type S = float, double or __nv_bfloat16 and
// its accumulator type A = acc_t<S>: float for bfloat16, S itself otherwise.
// Values and x are read as S (a bfloat16 stream stays 2 bytes a slot in
// device memory) and widened on load (load4, gather4 return V4<S>, four
// values of A); every product, prefix and total is taken in A.
//
// A stream row holds 128 slots.  A warp owns a whole row: lane k of the warp
// holds slots 4k..4k+3, so every stream load is one 4-byte (int8 x4) access
// and, for values, one 16-byte (float x4) or two 16-byte (double x2) ones.
// Per row:
//   gather   g[l] = x[(win[r] + sub[r,l]) * 128 + lane[r,l]]  (sub unread if
//            m == 1): the TPU's window copy plus m-way one-hot select become
//            one indexed load, served from L2 for the tables of the main path;
//   runs     W[l] = P[l] - P[hm1[r,l]], P the inclusive prefix of the row's
//            values (hm1 < 0: subtract nothing); at a run's end lane W is the
//            run's total.  The prefix is a serial sum of 4 plus a 5-step
//            shuffle scan, in place of the TPU's triangle matmul;
//   route    an end-lane e of plane j adds W[e] into a shared accumulator row
//            (route4), which a block then adds into global memory (flush);
//            or, in the spmv routes of xch.cu and slab.cu, the lane holding
//            end slot e adds W[e] straight into y at its destination
//            (lane_totals, load_dest4).
// At double the same code runs on native fp64: fp64 shuffles and atomicAdd
// on double in shared and global memory, where the TPU needed (hi, lo) float
// planes and compensated sums.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;
// Four consecutive values of a stream row, held by one lane: float4 in
// float, a plain struct of four in double.
struct Double4 {
  double x, y, z, w;
};

using bf16 = __nv_bfloat16;

// The accumulator type of storage type S.
template <typename S>
struct AccOf {
  using type = S;
};

template <>
struct AccOf<bf16> {
  using type = float;
};

template <typename S>
using acc_t = typename AccOf<S>::type;

// Four values of storage type S, widened to its accumulator type.
template <typename V>
struct Vec4Of;

template <>
struct Vec4Of<float> {
  using type = float4;
};

template <>
struct Vec4Of<double> {
  using type = Double4;
};

template <>
struct Vec4Of<bf16> {
  using type = float4;
};

template <typename V>
using V4 = typename Vec4Of<V>::type;

// bfloat16 bits b (in the low 16 of u) as the float they stand for: exact.
__device__ __forceinline__ float bf16_bits(unsigned u) {
  return __uint_as_float(u << 16);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Four bfloat16 values in one 8-byte load, widened to float.
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(bf16_bits(u.x & 0xffffu), bf16_bits(u.x >> 16),
                     bf16_bits(u.y & 0xffffu), bf16_bits(u.y >> 16));
}

__device__ __forceinline__ Double4 load4(const double* p) {
  const double2 a = reinterpret_cast<const double2*>(p)[0];
  const double2 b = reinterpret_cast<const double2*>(p)[1];
  return {a.x, a.y, b.x, b.y};
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(double* p, Double4 v) {
  reinterpret_cast<double2*>(p)[0] = make_double2(v.x, v.y);
  reinterpret_cast<double2*>(p)[1] = make_double2(v.z, v.w);
}

// Four floats rounded to bfloat16 (to nearest, ties to even), one 8-byte
// store.
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const unsigned*>(&a),
                 *reinterpret_cast<const unsigned*>(&b));
}

// One value read through the read-only cache, widened to its accumulator.
__device__ __forceinline__ float ldg_acc(const float* p) { return __ldg(p); }

__device__ __forceinline__ double ldg_acc(const double* p) {
  return __ldg(p);
}

__device__ __forceinline__ float ldg_acc(const bf16* p) {
  return bf16_bits(__ldg(reinterpret_cast<const unsigned short*>(p)));
}

// One value widened to its accumulator (a plain load).
__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ double to_acc(double v) { return v; }
__device__ __forceinline__ float to_acc(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

__device__ __forceinline__ Double4 mul4(Double4 a, Double4 b) {
  return {a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w};
}

__device__ __forceinline__ char4 load_c4(const int8_t* p) {
  return *reinterpret_cast<const char4*>(p);
}

// The four values gathered for one lane from window xw = x + win[r] * 128,
// by the lane's four slot columns ln and, when m > 1, their blocks sb,
// widened to the accumulator type.
template <typename S>
__device__ __forceinline__ V4<S> gather4(const S* __restrict__ xw, char4 ln,
                                         char4 sb, int m) {
  int c0 = ln.x, c1 = ln.y, c2 = ln.z, c3 = ln.w;
  if (m > 1) {
    c0 += sb.x * kLanes;
    c1 += sb.y * kLanes;
    c2 += sb.z * kLanes;
    c3 += sb.w * kLanes;
  }
  return {ldg_acc(xw + c0), ldg_acc(xw + c1), ldg_acc(xw + c2),
          ldg_acc(xw + c3)};
}

// The four gathered values of stream row r held by the calling lane.
template <typename S>
__device__ __forceinline__ V4<S> gather4(int r, int m,
                                         const int32_t* __restrict__ win,
                                         const int8_t* __restrict__ lane,
                                         const int8_t* __restrict__ sub,
                                         const S* __restrict__ x) {
  const size_t off = (size_t)r * kLanes + 4 * (threadIdx.x & 31);
  const char4 sb = m > 1 ? load_c4(sub + off) : make_char4(0, 0, 0, 0);
  return gather4(x + (size_t)win[r] * kLanes, load_c4(lane + off), sb, m);
}

// W of the calling lane's four slots, from its four values a and head
// lanes hd (hm1 of its four slots); w[0..127] is the warp's scratch row and
// holds the row's inclusive prefix on return.
template <typename V>
__device__ __forceinline__ V4<V> lane_totals(V4<V> a, char4 hd, V* w) {
  const int k = threadIdx.x & 31;
  const V a1 = a.x + a.y;
  const V a2 = a1 + a.z;
  const V a3 = a2 + a.w;
  V incl = a3;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const V up = __shfl_up_sync(kFull, incl, d);
    if (k >= d) incl += up;
  }
  V excl = __shfl_up_sync(kFull, incl, 1);
  if (k == 0) excl = V(0);
  const V4<V> p = {excl + a.x, excl + a1, excl + a2, excl + a3};
  __syncwarp();  // the previous row's route has finished reading w
  store4(w + 4 * k, p);
  __syncwarp();
  return {p.x - (hd.x >= 0 ? w[hd.x] : V(0)),
          p.y - (hd.y >= 0 ? w[hd.y] : V(0)),
          p.z - (hd.z >= 0 ? w[hd.z] : V(0)),
          p.w - (hd.w >= 0 ? w[hd.w] : V(0))};
}

// Run totals of a stream row from the calling lane's four values a and
// head lanes hd.  On return w[0..127] holds W of the row, visible to the
// whole warp.
template <typename V>
__device__ __forceinline__ void run_totals(V4<V> a, char4 hd, V* w) {
  const V4<V> tot = lane_totals(a, hd, w);
  __syncwarp();
  store4(w + 4 * (threadIdx.x & 31), tot);
  __syncwarp();
}

// Run totals of stream row r from the calling lane's four values a.
template <typename V>
__device__ __forceinline__ void run_totals(int r, V4<V> a,
                                           const int8_t* __restrict__ hm1,
                                           V* w) {
  run_totals(a, load_c4(hm1 + (size_t)r * kLanes + 4 * (threadIdx.x & 31)),
             w);
}

// The four dests of the calling lane's slots: int16 in the spmv routes'
// streams, int8 in bkt's (a bin lane), int32 in a variant of the A/B
// harnesses.
__device__ __forceinline__ int4 load_dest4(const int8_t* p) {
  const char4 d = load_c4(p);
  return make_int4(d.x, d.y, d.z, d.w);
}

__device__ __forceinline__ int4 load_dest4(const int16_t* p) {
  const short4 d = *reinterpret_cast<const short4*>(p);
  return make_int4(d.x, d.y, d.z, d.w);
}

__device__ __forceinline__ int4 load_dest4(const int32_t* p) {
  return *reinterpret_cast<const int4*>(p);
}

// acc[4k + i] += w[e_i] for the four end-lanes e of lane k (e < 0: none).
template <typename V>
__device__ __forceinline__ void route4(char4 e, const V* w, V* acc_row) {
  if (e.x >= 0) atomicAdd(acc_row + 0, w[e.x]);
  if (e.y >= 0) atomicAdd(acc_row + 1, w[e.y]);
  if (e.z >= 0) atomicAdd(acc_row + 2, w[e.z]);
  if (e.w >= 0) atomicAdd(acc_row + 3, w[e.w]);
}

template <typename V>
__device__ __forceinline__ void route4(const int8_t* __restrict__ e4,
                                       const V* w, V* acc_row) {
  route4(load_c4(e4), w, acc_row);
}

// Adds the nonzero entries of acc[lo*128, (hi+1)*128) into out_block.
template <typename V>
__device__ __forceinline__ void flush(const V* acc, int lo, int hi,
                                      V* __restrict__ out_block) {
  for (int i = lo * kLanes + threadIdx.x; i < (hi + 1) * kLanes;
       i += kThreads) {
    const V v = acc[i];
    if (v != V(0)) atomicAdd(out_block + i, v);
  }
}

// Rows per block: the largest power of two up to 32 that divides T.
int rows_per_block(int T) {
  int r = 32;
  while (T % r) r >>= 1;
  return r;
}

}  // namespace
