// Lane-owned unit accumulators: how the route kernels that sum a unit's
// stream rows into its (planes, 128) out rows collect their totals
// (probe_slab_kernel in probe_slab.cu, xch_route_kernel in xch.cu).
//
// A routed total of slot column c always lands in column c of its plane
// (route4 of stream_row.cuh adds w[e] into acc_row + 4k + i), so lane k of
// every warp owns columns 4k..4k+3 of every plane.  The lane keeps them in
// registers (LaneAcc) and adds with plain FADDs: no shared atomics and no
// zero pass.
//
// A block takes a chunk of R stream rows (R a multiple of T, chosen on the
// host: ops/probes.py:unit_chunk_rows) and walks it one segment at a time,
// a segment being the longest run of steps of one unit inside the chunk
// (uids is non-decreasing).  At a segment's end the 8 warps put their
// partials into shared memory with plain stores, the block sums them in
// warp order, and each float4 of sums goes into out once, by a native
// float4 global reduction (RED) where one of the four is nonzero: the
// wrapper zeroed out.  A unit longer than a chunk is then shared by
// ceil(its rows / R) blocks.  Plain stores where a chunk holds a whole
// unit, and thread block clusters that sum a unit's partials over
// distributed shared memory, ran slower on an H100 (harness/route_ab.py).
#pragma once

#include "stream_row.cuh"

namespace {

constexpr int kMaxUnitDevices = 64;

// The first step in (t, t1] whose unit differs from step t's, or t1.
__device__ __forceinline__ int segment_end(const int32_t* __restrict__ uids,
                                           int t, int t1) {
  const int u = __ldg(uids + t);
  int e = t + 1;
  while (e < t1 && __ldg(uids + e) == u) ++e;
  return e;
}

// Byte i of four packed int8 end lanes, sign-extended.
__device__ __forceinline__ int end_lane(uint32_t ends, int i) {
  return (int)(ends << (24 - 8 * i)) >> 24;
}

// The calling lane's four int8 end lanes at p, packed (no end: all -1).
__device__ __forceinline__ uint32_t load_ends(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
constexpr uint32_t kNoEnds = 0xffffffffu;

// Columns 4k..4k+3 of P planes for lane k of the calling warp, in
// registers; `slice` is the warp's (P, 128) slice of the block's partials.
template <int P>
struct LaneAcc {
  float4 a[P];
  float* slice;

  __device__ __forceinline__ void init(float* part) {
    slice = part + (threadIdx.x >> 5) * P * kLanes;
#pragma unroll
    for (int s = 0; s < P; ++s) a[s] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  __device__ __forceinline__ void add(int s, float4 v) {
    a[s].x += v.x;
    a[s].y += v.y;
    a[s].z += v.z;
    a[s].w += v.w;
  }

  // Plane s gains w[e] at each of the lane's four slots whose end lane e
  // (a signed byte of `ends`, slot 4k in the low one) is >= 0.
  __device__ __forceinline__ void route(int s, uint32_t ends, const float* w) {
    const int e0 = end_lane(ends, 0), e1 = end_lane(ends, 1);
    const int e2 = end_lane(ends, 2), e3 = end_lane(ends, 3);
    add(s, make_float4(e0 >= 0 ? w[e0] : 0.f, e1 >= 0 ? w[e1] : 0.f,
                       e2 >= 0 ? w[e2] : 0.f, e3 >= 0 ? w[e3] : 0.f));
  }

  // Puts planes [0, n) of the partials into the warp's slice and zeroes
  // them; then syncs the block.
  __device__ __forceinline__ void stage(int n) {
    const int k = threadIdx.x & 31;
#pragma unroll
    for (int s = 0; s < P; ++s) {
      if (s < n) store4(slice + s * kLanes + 4 * k, a[s]);
      a[s] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
  }
};

// The sums over the warps' slices of float4 i of the staged partials (P
// planes a slice), in warp order.
template <int P>
__device__ __forceinline__ float4 warp_sum4(const float* part, int i) {
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const float4 v = load4(part + w * P * kLanes + 4 * i);
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  return s;
}

// Calls put(i, sums) once for every float4 i in [0, n4) of the unit's
// staged partials, each by one thread of the block, then syncs the block
// so that the partials may be staged again.
template <int P, typename Put>
__device__ __forceinline__ void reduce_unit(float* part, int n4, Put put) {
  for (int i = threadIdx.x; i < n4; i += kThreads) put(i, warp_sum4<P>(part, i));
  __syncthreads();
}

// Adds four sums of a unit's out row into p (16-byte aligned) with one
// float4 reduction, where one of them is nonzero.
__device__ __forceinline__ void red4(float* p, float4 v) {
  if (v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f)
    atomicAdd(reinterpret_cast<float4*>(p), v);  // result unused: RED
}

// Lets `kernel` take `bytes` of dynamic shared memory on the current device,
// once a device and size (`allowed`, one a kernel).
cudaError_t allow_unit_smem(const void* kernel, int bytes,
                            int (&allowed)[kMaxUnitDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxUnitDevices) return cudaErrorInvalidDevice;
  if (bytes <= allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) allowed[dev] = bytes;
  return err;
}

}  // namespace
