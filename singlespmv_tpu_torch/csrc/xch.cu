// XCH exchange-engine kernels for Hopper (sm_90a), bound through a plain C
// interface (ops/_build.py builds this file with ctypes, ops/xch.py calls
// it).
//
//   xch_mul_kernel replaces _xch_mul_kernel, the kernel of xch_mul
//     (singlespmv_tpu/ops/pallas/xch.py:41 and :48);
//   xch_route4_kernel replaces _xch_route4_kernel, the kernel of xch_route4
//     (singlespmv_tpu/ops/pallas/xch.py:78 and :151).
//
// Pass 1, per stream row r of 128 slots l:
//   out[r,l] = val[r,l] * x[(win[r] + sub[r,l]) * 128 + lane[r,l]]
// (sub unread if m == 1): the gather of stream_row.cuh and a linear write,
// with no reduction.
//
// Pass 2, per stream row r in grid step t = r / T: gather from the products
// of source chunk cs[t] (x = prod + cs[t] * p1 * 128, window win[r] local to
// the chunk), take run totals W as slab does, then
//   out[(gids[t]*gb + off[t] + sig[r] + j), l] += W[idx[j,r,l]]
// for j < kblk with idx >= 0 and 0 <= sig[r] + j < p_oh (what the TPU's
// (p_oh, T) one-hot keeps).  sig is lane-replicated: slot 0 holds it.
//
// Design.  The TPU walks the steps in order and zeroes a group's out block
// when gids changes.  A group's steps are contiguous within a call and never
// split across calls, so zeroing all of `out` in the wrapper and
// accumulating with atomics computes the same function.  A block of 8 warps
// takes `rpb` rows of one step (rpb divides T), so it shares gids[t], off[t]
// and cs[t]; it collects routed totals in a (p_oh, 128) shared accumulator
// (32 KB at p_oh 64, plus the 4 KB row buffer: under the 48 KB static
// limit) and adds the nonzero entries of the rows its stream rows can reach
// to the out block with global atomics.  The order of the float32 sums, and
// so their rounding, varies from run to run.
//
// Bound.  Pass 1 streams 4 B of val and 1 B of lane per slot (2 B when
// m > 1) and writes 4 B of product; x is gathered from L2.  Pass 2 streams
// 3 B of lane, hm1, sig (4 B when m > 1) and kblk B of idx per slot, and
// gathers the products, which pass 1 has just written and which stay in L2
// (50 MB) unless the product stream is larger.  Both are streaming kernels
// bound by device memory bandwidth.  This first version aims to be right:
// no TMA, no wgmma, no software pipelining.

#include "stream_row.cuh"

namespace {

constexpr int kMaxWindow = 120;  // the planner's M_MAX: int8 sub headroom
constexpr int kMaxPoh = 64;      // the planner's largest one-hot width

__global__ void __launch_bounds__(kThreads) xch_mul_kernel(
    const int32_t* __restrict__ win, const int8_t* __restrict__ lane,
    const int8_t* __restrict__ sub, const float* __restrict__ val,
    const float* __restrict__ x, float* __restrict__ out, int H, int m) {
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= H) return;
  const size_t off = (size_t)r * kLanes + 4 * (threadIdx.x & 31);
  const float4 g = gather4(r, m, win, lane, sub, x);
  const float4 v = *reinterpret_cast<const float4*>(val + off);
  *reinterpret_cast<float4*>(out + off) =
      make_float4(v.x * g.x, v.y * g.y, v.z * g.z, v.w * g.w);
}

__global__ void __launch_bounds__(kThreads) xch_route4_kernel(
    const int32_t* __restrict__ gids, const int32_t* __restrict__ off,
    const int32_t* __restrict__ cs, const int32_t* __restrict__ win,
    const int8_t* __restrict__ lane, const int8_t* __restrict__ sub,
    const int8_t* __restrict__ hm1, const int8_t* __restrict__ sig,
    const int8_t* __restrict__ idx, const float* __restrict__ prod,
    float* __restrict__ out, int H, int T, int rpb, int m, int kblk,
    int p_oh, int gb, int p1, long long n_out) {
  __shared__ float acc[kMaxPoh * kLanes];
  __shared__ __align__(16) float wbuf[kWarps][kLanes];
  __shared__ int row_lo, row_hi;
  const int warp = threadIdx.x >> 5, k = threadIdx.x & 31;
  const int r0 = blockIdx.x * rpb;
  const int t = r0 / T;
  // the accumulator rows this block's stream rows can reach
  if (threadIdx.x == 0) {
    row_lo = p_oh;
    row_hi = -1;
  }
  __syncthreads();
  if (threadIdx.x < rpb) {
    const int s = sig[(size_t)(r0 + threadIdx.x) * kLanes];
    atomicMin(&row_lo, max(s, 0));
    atomicMax(&row_hi, min(s + kblk - 1, p_oh - 1));
  }
  __syncthreads();
  const int lo = row_lo, hi = row_hi;
  if (lo > hi) return;  // the block routes nothing; uniform over the block
  for (int i = lo * kLanes + threadIdx.x; i < (hi + 1) * kLanes;
       i += kThreads)
    acc[i] = 0.f;
  __syncthreads();
  const float* x = prod + (size_t)cs[t] * p1 * kLanes;
  for (int r = r0 + warp; r < r0 + rpb; r += kWarps) {
    run_totals(r, gather4(r, m, win, lane, sub, x), hm1, wbuf[warp]);
    const int s = sig[(size_t)r * kLanes];
    for (int j = max(-s, 0); j < kblk && s + j < p_oh; ++j)
      route4(idx + ((size_t)j * H + r) * kLanes + 4 * k, wbuf[warp],
             acc + (s + j) * kLanes + 4 * k);
  }
  __syncthreads();
  // out row of accumulator row 0; rows past the end of out are dropped
  const long long base = (long long)gids[t] * gb + off[t];
  const long long room = n_out - 1 - base;
  const int last = room < hi ? (int)room : hi;
  if (base >= 0 && last >= lo) flush(acc, lo, last, out + base * kLanes);
}

}  // namespace

// Each entry launches one kernel on `stream` and returns cudaGetLastError().
// Pointers are device pointers to contiguous arrays in the layout of
// ops/xch.py.

// `out` (H, 128) float32 is written in full.
extern "C" int xch_mul_f32(const void* win, const void* lane, const void* sub,
                           const void* val, const void* x, void* out, int H,
                           int T, int m, void* stream) {
  if (m < 1 || m > kMaxWindow || T < 1 || H < 0 || H % T)
    return (int)cudaErrorInvalidValue;
  if (H == 0) return 0;
  xch_mul_kernel<<<(H + kWarps - 1) / kWarps, kThreads, 0,
                   (cudaStream_t)stream>>>(
      (const int32_t*)win, (const int8_t*)lane, (const int8_t*)sub,
      (const float*)val, (const float*)x, (float*)out, H, m);
  return (int)cudaGetLastError();
}

// `out` must be zeroed, of (n_grp * gb, 128) float32; `prod` is the
// (n_chunks, p1, 128) float32 product grid of pass 1.
extern "C" int xch_route4_f32(const void* gids, const void* off,
                              const void* cs, const void* win,
                              const void* lane, const void* sub,
                              const void* hm1, const void* sig,
                              const void* idx, const void* prod, void* out,
                              int H, int T, int m, int kblk, int p_oh,
                              int n_grp, int gb, int p1, void* stream) {
  if (m < 1 || m > kMaxWindow || kblk < 1 || p_oh < 1 || p_oh > kMaxPoh ||
      T < 1 || H < 0 || H % T || n_grp < 0 || gb < 1 || p1 < 1)
    return (int)cudaErrorInvalidValue;
  if (H == 0) return 0;
  const int rpb = rows_per_block(T);
  xch_route4_kernel<<<H / rpb, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)gids, (const int32_t*)off, (const int32_t*)cs,
      (const int32_t*)win, (const int8_t*)lane, (const int8_t*)sub,
      (const int8_t*)hm1, (const int8_t*)sig, (const int8_t*)idx,
      (const float*)prod, (float*)out, H, T, rpb, m, kblk, p_oh, gb, p1,
      (long long)n_grp * gb);
  return (int)cudaGetLastError();
}
