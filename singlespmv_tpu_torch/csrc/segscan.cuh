// Segmented inclusive sum-scan along the rows of an (H, W) stream, shared by
// segmented_scan_tiles (segscan.cu) and block_gather_scan (blockgather.cu),
// for accumulator type V = float or double (bfloat16 streams are widened
// to float as they are read, and scan and write float).
//
// A block of kThreads threads owns R whole stream rows (R = scan_rows(W):
// the largest power of two up to 8 with R * W <= kScanChunk, else 1), that
// is the flat span [b * R * W, (b + 1) * R * W) of the stream, and walks it
// in chunks of kScanChunk = 1024 elements.  In a chunk, thread t holds the
// four consecutive elements at 4t (one 16-byte load of float values, two of
// double, one 4-byte load of head flags), so every load and store is
// coalesced.  Per chunk:
//   1. each thread scans its four elements serially into (l_i, f_i): the
//      sum since its last head and whether it has seen one;
//   2. the threads' (sum, any-head) pairs are scanned across the block with
//      the operator (s_a, f_a) + (s_b, f_b) = (f_b ? s_b : s_a + s_b,
//      f_a | f_b): five shuffle steps in each warp, then the 8 warp totals
//      through shared memory, the carry of the previous chunk first;
//   3. element i comes out as f_i ? l_i : prefix + l_i, with prefix the
//      scan of everything before the thread in the row.
// The first element of every row is a head whatever the flags say, so rows
// scan independently, as in the TPU kernel.  The sums are taken in another
// order than the TPU's Hillis–Steele shifts: results agree to rounding.
//
// Bound: the stream is read once and written once (V + 1 bytes in, V bytes
// out per element), so both kernels are bound by device memory bandwidth.
#pragma once

#include "stream_row.cuh"

namespace {

constexpr int kScanItems = 4;
constexpr int kScanChunk = kThreads * kScanItems;

// Stream rows per block: R * W <= kScanChunk where W allows, R | 8.
int scan_rows(int W) {
  int r = 8;
  while (r > 1 && (long long)r * W > kScanChunk) r >>= 1;
  return r;
}

template <typename V>
__device__ __forceinline__ V4<V> zero4() {
  return {V(0), V(0), V(0), V(0)};
}

// Scans the flat span [start, end) of the stream (whole rows of width W,
// W % 4 == 0) into `out`.  `values(p)` returns the four values at flat
// positions p..p+3 (p % 4 == 0).  Every thread of the block must call it.
template <typename V, typename Values>
__device__ __forceinline__ void scan_span(long long start, long long end,
                                          int W,
                                          const uint8_t* __restrict__ heads,
                                          V* __restrict__ out,
                                          Values values) {
  __shared__ V warp_s[kWarps];
  __shared__ int warp_f[kWarps];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  V carry = V(0);  // the scan at the last element of the previous chunk
  for (long long c0 = start; c0 < end; c0 += kScanChunk) {
    const long long p = c0 + kScanItems * t;
    const bool live = p < end;
    V4<V> v = zero4<V>();
    int h0 = 1, h1 = 1, h2 = 1, h3 = 1;
    if (live) {
      v = values(p);
      const uchar4 hd = *reinterpret_cast<const uchar4*>(heads + p);
      h0 = hd.x != 0 || p % W == 0;  // W % 4 == 0: only element 0 can
      h1 = hd.y != 0;                // start a row
      h2 = hd.z != 0;
      h3 = hd.w != 0;
    }
    // 1. serial scan of the thread's four elements
    const V l0 = v.x;
    const V l1 = h1 ? v.y : l0 + v.y;
    const V l2 = h2 ? v.z : l1 + v.z;
    const V l3 = h3 ? v.w : l2 + v.w;
    const int f0 = h0, f1 = f0 | h1, f2 = f1 | h2, f3 = f2 | h3;
    // 2. inclusive scan of the threads' pairs within the warp
    V s = l3;
    int f = f3;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const V up_s = __shfl_up_sync(kFull, s, d);
      const int up_f = __shfl_up_sync(kFull, f, d);
      if (lane >= d) {
        if (!f) s = up_s + s;
        f |= up_f;
      }
    }
    if (lane == 31) {
      warp_s[warp] = s;
      warp_f[warp] = f;
    }
    __syncthreads();
    // the carry and the warps before this one, in order
    V pre = carry;
    for (int w = 0; w < warp; ++w) pre = warp_f[w] ? warp_s[w] : pre + warp_s[w];
    // then the lanes before this one
    const V ex_s = __shfl_up_sync(kFull, s, 1);
    const int ex_f = __shfl_up_sync(kFull, f, 1);
    if (lane > 0) pre = ex_f ? ex_s : pre + ex_s;
    // 3. the thread's outputs
    if (live) {
      const V4<V> o = {f0 ? l0 : pre + l0, f1 ? l1 : pre + l1,
                       f2 ? l2 : pre + l2, f3 ? l3 : pre + l3};
      store4(out + p, o);
    }
    V next = carry;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      next = warp_f[w] ? warp_s[w] : next + warp_s[w];
    carry = next;
    __syncthreads();  // warp_s is rewritten by the next chunk
  }
}

}  // namespace
