// Block-gathered scan kernel of css for Hopper (sm_90a), bound through a
// plain C interface (ops/_build.py builds this file, ops/blockgather.py calls
// it).
//
//   block_gather_scan_kernel<float> replaces _kernel, the kernel of
//     block_gather_scan (singlespmv_tpu/ops/pallas/blockgather.py:40 and
//     :111);
//   block_gather_scan_kernel<double> replaces _df_kernel, the kernel of
//     block_gather_scan_df (blockgather.py:64 and :144), which carries f64
//     as (hi, lo) float32 planes with Dekker products and compensated adds:
//     here the same template runs on native fp64.
//
// Per (8, W) tile of the css stream, every slot reads x from one 128-column
// block bids[tile]: out = segmented inclusive scan along each row of
// val * x[bid * 128 + (col - 128 * bid)], with head flags.  A block owns R
// rows of one tile (segscan.cuh: R divides 8), stages its tile's 128 x
// values in shared memory, and scans its rows chunk by chunk; the TPU's
// one lane-gather per tile becomes an indexed shared-memory load per slot.
// A lane outside [0, 128) wraps inside the block (the convert never makes
// one), and a block id outside the x table reads zeros.
//
// Bound: device memory bandwidth (col 4 bytes, val V, heads 1 in and V out
// per slot, the x table from L2).  This first version aims to be right: no
// TMA, no software pipelining.

#include "segscan.cuh"

namespace {

// S is the storage type of val and x, V = acc_t<S> that of the products,
// the scan and `out` (float for bfloat16 values: each product exact).
template <typename S>
__global__ void __launch_bounds__(kThreads) block_gather_scan_kernel(
    const int32_t* __restrict__ bids, const int32_t* __restrict__ col,
    const S* __restrict__ val, const uint8_t* __restrict__ heads,
    const S* __restrict__ x, acc_t<S>* __restrict__ out, long long n, int W,
    int R, int B) {
  using V = acc_t<S>;
  __shared__ V xs[kLanes];
  const long long row0 = (long long)blockIdx.x * R;
  const int bid = bids[row0 >> 3];
  const bool inside = bid >= 0 && bid < B;
  for (int i = threadIdx.x; i < kLanes; i += kThreads)
    xs[i] = inside ? to_acc(x[(size_t)bid * kLanes + i]) : V(0);
  __syncthreads();
  const int base = bid * kLanes;
  const V* xb = xs;
  const long long start = row0 * W;
  const long long end = min(start + (long long)R * W, n);
  scan_span<V>(start, end, W, heads, out, [=](long long p) {
    const int4 c = *reinterpret_cast<const int4*>(col + p);
    const V4<S> g = {xb[(c.x - base) & (kLanes - 1)],
                     xb[(c.y - base) & (kLanes - 1)],
                     xb[(c.z - base) & (kLanes - 1)],
                     xb[(c.w - base) & (kLanes - 1)]};
    return mul4(load4(val + p), g);
  });
}

template <typename S>
int launch(const void* bids, const void* col, const void* val,
           const void* heads, const void* x, void* out, int H, int W, int B,
           void* stream) {
  if (H < 0 || W < 4 || W % 4 || B < 0) return (int)cudaErrorInvalidValue;
  if (H == 0) return 0;
  const int R = scan_rows(W);
  block_gather_scan_kernel<S>
      <<<(H + R - 1) / R, kThreads, 0, (cudaStream_t)stream>>>(
          (const int32_t*)bids, (const int32_t*)col, (const S*)val,
          (const uint8_t*)heads, (const S*)x, (acc_t<S>*)out,
          (long long)H * W, W, R, B);
  return (int)cudaGetLastError();
}

}  // namespace

// bids (ceil(H / 8),) int32; col (H, W) int32; val and `out` (H, W) of the
// value type; heads (H, W) uint8; x (B, 128) of the value type.  `out` is
// written in full.  Returns cudaGetLastError(), or cudaErrorInvalidValue
// without a launch for a shape it cannot take (W not a multiple of 4).
extern "C" int block_gather_scan_f32(const void* bids, const void* col,
                                     const void* val, const void* heads,
                                     const void* x, void* out, int H, int W,
                                     int B, void* stream) {
  return launch<float>(bids, col, val, heads, x, out, H, W, B, stream);
}

extern "C" int block_gather_scan_f64(const void* bids, const void* col,
                                     const void* val, const void* heads,
                                     const void* x, void* out, int H, int W,
                                     int B, void* stream) {
  return launch<double>(bids, col, val, heads, x, out, H, W, B, stream);
}

// bfloat16 val and x (2 bytes a value), float32 `out`.
extern "C" int block_gather_scan_bf16(const void* bids, const void* col,
                                      const void* val, const void* heads,
                                      const void* x, void* out, int H, int W,
                                      int B, void* stream) {
  return launch<bf16>(bids, col, val, heads, x, out, H, W, B, stream);
}
