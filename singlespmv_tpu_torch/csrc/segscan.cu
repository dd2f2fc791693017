// Segmented scan kernel of ss and csr5 for Hopper (sm_90a), bound through a
// plain C interface (ops/_build.py builds this file, ops/segscan.py calls
// it).
//
//   segscan_kernel<S> replaces _segscan_kernel, the kernel of
//     segmented_scan_tiles (singlespmv_tpu/ops/pallas/segscan.py:32 and
//     :51): the segmented inclusive sum-scan of each W-wide row of an
//     (H, W) product stream, with head flags.
//
// The TPU kernel scans an (8, W) block in VMEM by log2(W) Hillis–Steele
// lane shifts, one block per step of its sequential grid.  Here a block owns
// whole rows and scans them chunk by chunk (segscan.cuh: a serial scan of
// four elements per thread, a shuffle scan per warp, the warp totals in
// shared memory), so each element is read and written once.  At double the
// same template runs on native fp64, where the reference has no df64 scan
// kernel of its own (its f64 path runs this one in interpret mode only).
//
// At bfloat16 (S = __nv_bfloat16) the products are read as 2 bytes and the
// scan runs and is written in float, where the TPU kept it in bfloat16.
//
// Bound: device memory bandwidth (S + 1 bytes in, acc_t<S> out per element).  The
// heads are read as the uint8 the formats store, where the TPU kernel took a
// fresh int32 copy each call.  This first version aims to be right: no TMA,
// no software pipelining.

#include "segscan.cuh"

namespace {

// S is the storage type of the products, acc_t<S> that of the scan and of
// `out` (float for bfloat16 products).
template <typename S>
__global__ void __launch_bounds__(kThreads) segscan_kernel(
    const S* __restrict__ prod, const uint8_t* __restrict__ heads,
    acc_t<S>* __restrict__ out, long long n, int W, int R) {
  const long long start = (long long)blockIdx.x * R * W;
  const long long end = min(start + (long long)R * W, n);
  scan_span<acc_t<S>>(start, end, W, heads, out,
                      [prod](long long p) { return load4(prod + p); });
}

template <typename S>
int launch(const void* prod, const void* heads, void* out, int H, int W,
           void* stream) {
  if (H < 0 || W < 4 || W % 4) return (int)cudaErrorInvalidValue;
  if (H == 0) return 0;
  const int R = scan_rows(W);
  segscan_kernel<S><<<(H + R - 1) / R, kThreads, 0, (cudaStream_t)stream>>>(
      (const S*)prod, (const uint8_t*)heads, (acc_t<S>*)out,
      (long long)H * W, W, R);
  return (int)cudaGetLastError();
}

}  // namespace

// prod and `out` (H, W) of the value type, heads (H, W) uint8 (nonzero at a
// run's first element); `out` is written in full.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue without a launch for a shape
// it cannot take (W not a multiple of 4).
extern "C" int segmented_scan_tiles_f32(const void* prod, const void* heads,
                                        void* out, int H, int W,
                                        void* stream) {
  return launch<float>(prod, heads, out, H, W, stream);
}

extern "C" int segmented_scan_tiles_f64(const void* prod, const void* heads,
                                        void* out, int H, int W,
                                        void* stream) {
  return launch<double>(prod, heads, out, H, W, stream);
}

// bfloat16 products (2 bytes an element), float32 `out`.
extern "C" int segmented_scan_tiles_bf16(const void* prod, const void* heads,
                                         void* out, int H, int W,
                                         void* stream) {
  return launch<bf16>(prod, heads, out, H, W, stream);
}
