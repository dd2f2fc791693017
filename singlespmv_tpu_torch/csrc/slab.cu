// Slab SpMV kernels for Hopper (sm_90a), bound through a plain C interface
// (ops/_build.py loads this file with ctypes, ops/slab.py calls it).
//
//   slab_unit_kernel<float> replaces _slab_kernel, the kernel of slab_spmv
//     (singlespmv_tpu/ops/pallas/slab.py:102 and :263);
//   slab_unit_kernel<double> replaces _slab_df_kernel, the kernel of
//     slab_spmv_df (singlespmv_tpu/ops/pallas/slab.py:381 and :463): the same
//     function at native fp64, where the TPU carried (hi, lo) float planes
//     through Dekker products and compensated sums;
//   slab_blk_kernel replaces _slab_blk_kernel, the kernel of slab_spmv_blk
//     (singlespmv_tpu/ops/pallas/slab.py:140 and :310); float only, as the
//     reference's float64 plans are unit mode only;
//   slab_spmm_kernel replaces _slab_spmm_kernel, the kernel of slab_spmm
//     (singlespmv_tpu/ops/pallas/slab.py:184 and :228): the unit route over a
//     panel of B columns; float only, as the TPU ran it (its float64 SpMM
//     is a column loop over the spmv kernels).
//
// Per stream row r of 128 slots l, in grid step t = r / T, both compute
//   gather   g[l] = x[(win[r] + sub[r,l]) * 128 + lane[r,l]]  (sub unread if m == 1)
//   product  p[l] = val[r,l] * g[l]
//   runs     W[l] = P[l] - P[hm1[r,l]], P the inclusive prefix of p over the
//            row (hm1 < 0: subtract nothing); at a run's end lane W is its total
//   route    unit: out[uids[t]*planes + s, l] += W[idx[s,r,l]]   for planes s
//                  in [sg0[t], sg1[t]] with idx >= 0;
//            blk:  out[uids[t]*planes + sig[r] + j, l] += W[idx[j,r,l]]
//                  for j < kblk with idx >= 0 and sig[r] + j < planes.
//
// Design.  The TPU walks the grid in order and keeps one out block in VMEM
// across a unit's steps.  Here the steps run in parallel: a block of 8 warps
// takes `rpb` consecutive stream rows (rpb divides T, so all of them lie in
// one step) and each warp takes whole rows, with the gather, prefix and
// route of stream_row.cuh.  W goes through a per-warp shared buffer for the
// hm1 and idx lookups.  x stays in L2 (50 MB; the x tables of the main path
// are far smaller), and the one-hot MXU route becomes an indexed add.
// Routed totals collect in a (planes, 128) shared accumulator with shared
// atomics, since rows of one block may end runs of the same y row, then go
// to the out block with one global atomicAdd per nonzero entry, since one out
// block takes the rows of many blocks.  The wrapper zeroes `out`.  The atomics make the order of the
// sums, and so their rounding, vary from run to run.  At double the shared
// buffers are 16 KB (accumulator) + 8 KB (row buffers), under the 48 KB
// static limit.
//
// slab_spmm (redesigned for Hopper).  The x panel is interleaved,
// (CB, 128, B): slot column c's B values are contiguous, and so are out's,
// (nu * planes * 128, B): unit block u's plane s lane l holds row
// (u * planes + s) * 128 + l, its B columns side by side, which is Y's own
// (row, B) layout (the reference's (nu * B * planes, 128) put the columns
// of a block apart, and Y's assembly had to transpose them).  A warp takes
// one stream row through panel_row.cuh: it stages the row once, reads only
// the idx planes [sg0[t], sg1[t]] of its step (the converts leave every
// entry outside them at -1, so the pruning is exact), then each group of
// C lanes (the power of two up to 32 that covers B) walks its slots with
// one coalesced gather of the slot's C values, keeping run sums, and adds
// each run total into out with global atomics: C consecutive floats per
// run end, one coalesced access.  A
// panel wider than 32 columns walks the staged row once per tile.  There
// is no shared accumulator: on sm_90 a float atomicAdd to shared memory
// compiles to a compare-and-swap loop (ATOMS.CAST.SPIN) that retries where
// warps add to the same y row, as the rows of a step do, where a global
// one is a native reduction in L2.  On an H100, a first version that
// routed into a (span * 128, tile) shared accumulator, with column tiles
// and two blocks an SM, took 142.74 us for g7jac200sc's unit plan at B 32
// (chip_smoke.py), this one 58.65; harness/panel_ab.py times this walk
// with its atomics sent to distinct shared addresses instead.  Bound:
// the streams once (idx only for the routed planes), the panel once (from
// L2: far smaller than the 50 MB L2 on the main path) and the out rows
// once, bytes.
//
// Bound.  Per slot the kernel streams 4 B of val (8 B at double), 2 B of
// int8 (lane, hm1) or 3 B when m > 1 (sub), and idx: up to `planes` B in
// unit mode (only the planes in [sg0, sg1] are read), kblk B in blk mode; x
// is gathered from L2.  That makes it a streaming kernel bound by device
// memory bandwidth.  This first version aims to be right: no TMA, no wgmma,
// no software pipelining.

#include "panel_row.cuh"

namespace {

constexpr int kMaxUnitPlanes = 16;
constexpr int kMaxBlkPlanes = 32;

// Gather, multiply and run totals of stream row r for the calling warp.
// On return w[0..127] holds W of the row, visible to the whole warp.
template <typename V>
__device__ __forceinline__ void row_totals(
    int r, int m, const int32_t* __restrict__ win,
    const int8_t* __restrict__ lane, const int8_t* __restrict__ sub,
    const V* __restrict__ val, const int8_t* __restrict__ hm1,
    const V* __restrict__ x, V* w) {
  const V4<V> v = load4(val + (size_t)r * kLanes + 4 * (threadIdx.x & 31));
  run_totals(r, mul4(v, gather4(r, m, win, lane, sub, x)), hm1, w);
}

template <typename V>
__global__ void __launch_bounds__(kThreads) slab_unit_kernel(
    const int32_t* __restrict__ uids, const int32_t* __restrict__ sg0,
    const int32_t* __restrict__ sg1, const int32_t* __restrict__ win,
    const int8_t* __restrict__ lane, const int8_t* __restrict__ sub,
    const V* __restrict__ val, const int8_t* __restrict__ hm1,
    const int8_t* __restrict__ idx, const V* __restrict__ x,
    V* __restrict__ out, int H, int T, int rpb, int m, int planes) {
  __shared__ V acc[kMaxUnitPlanes * kLanes];
  __shared__ __align__(16) V wbuf[kWarps][kLanes];
  const int warp = threadIdx.x >> 5, k = threadIdx.x & 31;
  const int r0 = blockIdx.x * rpb;
  const int t = r0 / T;
  const int lo = max(sg0[t], 0), hi = min(sg1[t], planes - 1);
  if (lo > hi) return;  // the step routes nothing; uniform over the block
  for (int i = threadIdx.x; i < planes * kLanes; i += kThreads) acc[i] = V(0);
  __syncthreads();
  for (int r = r0 + warp; r < r0 + rpb; r += kWarps) {
    row_totals(r, m, win, lane, sub, val, hm1, x, wbuf[warp]);
    for (int s = lo; s <= hi; ++s)
      route4(idx + ((size_t)s * H + r) * kLanes + 4 * k, wbuf[warp],
             acc + s * kLanes + 4 * k);
  }
  __syncthreads();
  flush(acc, lo, hi, out + (size_t)uids[t] * planes * kLanes);
}

__global__ void __launch_bounds__(kThreads) slab_blk_kernel(
    const int32_t* __restrict__ uids, const int32_t* __restrict__ win,
    const int8_t* __restrict__ lane, const int8_t* __restrict__ sub,
    const float* __restrict__ val, const int8_t* __restrict__ hm1,
    const int8_t* __restrict__ idx, const int8_t* __restrict__ sig,
    const float* __restrict__ x, float* __restrict__ out, int H, int T,
    int rpb, int m, int planes, int kblk) {
  __shared__ float acc[kMaxBlkPlanes * kLanes];
  __shared__ __align__(16) float wbuf[kWarps][kLanes];
  const int warp = threadIdx.x >> 5, k = threadIdx.x & 31;
  const int r0 = blockIdx.x * rpb;
  const int t = r0 / T;
  for (int i = threadIdx.x; i < planes * kLanes; i += kThreads) acc[i] = 0.f;
  __syncthreads();
  for (int r = r0 + warp; r < r0 + rpb; r += kWarps) {
    row_totals(r, m, win, lane, sub, val, hm1, x, wbuf[warp]);
    const int s = sig[(size_t)r * kLanes];  // lane-replicated: slot 0 holds it
    for (int j = 0; j < kblk; ++j) {
      const int p = s + j;
      if (p < 0 || p >= planes) continue;  // the TPU's one-hot drops these
      route4(idx + ((size_t)j * H + r) * kLanes + 4 * k, wbuf[warp],
             acc + p * kLanes + 4 * k);
    }
  }
  __syncthreads();
  flush(acc, 0, planes - 1, out + (size_t)uids[t] * planes * kLanes);
}

__global__ void __launch_bounds__(kThreads) slab_spmm_kernel(
    const int32_t* __restrict__ uids, const int32_t* __restrict__ sg0,
    const int32_t* __restrict__ sg1, const int32_t* __restrict__ win,
    const int8_t* __restrict__ lane, const int8_t* __restrict__ sub,
    const float* __restrict__ val, const int8_t* __restrict__ hm1,
    const int8_t* __restrict__ idx, const float* __restrict__ x,
    float* __restrict__ out, int H, int T, int m, int planes, int B) {
  __shared__ __align__(16) PanelSlot stage[kWarps][kPanelStage];
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= H) return;
  const int t = r / T;
  const int lo = max(sg0[t], 0), hi = min(sg1[t], planes - 1);
  if (lo > hi) return;  // the step routes nothing; uniform over the warp
  const LaneGroups lg(column_tile(B), 1);
  PanelSlot* st = stage[threadIdx.x >> 5];
  stage_row<true>(st, lg, r, m, 0, win, lane, sub, val, hm1);
  __syncwarp();
  read_dests(st, lg, idx + ((size_t)lo * H + r) * kLanes, (size_t)H * kLanes,
             hi - lo + 1, (uids[t] * planes + lo) * kLanes);
  __syncwarp();
  route_row<true>(st, lg, x, out, B);
}

template <typename V>
int launch_unit(const void* uids, const void* sg0, const void* sg1,
                const void* win, const void* lane, const void* sub,
                const void* val, const void* hm1, const void* idx,
                const void* x, void* out, int H, int T, int m, int planes,
                void* stream) {
  if (planes < 1 || planes > kMaxUnitPlanes || T < 1 || H % T)
    return (int)cudaErrorInvalidValue;
  if (H == 0) return 0;
  const int rpb = rows_per_block(T);
  slab_unit_kernel<V><<<H / rpb, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)uids, (const int32_t*)sg0, (const int32_t*)sg1,
      (const int32_t*)win, (const int8_t*)lane, (const int8_t*)sub,
      (const V*)val, (const int8_t*)hm1, (const int8_t*)idx, (const V*)x,
      (V*)out, H, T, rpb, m, planes);
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry launches one kernel on `stream` and returns cudaGetLastError().
// Pointers are device pointers to contiguous arrays in the layout of
// ops/slab.py; `out` must be zeroed, of (nu * planes, 128) values of the
// entry's type (float32 for *_f32, float64 for *_f64), as val and x are.

extern "C" int slab_spmv_f32(const void* uids, const void* sg0,
                             const void* sg1, const void* win,
                             const void* lane, const void* sub,
                             const void* val, const void* hm1,
                             const void* idx, const void* x, void* out,
                             int H, int T, int m, int planes, void* stream) {
  return launch_unit<float>(uids, sg0, sg1, win, lane, sub, val, hm1, idx, x,
                            out, H, T, m, planes, stream);
}

extern "C" int slab_spmv_f64(const void* uids, const void* sg0,
                             const void* sg1, const void* win,
                             const void* lane, const void* sub,
                             const void* val, const void* hm1,
                             const void* idx, const void* x, void* out,
                             int H, int T, int m, int planes, void* stream) {
  return launch_unit<double>(uids, sg0, sg1, win, lane, sub, val, hm1, idx,
                             x, out, H, T, m, planes, stream);
}

extern "C" int slab_spmv_blk_f32(const void* uids, const void* win,
                                 const void* lane, const void* sub,
                                 const void* val, const void* hm1,
                                 const void* idx, const void* sig,
                                 const void* x, void* out, int H, int T,
                                 int m, int planes, int kblk, void* stream) {
  if (planes < 1 || planes > kMaxBlkPlanes || kblk < 1 || T < 1 || H % T)
    return (int)cudaErrorInvalidValue;
  if (H == 0) return 0;
  const int rpb = rows_per_block(T);
  slab_blk_kernel<<<H / rpb, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)uids, (const int32_t*)win, (const int8_t*)lane,
      (const int8_t*)sub, (const float*)val, (const int8_t*)hm1,
      (const int8_t*)idx, (const int8_t*)sig, (const float*)x, (float*)out,
      H, T, rpb, m, planes, kblk);
  return (int)cudaGetLastError();
}

// `out` must be zeroed, of (nu * planes * 128, B) floats; `x` is the
// interleaved (cb, 128, B) panel.
extern "C" int slab_spmm_f32(const void* uids, const void* sg0,
                             const void* sg1, const void* win,
                             const void* lane, const void* sub,
                             const void* val, const void* hm1,
                             const void* idx, const void* x, void* out,
                             int H, int T, int m, int planes, int B,
                             void* stream) {
  if (planes < 1 || planes > kMaxUnitPlanes || T < 1 || H < 0 || H % T ||
      B < 1)
    return (int)cudaErrorInvalidValue;
  if (H == 0) return 0;
  slab_spmm_kernel<<<(H + kWarps - 1) / kWarps, kThreads, 0,
                     (cudaStream_t)stream>>>(
      (const int32_t*)uids, (const int32_t*)sg0, (const int32_t*)sg1,
      (const int32_t*)win, (const int8_t*)lane, (const int8_t*)sub,
      (const float*)val, (const int8_t*)hm1, (const int8_t*)idx,
      (const float*)x, (float*)out, H, T, m, planes, B);
  return (int)cudaGetLastError();
}
