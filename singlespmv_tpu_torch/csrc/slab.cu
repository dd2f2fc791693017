// Slab SpMV kernels for Hopper (sm_90a), bound through a plain C interface
// (ops/_build.py loads this file with ctypes, ops/slab.py calls it).
//
//   slab_rows_kernel<S> and slab_rows_merge_kernel<S> replace, on the spmv
//     path, the kernels of all three Pallas slab spmv functions (at bfloat16
//     S = __nv_bfloat16: values and x read as 2 bytes, every sum and y in
//     float, where the TPU rounded its prefix to bfloat16): at float
//     _slab_kernel and _slab_blk_kernel, the kernels of slab_spmv and
//     slab_spmv_blk (singlespmv_tpu/ops/pallas/slab.py:102, :263 and :140,
//     :310), and at double _slab_df_kernel, the kernel of slab_spmv_df
//     (:381 and :463), where the TPU carried (hi, lo) float planes through
//     Dekker products and compensated sums.  They compute the same sums,
//     routed by a run-end destination stream that formats/slab.py:route_rows
//     derives from the TPU's idx planes (unit and block routes alike);
//   slab_unit_kernel<float|double> and slab_blk_kernel, the first port of
//     those three on the TPU's idx planes, are on no path: they stay as the
//     "first port" variant of harness/slab_ab.py and for the parity tests;
//   slab_spmm_kernel<S> replaces _slab_spmm_kernel, the kernel of slab_spmm
//     (singlespmv_tpu/ops/pallas/slab.py:184 and :228): the unit route over a
//     panel of B columns, at float and at bfloat16 as the TPU ran it (its
//     float64 SpMM is a column loop over the spmv kernels).  At bfloat16
//     val and the panel are read as 2 bytes a value and out is float: the
//     products, run sums and out are float, where the TPU rounded each of
//     them to bfloat16, and the caller rounds Y once.
//
// Per stream row r of 128 slots l, in grid step t = r / T, all compute
//   gather   g[l] = x[(win[r] + sub[r,l]) * 128 + lane[r,l]]  (sub unread if m == 1)
//   product  p[l] = val[r,l] * g[l]
//   runs     W[l] = P[l] - P[hm1[r,l]], P the inclusive prefix of p over the
//            row (hm1 < 0: subtract nothing); at a run's end lane W is its total
// and then route the run totals:
//   rows     y[ybase[t, d >> 7] + (d & 127)] += W[e]  for each slot e with
//            d = dest[r,e] >= 0 (-1 on every slot that ends no run);
//   unit     out[uids[t]*planes + s, l] += W[idx[s,r,l]]   for planes s
//            in [sg0[t], sg1[t]] with idx >= 0 (first port);
//   blk      out[uids[t]*planes + sig[r] + j, l] += W[idx[j,r,l]]
//            for j < kblk with idx >= 0 and sig[r] + j < planes (first port).
//
// The spmv route (redesigned for Hopper).  A step's rows end runs inside
// one out block of planes * 128 positions: in unit mode the 1024 rows of a
// unit, or of a unit pair at 16 planes; in blk mode `planes` 128-row block
// slots from uids[t] on, a row's kblk of them from sig[r] on.  route_rows
// turns each run end into dest = p * 128 + l, its position in that block
// (int16: below 4096), and gives each step a table ybase[t, p] of `planes`
// int32, the y position of block p's row 0, or -1 where the reference drops
// the block; it keeps only the positions the TPU's one-hot and the
// reference's y assembly keep.  A warp takes a row: gather4, the multiply,
// the shuffle scan (lane_totals), then lane k, which holds the step's
// ybase[t, k] (planes <= 32), hands each of its four run ends its block's
// base by a shuffle, and the lane that holds end slot e adds W[e] into y
// with a native global reduction (atomicAdd whose result is unused:
// RED.ADD).  There is no shared accumulator, no zero pass, no flush, no
// block barrier, and no read of sig or idx: the glue after the first port
// (zeroed out blocks, their cat, the shift-add or pair overlap-add, the
// scatter by unit id) is gone, y is zeroed once and each chunk adds into
// it.  harness/slab_ab.py's "int32 dest" variant reads absolute int32
// positions instead (4 B a slot in place of 2, ybase unread): 5-8% slower
// on the large states on an H100, so the stream keeps int16.
//   Where many rows of a block end runs on the same y rows (the dense-row
// stand-ins: each y row's entries spread over many windows of its scope)
// route_rows sets a merge span, planes * 128, and the merge kernel takes a
// block of rpb rows of one step: each warp holds its rows' dests in
// registers, zeroes the plane range they reach in a span of its own in
// shared memory, adds its run totals there with
// plain adds (a row's dests are distinct and the warp's rows follow each
// other), then the block sums the warps' spans over the union of their
// ranges and adds each nonzero sum into y: one reduction a position a
// block, 32 consecutive positions a warp instruction, where the direct
// kernel's run ends scatter.  route_rows takes it where the stream rows
// end on average 32 runs or more: on an H100 it was 1.3-2.1x faster than
// the direct kernel on the three states with 38-82 run ends a row and
// 1.05-1.4x slower on the four with 14-24 (harness/slab_ab.py).  Its
// blocks take the most rows of a step that one register array of dests a
// warp holds, 32: blocks of 16 or 8 rows were slower on every state, and
// so were loading all of a warp's rows before summing the first (more
// registers) and blocks of 64 rows or a whole step (their dests read
// twice).  The spans take kWarps * planes * 128 values:
// 32 KB at float and 8 planes, 128 KB at 32 planes or at double and 16
// planes (dynamic shared memory past the 48 KB static limit).
// The atomics make the order of the sums, and so their rounding, vary from
// run to run.
//
// Design of the first port.  The TPU walks the grid in order and keeps one
// out block in VMEM across a unit's steps.  Here the steps run in parallel:
// a block of 8 warps takes `rpb` consecutive stream rows (rpb divides T, so
// all of them lie in one step) and each warp takes whole rows, with the
// gather, prefix and route of stream_row.cuh.  W goes through a per-warp
// shared buffer for the hm1 and idx lookups.  Routed totals collect in a
// (planes, 128) shared accumulator with shared atomics, since rows of one
// block may end runs of the same y row, then go to the out block with one
// global atomicAdd per nonzero entry, since one out block takes the rows of
// many blocks.  The wrapper zeroes `out`.  At double the shared buffers are
// 16 KB (accumulator) + 8 KB (row buffers), under the 48 KB static limit.
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
// once, bytes.  At bfloat16 the streams' val and the panel take 2 bytes a
// value and out stays float: the bytes fall by the val stream's half
// (out and the int8 streams are the same).
//
// Bound.  Per slot the spmv route streams 4 B of val (8 B at double), 2 B
// of int8 (lane, hm1) or 3 B when m > 1 (sub) and 2 B of dest, 4 B of win
// a row and `planes` ybase entries a step, and adds each run end into y;
// the first port streamed sig (1 B a slot) in blk mode and idx, kblk B a
// slot or up to `planes` B in unit mode (only the planes in [sg0, sg1] are
// read), and wrote its out blocks.  x is gathered from L2.  That makes them
// streaming kernels bound by device memory bandwidth.  No TMA, no wgmma, no
// software pipelining.

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

// y[b + (d & 127)] += v for a run end d >= 0, b its block's base from the
// lane of the step's ybase that holds it (every lane takes part in the
// shuffle); blocks the reference drops have b < 0.
template <typename V>
__device__ __forceinline__ void add_run(V* __restrict__ y, int yb, int d,
                                        V v, int n_y) {
  const int b = __shfl_sync(kFull, yb, (d >> 7) & 31);
  const int pos = b + (d & (kLanes - 1));
  if (d >= 0 && b >= 0 && pos < n_y) atomicAdd(y + pos, v);  // RED.ADD
}

// y[d] += v for an absolute dest d >= 0 (the int32 variant of the A/B).
template <typename V>
__device__ __forceinline__ void add_abs(V* __restrict__ y, int d, V v,
                                        int n_y) {
  if (d >= 0 && d < n_y) atomicAdd(y + d, v);
}

// S is the storage type of val and x, A = acc_t<S> that of y and of every
// sum (float for bfloat16 values).
template <typename S, typename D>
__global__ void __launch_bounds__(kThreads) slab_rows_kernel(
    const int32_t* __restrict__ ybase, const int32_t* __restrict__ win,
    const int8_t* __restrict__ lane, const int8_t* __restrict__ sub,
    const S* __restrict__ val, const int8_t* __restrict__ hm1,
    const D* __restrict__ dest, const S* __restrict__ x,
    acc_t<S>* __restrict__ y, int H, int T, int m, int planes, int n_y) {
  using A = acc_t<S>;
  __shared__ __align__(16) A wbuf[kWarps][kLanes];
  const int warp = threadIdx.x >> 5, k = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + warp;
  if (r >= H) return;  // uniform over the warp
  const size_t off = (size_t)r * kLanes + 4 * k;
  const int4 d = load_dest4(dest + off);
  const V4<S> w = lane_totals<A>(
      mul4(load4(val + off), gather4<S>(r, m, win, lane, sub, x)),
      load_c4(hm1 + off), wbuf[warp]);
  if constexpr (sizeof(D) == sizeof(int32_t)) {
    add_abs(y, d.x, w.x, n_y);
    add_abs(y, d.y, w.y, n_y);
    add_abs(y, d.z, w.z, n_y);
    add_abs(y, d.w, w.w, n_y);
  } else {
    const int yb = k < planes ? __ldg(ybase + (size_t)(r / T) * planes + k)
                              : -1;
    add_run(y, yb, d.x, w.x, n_y);
    add_run(y, yb, d.y, w.y, n_y);
    add_run(y, yb, d.z, w.z, n_y);
    add_run(y, yb, d.w, w.w, n_y);
  }
}

constexpr int kMergeSmem = 128 * 1024;  // the merge kernel's spans, at most
constexpr int kMaxWarpRows = 32 / kWarps;  // rows a warp of the merge kernel

// Widens [lo, hi] to the plane of dest e, if e lies in the span.
__device__ __forceinline__ void reach(int e, int span, int& lo, int& hi) {
  if ((unsigned)e < (unsigned)span) {
    lo = min(lo, e >> 7);
    hi = max(hi, e >> 7);
  }
}

template <typename S>
__global__ void __launch_bounds__(kThreads) slab_rows_merge_kernel(
    const int32_t* __restrict__ ybase, const int32_t* __restrict__ win,
    const int8_t* __restrict__ lane, const int8_t* __restrict__ sub,
    const S* __restrict__ val, const int8_t* __restrict__ hm1,
    const int16_t* __restrict__ dest, const S* __restrict__ x,
    acc_t<S>* __restrict__ y, int T, int rpb, int m, int planes, int n_y) {
  using V = acc_t<S>;  // the spans, the totals and y
  __shared__ __align__(16) V wbuf[kWarps][kLanes];
  __shared__ int wlo[kWarps], whi[kWarps];
  extern __shared__ __align__(16) unsigned char merge_smem[];
  const int span = planes * kLanes;
  V* const spans = reinterpret_cast<V*>(merge_smem);  // (kWarps, span)
  const int warp = threadIdx.x >> 5, k = threadIdx.x & 31;
  const int r0 = blockIdx.x * rpb;  // rpb divides T: one step
  const int t = r0 / T;
  V* const mine = spans + (size_t)warp * span;
  // the warp's rows' dests, and the planes they reach
  int4 d[kMaxWarpRows];
  int lo = planes, hi = -1;
#pragma unroll
  for (int i = 0; i < kMaxWarpRows; ++i) {
    const int r = r0 + warp + i * kWarps;
    d[i] = r < r0 + rpb ? load_dest4(dest + (size_t)r * kLanes + 4 * k)
                        : make_int4(-1, -1, -1, -1);
    reach(d[i].x, span, lo, hi);
    reach(d[i].y, span, lo, hi);
    reach(d[i].z, span, lo, hi);
    reach(d[i].w, span, lo, hi);
  }
  lo = __reduce_min_sync(kFull, lo);
  hi = __reduce_max_sync(kFull, hi);
  if (k == 0) {
    wlo[warp] = lo;
    whi[warp] = hi;
  }
  for (int i = lo * kLanes + k; i < (hi + 1) * kLanes; i += 32)
    mine[i] = V(0);
  __syncwarp();
#pragma unroll
  for (int i = 0; i < kMaxWarpRows; ++i) {
    const int r = r0 + warp + i * kWarps;
    if (r >= r0 + rpb) break;  // uniform over the warp
    const size_t off = (size_t)r * kLanes + 4 * k;
    const V4<S> w = lane_totals<V>(
        mul4(load4(val + off), gather4<S>(r, m, win, lane, sub, x)),
        load_c4(hm1 + off), wbuf[warp]);
    if ((unsigned)d[i].x < (unsigned)span) mine[d[i].x] += w.x;
    if ((unsigned)d[i].y < (unsigned)span) mine[d[i].y] += w.y;
    if ((unsigned)d[i].z < (unsigned)span) mine[d[i].z] += w.z;
    if ((unsigned)d[i].w < (unsigned)span) mine[d[i].w] += w.w;
    __syncwarp();  // the next row's lanes may add to these positions
  }
  __syncthreads();
  int ulo = planes, uhi = -1;
#pragma unroll
  for (int q = 0; q < kWarps; ++q) {
    ulo = min(ulo, wlo[q]);
    uhi = max(uhi, whi[q]);
  }
  const int32_t* const yb = ybase + (size_t)t * planes;
  for (int i = ulo * kLanes + threadIdx.x; i < (uhi + 1) * kLanes;
       i += kThreads) {
    const int p = i >> 7;
    V sum = V(0);
#pragma unroll
    for (int q = 0; q < kWarps; ++q)
      if (wlo[q] <= p && p <= whi[q]) sum += spans[(size_t)q * span + i];
    const int b = __ldg(yb + p), pos = b + (i & (kLanes - 1));
    if (sum != V(0) && b >= 0 && pos < n_y) atomicAdd(y + pos, sum);
  }
}

// S is the storage type of val and the x panel; out is float.
template <typename S>
__global__ void __launch_bounds__(kThreads) slab_spmm_kernel(
    const int32_t* __restrict__ uids, const int32_t* __restrict__ sg0,
    const int32_t* __restrict__ sg1, const int32_t* __restrict__ win,
    const int8_t* __restrict__ lane, const int8_t* __restrict__ sub,
    const S* __restrict__ val, const int8_t* __restrict__ hm1,
    const int8_t* __restrict__ idx, const S* __restrict__ x,
    float* __restrict__ out, int H, int T, int m, int planes, int B) {
  __shared__ __align__(16) PanelSlot stage[kWarps][kPanelStage];
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= H) return;
  const int t = r / T;
  const int lo = max(sg0[t], 0), hi = min(sg1[t], planes - 1);
  if (lo > hi) return;  // the step routes nothing; uniform over the warp
  const LaneGroups lg(column_tile(B), 1);
  PanelSlot* st = stage[threadIdx.x >> 5];
  stage_row<true, S>(st, lg, r, m, 0, win, lane, sub, val, hm1);
  __syncwarp();
  read_dests(st, lg, idx + ((size_t)lo * H + r) * kLanes, (size_t)H * kLanes,
             hi - lo + 1, (uids[t] * planes + lo) * kLanes);
  __syncwarp();
  route_row<true, S>(st, lg, x, out, B);
}

template <typename S>
int launch_spmm(const void* uids, const void* sg0, const void* sg1,
                const void* win, const void* lane, const void* sub,
                const void* val, const void* hm1, const void* idx,
                const void* x, void* out, int H, int T, int m, int planes,
                int B, void* stream) {
  if (planes < 1 || planes > kMaxUnitPlanes || T < 1 || H < 0 || H % T ||
      B < 1)
    return (int)cudaErrorInvalidValue;
  if (H == 0) return 0;
  slab_spmm_kernel<S><<<(H + kWarps - 1) / kWarps, kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const int32_t*)uids, (const int32_t*)sg0, (const int32_t*)sg1,
      (const int32_t*)win, (const int8_t*)lane, (const int8_t*)sub,
      (const S*)val, (const int8_t*)hm1, (const int8_t*)idx, (const S*)x,
      (float*)out, H, T, m, planes, B);
  return (int)cudaGetLastError();
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

// span 0: a reduction a run end; else the merge kernel, span planes * 128.
// S is the storage type of val and x; y is of acc_t<S>.
template <typename S>
int launch_rows(const void* ybase, const void* win, const void* lane,
                const void* sub, const void* val, const void* hm1,
                const void* dest, const void* x, void* y, int H, int T,
                int m, int planes, int n_y, int span, void* stream) {
  using A = acc_t<S>;
  const size_t smem = (size_t)kWarps * span * sizeof(A);
  if (m < 1 || planes < 1 || planes > kMaxBlkPlanes || T < 1 || H < 0 ||
      H % T || n_y < 0 || (span != 0 && span != planes * kLanes) ||
      smem > kMergeSmem)
    return (int)cudaErrorInvalidValue;
  if (H == 0) return 0;
  if (span == 0) {
    using SlabDest = int16_t;  // the stream's; harness/slab_ab.py times int32
    slab_rows_kernel<S, SlabDest><<<(H + kWarps - 1) / kWarps, kThreads, 0,
                                    (cudaStream_t)stream>>>(
        (const int32_t*)ybase, (const int32_t*)win, (const int8_t*)lane,
        (const int8_t*)sub, (const S*)val, (const int8_t*)hm1,
        (const SlabDest*)dest, (const S*)x, (A*)y, H, T, m, planes, n_y);
    return (int)cudaGetLastError();
  }
  static bool raised = false;  // once: the spans may pass 48 KB
  if (!raised) {
    cudaFuncSetAttribute(slab_rows_merge_kernel<S>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kMergeSmem);
    raised = true;
  }
  const int rpb = rows_per_block(T);
  slab_rows_merge_kernel<S><<<H / rpb, kThreads, smem,
                              (cudaStream_t)stream>>>(
      (const int32_t*)ybase, (const int32_t*)win, (const int8_t*)lane,
      (const int8_t*)sub, (const S*)val, (const int8_t*)hm1,
      (const int16_t*)dest, (const S*)x, (A*)y, T, rpb, m, planes, n_y);
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

// Adds into `y` (n_y values, zeroed by the caller before its first call);
// `ybase` is (H / T, planes) int32, `dest` the (H, 128) int16 run-end
// positions in their step's out block, `x` the (cb, 128) x table; `span` is
// 0 or planes * 128 (the merge kernel; its kWarps spans fit in kMergeSmem).
extern "C" int slab_spmv_rows_f32(const void* ybase, const void* win,
                                  const void* lane, const void* sub,
                                  const void* val, const void* hm1,
                                  const void* dest, const void* x, void* y,
                                  int H, int T, int m, int planes, int n_y,
                                  int span, void* stream) {
  return launch_rows<float>(ybase, win, lane, sub, val, hm1, dest, x, y, H,
                            T, m, planes, n_y, span, stream);
}

extern "C" int slab_spmv_rows_f64(const void* ybase, const void* win,
                                  const void* lane, const void* sub,
                                  const void* val, const void* hm1,
                                  const void* dest, const void* x, void* y,
                                  int H, int T, int m, int planes, int n_y,
                                  int span, void* stream) {
  return launch_rows<double>(ybase, win, lane, sub, val, hm1, dest, x, y, H,
                             T, m, planes, n_y, span, stream);
}

// bfloat16 val and x (2 bytes a value in device memory), float32 y: the
// sums are taken in float and the caller rounds y once.
extern "C" int slab_spmv_rows_bf16(const void* ybase, const void* win,
                                   const void* lane, const void* sub,
                                   const void* val, const void* hm1,
                                   const void* dest, const void* x, void* y,
                                   int H, int T, int m, int planes, int n_y,
                                   int span, void* stream) {
  return launch_rows<bf16>(ybase, win, lane, sub, val, hm1, dest, x, y, H,
                           T, m, planes, n_y, span, stream);
}

// `out` must be zeroed, of (nu * planes * 128, B) floats; `x` is the
// interleaved (cb, 128, B) panel of val's type.
extern "C" int slab_spmm_f32(const void* uids, const void* sg0,
                             const void* sg1, const void* win,
                             const void* lane, const void* sub,
                             const void* val, const void* hm1,
                             const void* idx, const void* x, void* out,
                             int H, int T, int m, int planes, int B,
                             void* stream) {
  return launch_spmm<float>(uids, sg0, sg1, win, lane, sub, val, hm1, idx, x,
                            out, H, T, m, planes, B, stream);
}

// bfloat16 val and x panel (2 bytes a value), float32 out: the caller
// rounds Y once.
extern "C" int slab_spmm_bf16(const void* uids, const void* sg0,
                              const void* sg1, const void* win,
                              const void* lane, const void* sub,
                              const void* val, const void* hm1,
                              const void* idx, const void* x, void* out,
                              int H, int T, int m, int planes, int B,
                              void* stream) {
  return launch_spmm<bf16>(uids, sg0, sg1, win, lane, sub, val, hm1, idx, x,
                           out, H, T, m, planes, B, stream);
}
