// XCH exchange-engine kernels for Hopper (sm_90a), bound through a plain C
// interface (ops/_build.py builds this file with ctypes, ops/xch.py calls
// it).
//
//   xch_route4_rows_kernel<StreamGather<S>, int16_t> and
//     xch_route4_rows_merge_kernel<StreamGather<S>> (xch_fused_rows, the
//     spmv path of xch, of hyb's xch residual, of auto's xch trials and of
//     every DistXch shard) replace, on the spmv path, both passes at once:
//     _xch_mul_kernel and _xch_route4_kernel, the kernels of xch_mul and
//     xch_route4 (singlespmv_tpu/ops/pallas/xch.py:41, :48 and :78, :151),
//     and at S = double their df64 builds _xch_mul_df_kernel and
//     _xch_route4_df_kernel (xch_mul_df and xch_route4_df, :463, :495 and
//     :524, :594).  One launch a pass-2 call gathers x, multiplies in
//     registers and routes the run totals into y: no product grid is
//     written or read.  Each product is the one pass 1 stores (__fmul_rn,
//     __dmul_rn; at bfloat16 the float product rounded once), so the fused
//     launch computes the pair's function product for product;
//   xch_mul_kernel<float> replaces _xch_mul_kernel (xch.py:41 and :48) and
//     xch_route4_rows_kernel<GridProducts<float>, int16_t> and
//     xch_route4_rows_merge_kernel<GridProducts<float>> replace
//     _xch_route4_kernel (xch.py:78 and :151), routed by a run-end
//     destination stream that formats/xch.py:route_rows derives from the
//     TPU's idx planes: the pair, which now runs only in the driver's
//     profiling phases (Mul, then Sum) and in the calibration;
//   xch_mul_kernel<double> and the two route kernels at <double> replace
//     _xch_mul_df_kernel and _xch_route4_df_kernel (xch.py:463, :495 and
//     :524, :594) there: the same functions at native fp64, where the TPU
//     carried (hi, lo) float planes through Dekker products and a
//     compensated per-(plane, row) route;
//   xch_route4_kernel<float> and <double>, the first port of _xch_route4_kernel
//     on the TPU's idx planes, are on no path: they stay as the "as before"
//     variant of harness/xch_ab.py;
//   xch_mul_panel_kernel<S, V> and xch_route4_panel_kernel<S> replace
//     _xch_mul_panel_kernel and _xch_route4_panel_kernel, the kernels of
//     xch_mul_panel and xch_route4_panel (singlespmv_tpu/ops/pallas/xch.py:313,
//     :338 and :364, :424): both passes over a panel of B columns, at float
//     and at bfloat16 as the TPU ran them.  At bfloat16 val, the x panel and
//     the product panel are 2 bytes a value, each product rounded once to
//     bfloat16 as the TPU's panel rounds it to val's type; the route sums
//     in float into a float out, which the caller rounds once;
//   xch_mul_kernel<bf16> and the two route kernels at <bf16> run the
//     same functions on bfloat16 values, x and product grid (2 bytes a
//     slot in device memory), every sum in float into a float y;
//   xch_route_kernel<G, float> and <G, bf16> (G 8 or 16) replace
//     _xch_route_kernel, the kernel of xch_route
//     (singlespmv_tpu/ops/pallas/xch.py:197 and :259): the v3 sigma-plane
//     route, redesigned for Hopper on the lane-owned register accumulators
//     of unit_acc.cuh (below).  It runs on the v3 format path
//     (formats/xch.py:_route_phase, after xch_mul writes the product grid)
//     at float and at bfloat16, where it reads the bfloat16 grid (2 bytes a
//     product) and sums in float into a float out, and in the calibration's
//     route_slot_s fit; the TPU had no df64 build of it.  Its bound counts
//     the streams, the idx planes of the routed plane groups, the product
//     grid once and the out rows once (chip_smoke.py:_v3_calls).
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
// The spmv route (redesigned for Hopper).  Per stream row r in step t it
// gathers and takes run totals as pass 2 does, then the lane that holds end
// slot e of a run adds W[e] to
//   y[base[t] + dest[r,e]]   (dest >= 0; -1 on every slot that ends no run)
// with a native global reduction (atomicAdd whose result is unused: RED.ADD).
// base[t] is the y position of the step's out row 0 and dest the run's
// position relative to it, (sig[r] + j) * 128 + l where idx[j,r,l] == e:
// route_rows computes both on the host, at convert time, from the TPU's
// arrays, and keeps only the positions the one-hot keeps, in y.  A warp owns
// a row and reads one 8-byte group of four int16 dests a lane: there is no
// shared accumulator, no zero pass, no flush, no block barrier, and no read
// of sig or idx, whose kblk planes (16 bytes a slot at kblk 16) carried the
// TPU's (p_oh, T) one-hot matmul.  Bound: the streams once (lane, hm1, sub
// when m > 1, two bytes of dest a slot, win a row, base and cs a step), one
// gathered product a slot and y once; bytes.  On an H100 its time follows
// the run ends instead, one reduction into L2 each (42-53 G a second,
// harness/xch_ab.py), and plain stores in their place are no faster.
//   Where many stream rows of a step end runs of the same few y rows (the
// nested long-row state: webbase-1M's puts ~2,100 run ends on each of its
// 960 y rows), one reduction a run end would queue thousands of them on
// one address.  There route_rows sets a merge span (p_oh * 128, where a
// block's rows end on average at least MERGE_HITS runs on each row of their
// band and kWarps spans fit in kMergeSmem; formats/xch.py) and the merge
// kernel takes a block of rpb rows of one step:
// each warp adds its rows' run totals into a span of its own in shared
// memory, with plain adds (the run ends of a row have distinct dests, and
// the warp's rows follow each other), then the block sums the kWarps spans
// and adds each nonzero sum into y: one reduction a position a block.
//
// Design of the first port.  The TPU walks the steps in order and zeroes a
// group's out block when gids changes.  A group's steps are contiguous within a
// call and never split across calls, so zeroing all of `out` in the wrapper and
// accumulating with atomics computes the same function.  A block of 8 warps
// takes `rpb` rows of one step (rpb divides T), so it shares gids[t], off[t]
// and cs[t]; it collects routed totals in a (p_oh, 128) shared accumulator and
// adds the nonzero entries of the rows its stream rows can reach to the out
// block with global atomics.  The order of the sums, and so their rounding,
// varies from run to run.  The per-warp row buffers are static shared memory (4
// KB in float, 8 KB in double).  The accumulator takes p_oh * 128 values: in
// float a static array of the largest p_oh, 32 KB; in double 64 KB at p_oh 64,
// past the 48 KB static limit, so there it is dynamic shared memory sized by
// p_oh at launch, and the launcher raises the kernel's dynamic shared-memory
// cap once.  The two stay separate arrays declared in the kernel: carved out of
// one dynamic array they cost the float route 4-10% (the compiler, no longer
// sure that the atomics into the accumulator leave the row buffer alone,
// unrolled the route loop less).
//
// The panels (redesigned for Hopper).  Both passes take interleaved
// panels, where a slot's B column values are contiguous: x (cb, 128, B),
// the products (n_chunks, p1, 128, B), written by pass 1 as (H, 128, B) per
// call, and out (n_out, 128, B), which is Y's own (rows, B) layout inside a
// group's rows.  Both run panel_row.cuh's lane groups.  Pass 1 stages a
// row's 128 slots once, then each group takes one slot a step, gathers its
// columns in one access (a lane takes 4 adjacent columns with 16-byte
// loads and stores where B is a multiple of 4) and writes their products:
// the warp's writes are one contiguous run of the row's 128 * B products.
// Pass 2 stages the row, reads each of its kblk idx planes once per row
// (not once per column) to give every routed end lane its out row, then
// walks the row's slots per group of C lanes (the power of two up to 32
// that covers B) with one coalesced gather of a slot's products, takes
// the run totals once for all columns of the tile, and adds each run total
// straight into the out rows with global atomics (C consecutive floats per
// run end, one coalesced access).  There is no
// shared accumulator: a (span, 128, B) one at p_oh 64 and B 16 would take
// 512 KB, past the 227 KB a block may hold, and tiling its columns would
// read the streams once per tile, as the first port did (2 to 8 columns a
// pass); a float atomicAdd to shared memory is a compare-and-swap loop on
// sm_90 (see slab.cu), and a pass-2 out position takes few run ends per
// step (a y row's entries rarely span stream rows), so merging them there
// first would save few of the native global reductions.  The route keeps
// a lane per column: lanes of 4 columns (16-byte gathers) would make each
// run end 4 atomic instructions of 2 lanes instead of one of 8.
// Out rows past n_grp * gb are dropped, as in the spmv route (the Pallas
// panel kernel writes out[:, off:off+p_oh] unclipped).  A warp takes one
// row, so blocks need not share a step.  Bound: pass 1 the streams once,
// the x panel once and the products once; pass 2 the streams once, one
// gathered product per slot and column (the product panel of a large
// matrix outgrows L2, so these come from device memory) and the out rows
// once; bytes both.  At bfloat16 val, the x panel and the product panel
// take 2 bytes a value (a lane's 4 columns one 8-byte access), out stays
// float: pass 1's bytes fall by nearly half, pass 2's by the gathered
// products' half.
//
// The v3 route.  Per stream row r in step t it gathers from the products of
// chunk cs[t] and takes run totals as pass 2 does, then for each plane s of
// the active pg-groups
//   out[uids[t]*planes + s, l] += W[idx[s,r,l]]   (idx >= 0).
// The TPU kernel adds a step's planes at in-block offset
// (uids[t] - gids[t]*g_grp)*planes of the out block gids[t], which holds
// g_grp*planes rows: the two add up to row uids[t]*planes, so gids only
// named the TPU's out block and the kernel never reads it.  A group of pg
// planes [g0, g0 + n_p) is routed when sg0[t] < g0 + n_p and sg1[t] >= g0,
// the TPU kernel's pl.when, so a step routes every plane of a group that
// meets its range and none when no group does; the groups that do are
// contiguous, planes [lo, hi] (active_planes).  The wrapper zeroes out,
// which stands in for the TPU's zeroed block on a new gids, and rows past
// its end are dropped.
//
// Design of the v3 route (redesigned for Hopper): the lane-owned unit
// accumulators of unit_acc.cuh.  S, the products' storage type, only
// changes the gather: gather4<bf16> widens four 2-byte products to float,
// as the v4 route's <bf16> build does, and the run totals, the registers
// and out stay float.  A block takes a chunk of R rows and walks
// it a segment (one unit's steps) at a time, a warp a row; each row's
// active planes come from its own step's sg0/sg1.  Lane k keeps columns
// 4k..4k+3 of G planes in registers (G = 8 for up to 8 planes, else 16;
// past 16 planes the block walks the segment's rows once a group of 16),
// the block sums its warps' partials in shared memory (64 KB at G 16) and
// adds each float4 of the planes that the segment's steps route into out
// once, by one reduction.  The first port (a block rpb <= 32 rows of one
// step, a (planes, 128) accumulator of shared float atomics, a global
// atomic an entry a block) is the "first port" variant of
// harness/route_ab.py.
//
// The fused route (xch_fused_rows).  Each nonzero has one pass-1 slot and
// one pass-2 slot, so the exchange is a fixed map from each pass-2 slot to
// the pass-1 slot whose product it reads, P = (cs[t] * p1 + win2[r] +
// sub2[r,l]) * 128 + lane2[r,l].  route_rows composes it at convert time
// into a stream in pass 2's order: val2[r,l] = val1[P] and col2[r,l] =
// (win1[P / 128] + sub1[P]) * 128 + lane1[P], padding slots included (a
// position in the x table's zero padding gets col2 0 and val2 0).  The
// producer StreamGather reads them (one 16-byte load of four col2 and one
// of four val2 a lane), gathers x itself (no x table) and hands the
// products to the same scan (lane_totals), run-end adds (add_run) and
// merge kernel as the pair's route (GridProducts).  Bound: val2 (4 B, 8 B
// at double, 2 B at bfloat16), col2 4 B, hm1 1 B and dest 2 B a slot, base
// a step, x once and y once, where the pair moved val, lane, sub, the
// product written and gathered back, lane, sub and hm1 of pass 2: 11 bytes
// a slot in float against 17-19.  On an H100 the reductions, one a run end
// into L2 at 42-53 G a second (harness/xch_ab.py), are expected to set its
// pace rather than its bytes; the fusion removes pass 1's launch and the
// grid's traffic, not those reductions.  x is gathered in pass 2's row
// order, so pass 1's window locality is gone; the x of the main path's
// stand-ins fits in L2.
//
// Bound.  Pass 1 streams 4 B of val (8 B at double) and 1 B of lane per slot
// (2 B when m > 1) and writes 4 B (8 B) of product; x is gathered from L2.
// The spmv route streams 4 B of lane, hm1 and dest per slot (5 B when
// m > 1), where the first port streamed 3 B of lane, hm1, sig (4 B when
// m > 1) and kblk B of idx; both gather the products, which pass 1 has just
// written and which stay in L2 (50 MB) unless the product grid is larger.
// Both passes are streaming kernels bound by device memory bandwidth.  The
// v3 route streams 2 B of lane and hm1 per slot (3 B when m > 1) and one
// byte of idx per slot and active plane, so its bytes grow with the planes:
// at calibrate's H 16,384 and 16 planes idx is 32 MB of its ~40 MB, a
// bound of ~12 us.
// This first version aims to be right: no TMA, no wgmma, no software
// pipelining.

#include "panel_row.cuh"
#include "unit_acc.cuh"

namespace {

constexpr int kMaxWindow = 120;  // the planner's M_MAX: int8 sub headroom
constexpr int kMaxPoh = 64;      // the planner's largest one-hot width
constexpr int kMaxRoutePlanes = 64;  // v3: span 2 x 32 planes

// S is the storage type of val, x and the products: at bfloat16 the
// product of two bfloat16 values, exact in float, is rounded once to
// bfloat16, as the TPU's bfloat16 multiply rounds it.
template <typename S>
__global__ void __launch_bounds__(kThreads) xch_mul_kernel(
    const int32_t* __restrict__ win, const int8_t* __restrict__ lane,
    const int8_t* __restrict__ sub, const S* __restrict__ val,
    const S* __restrict__ x, S* __restrict__ out, int H, int m) {
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= H) return;
  const size_t off = (size_t)r * kLanes + 4 * (threadIdx.x & 31);
  store4(out + off, mul4(load4(val + off), gather4(r, m, win, lane, sub, x)));
}

// Dynamic shared memory of the route kernel: none in float, the (p_oh, 128)
// accumulator in double.
template <typename V>
size_t route_smem_bytes(int p_oh) {
  return sizeof(V) == sizeof(float) ? 0 : (size_t)p_oh * kLanes * sizeof(V);
}

template <typename V>
__global__ void __launch_bounds__(kThreads) xch_route4_kernel(
    const int32_t* __restrict__ gids, const int32_t* __restrict__ off,
    const int32_t* __restrict__ cs, const int32_t* __restrict__ win,
    const int8_t* __restrict__ lane, const int8_t* __restrict__ sub,
    const int8_t* __restrict__ hm1, const int8_t* __restrict__ sig,
    const int8_t* __restrict__ idx, const V* __restrict__ prod,
    V* __restrict__ out, int H, int T, int rpb, int m, int kblk,
    int p_oh, int gb, int p1, long long n_out) {
  __shared__ __align__(16) V wbuf[kWarps][kLanes];
  V* acc;
  if constexpr (sizeof(V) == sizeof(float)) {
    __shared__ float acc_f[kMaxPoh * kLanes];
    acc = acc_f;
  } else {
    extern __shared__ double acc_d[];
    acc = acc_d;
  }
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
    acc[i] = V(0);
  __syncthreads();
  const V* x = prod + (size_t)cs[t] * p1 * kLanes;
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

// y[pos] += v for a run end (d >= 0) inside y.
template <typename V>
__device__ __forceinline__ void add_run(V* __restrict__ y, int b, int d, V v,
                                        int n_y) {
  const int pos = b + d;
  if (d >= 0 && pos < n_y) atomicAdd(y + pos, v);  // result unused: RED.ADD
}

// The spmv route's producers: the four values of stream row r that the
// calling lane holds (slots 4k..4k+3), in the accumulator type V.
//   GridProducts reads them from pass 1's product grid, through the
//   exchange (cs, win, lane, sub of pass 2: the pair's route);
//   StreamGather makes them in registers from the pass-2-ordered stream
//   that formats/xch.py:route_rows derives at convert time: four val2
//   values and one 16-byte group of four col2 a lane, x gathered at col2,
//   each product rounded as pass 1 stores it (stored_products).
template <typename S>
struct GridProducts {
  using V = acc_t<S>;
  const int32_t* cs;
  const int32_t* win;
  const int8_t* lane;
  const int8_t* sub;
  const S* prod;
  int T, m, p1;
  __device__ __forceinline__ V4<S> operator()(int r) const {
    return gather4<S>(r, m, win, lane, sub,
                      prod + (size_t)__ldg(cs + r / T) * p1 * kLanes);
  }
};

// val * x slot by slot, as xch_mul_kernel stores the product: rounded to
// float (__fmul_rn) or to double (__dmul_rn), never contracted into an FMA
// with the scan's first add; at bfloat16 the float product (exact) rounded
// once to bfloat16 and widened back.
__device__ __forceinline__ float4 stored_products(const float*, float4 v,
                                                  float4 g) {
  return make_float4(__fmul_rn(v.x, g.x), __fmul_rn(v.y, g.y),
                     __fmul_rn(v.z, g.z), __fmul_rn(v.w, g.w));
}

__device__ __forceinline__ Double4 stored_products(const double*, Double4 v,
                                                   Double4 g) {
  return {__dmul_rn(v.x, g.x), __dmul_rn(v.y, g.y), __dmul_rn(v.z, g.z),
          __dmul_rn(v.w, g.w)};
}

__device__ __forceinline__ float4 stored_products(const bf16*, float4 v,
                                                  float4 g) {
  const float4 p = stored_products((const float*)nullptr, v, g);
  return make_float4(__bfloat162float(__float2bfloat16_rn(p.x)),
                     __bfloat162float(__float2bfloat16_rn(p.y)),
                     __bfloat162float(__float2bfloat16_rn(p.z)),
                     __bfloat162float(__float2bfloat16_rn(p.w)));
}

template <typename S>
struct StreamGather {
  using V = acc_t<S>;
  const S* val;
  const int32_t* col;
  const S* x;
  __device__ __forceinline__ V4<S> operator()(int r) const {
    const size_t off = (size_t)r * kLanes + 4 * (threadIdx.x & 31);
    const int4 c = *reinterpret_cast<const int4*>(col + off);
    const V4<S> g = {ldg_acc(x + c.x), ldg_acc(x + c.y), ldg_acc(x + c.z),
                     ldg_acc(x + c.w)};
    return stored_products(val, load4(val + off), g);
  }
};

// P is the producer (GridProducts or StreamGather of storage type S); y and
// the sums are of acc_t<S>.  A warp a stream row.
template <typename P, typename D>
__global__ void __launch_bounds__(kThreads) xch_route4_rows_kernel(
    const P prod, const int32_t* __restrict__ base,
    const int8_t* __restrict__ hm1, const D* __restrict__ dest,
    typename P::V* __restrict__ y, int H, int T, int n_y) {
  using V = typename P::V;
  __shared__ __align__(16) V wbuf[kWarps][kLanes];
  const int warp = threadIdx.x >> 5;
  const int r = blockIdx.x * kWarps + warp;
  if (r >= H) return;  // uniform over the warp
  const size_t off = (size_t)r * kLanes + 4 * (threadIdx.x & 31);
  const int4 d = load_dest4(dest + off);
  const int b = __ldg(base + r / T);
  const V4<V> w = lane_totals<V>(prod(r), load_c4(hm1 + off), wbuf[warp]);
  add_run(y, b, d.x, w.x, n_y);
  add_run(y, b, d.y, w.y, n_y);
  add_run(y, b, d.z, w.z, n_y);
  add_run(y, b, d.w, w.w, n_y);
}

constexpr int kMergeSmem = 96 * 1024;  // the merge kernel's spans, at most

template <typename P>
__global__ void __launch_bounds__(kThreads) xch_route4_rows_merge_kernel(
    const P prod, const int32_t* __restrict__ base,
    const int8_t* __restrict__ hm1, const int16_t* __restrict__ dest,
    typename P::V* __restrict__ y, int T, int rpb, int n_y, int span) {
  using V = typename P::V;
  __shared__ __align__(16) V wbuf[kWarps][kLanes];
  extern __shared__ __align__(16) unsigned char merge_smem[];
  V* const spans = reinterpret_cast<V*>(merge_smem);  // (kWarps, span)
  const int warp = threadIdx.x >> 5, k = threadIdx.x & 31;
  const int r0 = blockIdx.x * rpb;  // rpb divides T: one step
  const int t = r0 / T;
  V* const mine = spans + (size_t)warp * span;
  for (int i = k; i < span; i += 32) mine[i] = V(0);
  __syncwarp();
  for (int r = r0 + warp; r < r0 + rpb; r += kWarps) {
    const size_t off = (size_t)r * kLanes + 4 * k;
    const int4 d = load_dest4(dest + off);
    const V4<V> w = lane_totals<V>(prod(r), load_c4(hm1 + off), wbuf[warp]);
    if ((unsigned)d.x < (unsigned)span) mine[d.x] += w.x;
    if ((unsigned)d.y < (unsigned)span) mine[d.y] += w.y;
    if ((unsigned)d.z < (unsigned)span) mine[d.z] += w.z;
    if ((unsigned)d.w < (unsigned)span) mine[d.w] += w.w;
    __syncwarp();  // the next row's lanes may add to these positions
  }
  __syncthreads();
  const int b = base[t];
  for (int i = threadIdx.x; i < span; i += kThreads) {
    V sum = V(0);
#pragma unroll
    for (int q = 0; q < kWarps; ++q) sum += spans[(size_t)q * span + i];
    if (sum != V(0) && b + i < n_y) atomicAdd(y + b + i, sum);
  }
}

// S is the storage type of val, the x panel and the product panel; each
// product is taken in float (exact for two bfloat16) and stored rounded to
// S once (store_cols).
template <typename S, int V>
__global__ void __launch_bounds__(kThreads) xch_mul_panel_kernel(
    const int32_t* __restrict__ win, const int8_t* __restrict__ lane,
    const int8_t* __restrict__ sub, const S* __restrict__ val,
    const S* __restrict__ x, S* __restrict__ out, int H, int m, int B) {
  __shared__ __align__(16) PanelSlot stage[kWarps][kPanelStage];
  const int warp = threadIdx.x >> 5;
  const int r = blockIdx.x * kWarps + warp;
  if (r >= H) return;
  const LaneGroups lg(column_tile(B, V), V);
  PanelSlot* st = stage[warp];
  stage_row<true, S>(st, lg, r, m, 0, win, lane, sub, val, nullptr);
  __syncwarp();
  // a step writes G consecutive slots' products: one contiguous run;
  // kWalkBatch steps' gathers are in flight together
  S* orow = out + (size_t)r * kLanes * B;
  for (int b = lg.c; b < B; b += lg.C)
    for (int l0 = lg.g; l0 < kLanes; l0 += kWalkBatch * lg.G) {
      float xv[kWalkBatch][V], v[kWalkBatch];
#pragma unroll
      for (int u = 0; u < kWalkBatch; ++u) {
        const int l = l0 + u * lg.G;
        const PanelSlot q = st[lg.pos(l < kLanes ? l : 0)];
        load_cols<V>(x + (size_t)q.col * B + b, xv[u]);
        v[u] = q.val;
      }
#pragma unroll
      for (int u = 0; u < kWalkBatch; ++u) {
        const int l = l0 + u * lg.G;
        if (l >= kLanes) continue;
        float p[V];
#pragma unroll
        for (int j = 0; j < V; ++j) p[j] = v[u] * xv[u][j];
        store_cols<V>(orow + (size_t)l * B + b, p);
      }
    }
}

// S is the storage type of the product panel; the run sums and out are
// float.
template <typename S>
__global__ void __launch_bounds__(kThreads) xch_route4_panel_kernel(
    const int32_t* __restrict__ gids, const int32_t* __restrict__ off,
    const int32_t* __restrict__ cs, const int32_t* __restrict__ win,
    const int8_t* __restrict__ lane, const int8_t* __restrict__ sub,
    const int8_t* __restrict__ hm1, const int8_t* __restrict__ sig,
    const int8_t* __restrict__ idx, const S* __restrict__ prod,
    float* __restrict__ out, int H, int T, int m, int kblk, int p_oh,
    int gb, int p1, int B, int n_out) {
  __shared__ __align__(16) PanelSlot stage[kWarps][kPanelStage];
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= H) return;
  const int t = r / T;
  // out row of one-hot row 0; rows before it or past the end are dropped
  const long long base = (long long)gids[t] * gb + off[t];
  if (base < 0) return;
  const LaneGroups lg(column_tile(B), 1);
  PanelSlot* st = stage[threadIdx.x >> 5];
  stage_row<false, S>(st, lg, r, m, cs[t] * p1 * kLanes, win, lane, sub,
                      nullptr, hm1);
  __syncwarp();
  // the planes j whose one-hot row s + j lies in [0, p_oh) and whose out
  // row lies in [base, n_out)
  const int s = sig[(size_t)r * kLanes];  // lane-replicated: slot 0 holds it
  const int j0 = max(-s, 0);
  const int j1 = (int)min((long long)min(kblk, p_oh - s), n_out - base - s);
  if (j0 < j1)
    read_dests(st, lg, idx + ((size_t)j0 * H + r) * kLanes,
               (size_t)H * kLanes, j1 - j0, (int)(base + s + j0) * kLanes);
  __syncwarp();
  route_row<false, S>(st, lg, prod, out, B);
}

template <typename S>
int launch_mul_panel(const void* win, const void* lane, const void* sub,
                     const void* val, const void* x, void* out, int H, int T,
                     int m, int B, void* stream) {
  if (m < 1 || m > kMaxWindow || T < 1 || H < 0 || H % T || B < 1)
    return (int)cudaErrorInvalidValue;
  if (H == 0) return 0;
  // lanes of 4 columns (16-byte gathers and stores of float, 8-byte ones
  // of bfloat16) where B allows
  const int grid = (H + kWarps - 1) / kWarps;
  if (B % 4)
    xch_mul_panel_kernel<S, 1><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)win, (const int8_t*)lane, (const int8_t*)sub,
        (const S*)val, (const S*)x, (S*)out, H, m, B);
  else
    xch_mul_panel_kernel<S, 4><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)win, (const int8_t*)lane, (const int8_t*)sub,
        (const S*)val, (const S*)x, (S*)out, H, m, B);
  return (int)cudaGetLastError();
}

template <typename S>
int launch_route4_panel(const void* gids, const void* off, const void* cs,
                        const void* win, const void* lane, const void* sub,
                        const void* hm1, const void* sig, const void* idx,
                        const void* prod, void* out, int H, int T, int m,
                        int kblk, int p_oh, int n_grp, int gb, int p1, int B,
                        int n_chunks, void* stream) {
  // an out position (row * 128 + lane) and a product row are ints
  const long long n_out = (long long)n_grp * gb;
  if (m < 1 || m > kMaxWindow || kblk < 1 || p_oh < 1 || p_oh > kMaxPoh ||
      T < 1 || H < 0 || H % T || n_grp < 0 || gb < 1 || p1 < 1 || B < 1 ||
      n_chunks < 1 || n_out * kLanes > INT32_MAX ||
      (long long)n_chunks * p1 * kLanes > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  if (H == 0) return 0;
  xch_route4_panel_kernel<S><<<(H + kWarps - 1) / kWarps, kThreads, 0,
                               (cudaStream_t)stream>>>(
      (const int32_t*)gids, (const int32_t*)off, (const int32_t*)cs,
      (const int32_t*)win, (const int8_t*)lane, (const int8_t*)sub,
      (const int8_t*)hm1, (const int8_t*)sig, (const int8_t*)idx,
      (const S*)prod, (float*)out, H, T, m, kblk, p_oh, gb, p1, B,
      (int)n_out);
  return (int)cudaGetLastError();
}

// The planes [lo, hi] of the pg-groups that a step with sg0 = s0 and
// sg1 = s1 routes, lo > hi for none: group g0 = j * pg of n_p planes routes
// when s0 < g0 + n_p and s1 >= g0, so j runs from s0 / pg to
// min(s1, planes - 1) / pg (ops/xch.py:active_plane_range).
__device__ __forceinline__ int2 active_planes(int s0, int s1, int planes,
                                              int pg) {
  if (s1 < 0 || s0 >= planes) return make_int2(0, -1);
  const int jlo = s0 < 0 ? 0 : s0 / pg, jhi = min(s1, planes - 1) / pg;
  if (jlo > jhi) return make_int2(0, -1);
  return make_int2(jlo * pg, min((jhi + 1) * pg, planes) - 1);
}

__device__ __forceinline__ unsigned long long plane_bits(int2 p) {
  if (p.x > p.y) return 0ull;
  const int n = p.y - p.x + 1;
  return (n == 64 ? ~0ull : (1ull << n) - 1) << p.x;
}

// S is the storage type of the products (float or bf16); the run totals,
// the accumulators and out are float.
template <int G, typename S>
__global__ void __launch_bounds__(kThreads) xch_route_kernel(
    const int32_t* __restrict__ uids, const int32_t* __restrict__ cs,
    const int32_t* __restrict__ sg0, const int32_t* __restrict__ sg1,
    const int32_t* __restrict__ win, const int8_t* __restrict__ lane,
    const int8_t* __restrict__ sub, const int8_t* __restrict__ hm1,
    const int8_t* __restrict__ idx, const S* __restrict__ prod,
    float* __restrict__ out, int H, int T, int R, int m, int planes,
    int pg, int p1, long long n_out) {
  extern __shared__ float4 part4[];  // (kWarps, G, 128) partials
  float* part = reinterpret_cast<float*>(part4);
  __shared__ __align__(16) float wbuf[kWarps][kLanes];
  const int warp = threadIdx.x >> 5, k = threadIdx.x & 31;
  const int r0 = blockIdx.x * R;
  const int t1 = min(r0 + R, H) / T;
  LaneAcc<G> acc;
  acc.init(part);
  for (int t = r0 / T; t < t1;) {
    const int e = segment_end(uids, t, t1);
    const int u = __ldg(uids + t);
    const long long base = (long long)u * planes;  // out row of plane 0
    // the planes that the segment's steps route, below out's end
    unsigned long long routed = 0;
    if (base >= 0 && base < n_out) {
      for (int s = t; s < e; ++s)
        routed |= plane_bits(
            active_planes(__ldg(sg0 + s), __ldg(sg1 + s), planes, pg));
      if (n_out - base < 64) routed &= (1ull << (n_out - base)) - 1;
    }
    for (int p0 = 0; routed >> p0; p0 += G) {  // uniform over the block
      if (!((routed >> p0) & ((1ull << G) - 1))) continue;
      for (int r = t * T + warp; r < e * T; r += kWarps) {
        const int st = r / T;
        const int2 act = active_planes(__ldg(sg0 + st), __ldg(sg1 + st),
                                       planes, pg);
        if (act.y < p0 || act.x >= p0 + G) continue;  // uniform over the warp
        // every active plane's end lanes first: their loads overlap the
        // gather
        uint32_t ends[G];
#pragma unroll
        for (int s = 0; s < G; ++s)
          ends[s] = p0 + s >= act.x && p0 + s <= act.y
                        ? load_ends(idx + ((size_t)(p0 + s) * H + r) * kLanes +
                                    4 * k)
                        : kNoEnds;
        const S* x = prod + (size_t)__ldg(cs + st) * p1 * kLanes;
        run_totals<float>(r, gather4<S>(r, m, win, lane, sub, x), hm1,
                          wbuf[warp]);
#pragma unroll
        for (int s = 0; s < G; ++s) acc.route(s, ends[s], wbuf[warp]);
      }
      acc.stage(G);
      float* ob = out + (base + p0) * kLanes;
      const unsigned long long group = routed >> p0;
      reduce_unit<G>(part, G * kLanes / 4, [&](int i, float4 s) {
        if ((group >> (i >> 5)) & 1) red4(ob + 4 * i, s);
      });
      if (p0 + G >= 64) break;
    }
    t = e;
  }
}

template <int G, typename S>
int launch_route(const void* uids, const void* cs, const void* sg0,
                 const void* sg1, const void* win, const void* lane,
                 const void* sub, const void* hm1, const void* idx,
                 const void* prod, void* out, int H, int T, int R, int m,
                 int planes, int pg, int p1, int n_out, cudaStream_t stream) {
  static int allowed[kMaxUnitDevices] = {};
  const int smem = kWarps * G * kLanes * 4;
  const cudaError_t err =
      allow_unit_smem((const void*)xch_route_kernel<G, S>, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  xch_route_kernel<G, S><<<(H + R - 1) / R, kThreads, smem, stream>>>(
      (const int32_t*)uids, (const int32_t*)cs, (const int32_t*)sg0,
      (const int32_t*)sg1, (const int32_t*)win, (const int8_t*)lane,
      (const int8_t*)sub, (const int8_t*)hm1, (const int8_t*)idx,
      (const S*)prod, (float*)out, H, T, R, m, planes, pg, p1,
      (long long)n_out);
  return (int)cudaGetLastError();
}

// The v3 route over products of storage type S: G 8 up to 8 planes, else
// 16 (a block walks a segment's rows once a group of 16 planes).
template <typename S>
int launch_route_planes(const void* uids, const void* cs, const void* sg0,
                        const void* sg1, const void* win, const void* lane,
                        const void* sub, const void* hm1, const void* idx,
                        const void* prod, void* out, int H, int T, int m,
                        int planes, int pg, int p1, int n_out, int R,
                        void* stream) {
  if (m < 1 || m > kMaxWindow || planes < 1 || planes > kMaxRoutePlanes ||
      pg < 1 || T < 1 || H < 0 || H % T || p1 < 1 || n_out < 0 || R < T ||
      R % T)
    return (int)cudaErrorInvalidValue;
  if (H == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (planes <= 8)
    return launch_route<8, S>(uids, cs, sg0, sg1, win, lane, sub, hm1, idx,
                              prod, out, H, T, R, m, planes, pg, p1, n_out,
                              st);
  return launch_route<16, S>(uids, cs, sg0, sg1, win, lane, sub, hm1, idx,
                             prod, out, H, T, R, m, planes, pg, p1, n_out,
                             st);
}

// Lets the route kernel take the dynamic shared memory of the largest p_oh
// (once; double only); returns cudaGetLastError().
template <typename V>
int raise_route_smem() {
  static bool raised = false;
  if (!raised && route_smem_bytes<V>(kMaxPoh) > 0) {
    cudaFuncSetAttribute(xch_route4_kernel<V>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)route_smem_bytes<V>(kMaxPoh));
    raised = true;
  }
  return (int)cudaGetLastError();
}

template <typename V>
int launch_mul(const void* win, const void* lane, const void* sub,
               const void* val, const void* x, void* out, int H, int T,
               int m, void* stream) {
  if (m < 1 || m > kMaxWindow || T < 1 || H < 0 || H % T)
    return (int)cudaErrorInvalidValue;
  if (H == 0) return 0;
  xch_mul_kernel<V><<<(H + kWarps - 1) / kWarps, kThreads, 0,
                      (cudaStream_t)stream>>>(
      (const int32_t*)win, (const int8_t*)lane, (const int8_t*)sub,
      (const V*)val, (const V*)x, (V*)out, H, m);
  return (int)cudaGetLastError();
}

template <typename V>
int launch_route4(const void* gids, const void* off, const void* cs,
                  const void* win, const void* lane, const void* sub,
                  const void* hm1, const void* sig, const void* idx,
                  const void* prod, void* out, int H, int T, int m, int kblk,
                  int p_oh, int n_grp, int gb, int p1, void* stream) {
  if (m < 1 || m > kMaxWindow || kblk < 1 || p_oh < 1 || p_oh > kMaxPoh ||
      T < 1 || H < 0 || H % T || n_grp < 0 || gb < 1 || p1 < 1)
    return (int)cudaErrorInvalidValue;
  if (H == 0) return 0;
  const int rc = raise_route_smem<V>();
  if (rc) return rc;
  const int rpb = rows_per_block(T);
  xch_route4_kernel<V><<<H / rpb, kThreads, route_smem_bytes<V>(p_oh),
                         (cudaStream_t)stream>>>(
      (const int32_t*)gids, (const int32_t*)off, (const int32_t*)cs,
      (const int32_t*)win, (const int8_t*)lane, (const int8_t*)sub,
      (const int8_t*)hm1, (const int8_t*)sig, (const int8_t*)idx,
      (const V*)prod, (V*)out, H, T, rpb, m, kblk, p_oh, gb, p1,
      (long long)n_grp * gb);
  return (int)cudaGetLastError();
}

// span 0: a reduction a run end; else the merge kernel over `span` dests.
// P is the producer; y is of P::V.
template <typename P>
int launch_rows(const P prod, const void* base, const void* hm1,
                const void* dest, void* y, int H, int T, int n_y, int span,
                void* stream) {
  using V = typename P::V;
  const size_t smem = (size_t)kWarps * span * sizeof(V);
  if (T < 1 || H < 0 || H % T || n_y < 0 || span < 0 || span % kLanes ||
      smem > kMergeSmem)
    return (int)cudaErrorInvalidValue;
  if (H == 0) return 0;
  if (span == 0) {
    using Dest = int16_t;  // the stream's; harness/xch_ab.py times int32
    xch_route4_rows_kernel<P, Dest><<<(H + kWarps - 1) / kWarps, kThreads,
                                      0, (cudaStream_t)stream>>>(
        prod, (const int32_t*)base, (const int8_t*)hm1, (const Dest*)dest,
        (V*)y, H, T, n_y);
    return (int)cudaGetLastError();
  }
  static bool raised = false;  // once: the spans may pass 48 KB
  if (!raised) {
    cudaFuncSetAttribute(xch_route4_rows_merge_kernel<P>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kMergeSmem);
    raised = true;
  }
  const int rpb = rows_per_block(T);
  xch_route4_rows_merge_kernel<P><<<H / rpb, kThreads, smem,
                                    (cudaStream_t)stream>>>(
      prod, (const int32_t*)base, (const int8_t*)hm1, (const int16_t*)dest,
      (V*)y, T, rpb, n_y, span);
  return (int)cudaGetLastError();
}

// S is the storage type of the products; y is of acc_t<S>.
template <typename S>
int launch_route4_rows(const void* base, const void* cs, const void* win,
                       const void* lane, const void* sub, const void* hm1,
                       const void* dest, const void* prod, void* y, int H,
                       int T, int m, int p1, int n_y, int span,
                       void* stream) {
  if (m < 1 || m > kMaxWindow || p1 < 1) return (int)cudaErrorInvalidValue;
  const GridProducts<S> p{(const int32_t*)cs, (const int32_t*)win,
                          (const int8_t*)lane, (const int8_t*)sub,
                          (const S*)prod, T, m, p1};
  return launch_rows(p, base, hm1, dest, y, H, T, n_y, span, stream);
}

// S is the storage type of val2 and x; y is of acc_t<S>.
template <typename S>
int launch_fused_rows(const void* base, const void* val2, const void* col2,
                      const void* hm1, const void* dest, const void* x,
                      void* y, int H, int T, int n_y, int span,
                      void* stream) {
  const StreamGather<S> p{(const S*)val2, (const int32_t*)col2,
                          (const S*)x};
  return launch_rows(p, base, hm1, dest, y, H, T, n_y, span, stream);
}

}  // namespace

// Each entry launches one kernel on `stream` and returns cudaGetLastError().
// Pointers are device pointers to contiguous arrays in the layout of
// ops/xch.py, of the entry's value type (float32 for *_f32, float64 for
// *_f64).

// `out` (H, 128) is written in full.
extern "C" int xch_mul_f32(const void* win, const void* lane, const void* sub,
                           const void* val, const void* x, void* out, int H,
                           int T, int m, void* stream) {
  return launch_mul<float>(win, lane, sub, val, x, out, H, T, m, stream);
}

extern "C" int xch_mul_f64(const void* win, const void* lane, const void* sub,
                           const void* val, const void* x, void* out, int H,
                           int T, int m, void* stream) {
  return launch_mul<double>(win, lane, sub, val, x, out, H, T, m, stream);
}

// bfloat16 val, x and products (each product rounded once).
extern "C" int xch_mul_bf16(const void* win, const void* lane,
                            const void* sub, const void* val, const void* x,
                            void* out, int H, int T, int m, void* stream) {
  return launch_mul<bf16>(win, lane, sub, val, x, out, H, T, m, stream);
}

// `out` must be zeroed, of (n_grp * gb, 128); `prod` is the
// (n_chunks, p1, 128) product grid of pass 1.
extern "C" int xch_route4_f32(const void* gids, const void* off,
                              const void* cs, const void* win,
                              const void* lane, const void* sub,
                              const void* hm1, const void* sig,
                              const void* idx, const void* prod, void* out,
                              int H, int T, int m, int kblk, int p_oh,
                              int n_grp, int gb, int p1, void* stream) {
  return launch_route4<float>(gids, off, cs, win, lane, sub, hm1, sig, idx,
                              prod, out, H, T, m, kblk, p_oh, n_grp, gb, p1,
                              stream);
}

extern "C" int xch_route4_f64(const void* gids, const void* off,
                              const void* cs, const void* win,
                              const void* lane, const void* sub,
                              const void* hm1, const void* sig,
                              const void* idx, const void* prod, void* out,
                              int H, int T, int m, int kblk, int p_oh,
                              int n_grp, int gb, int p1, void* stream) {
  return launch_route4<double>(gids, off, cs, win, lane, sub, hm1, sig, idx,
                               prod, out, H, T, m, kblk, p_oh, n_grp, gb, p1,
                               stream);
}

// Adds into `y` (n_y values, zeroed by the caller before its first call);
// `prod` is the (n_chunks, p1, 128) product grid of pass 1, `dest` the
// (H, 128) int16 run-end destinations relative to `base` (one int32 a step),
// all below `span` when it is not 0 (the merge kernel's span, a multiple of
// 128 whose kWarps copies fit in kMergeSmem).
extern "C" int xch_route4_rows_f32(const void* base, const void* cs,
                                   const void* win, const void* lane,
                                   const void* sub, const void* hm1,
                                   const void* dest, const void* prod,
                                   void* y, int H, int T, int m, int p1,
                                   int n_y, int span, void* stream) {
  return launch_route4_rows<float>(base, cs, win, lane, sub, hm1, dest, prod,
                                   y, H, T, m, p1, n_y, span, stream);
}

extern "C" int xch_route4_rows_f64(const void* base, const void* cs,
                                   const void* win, const void* lane,
                                   const void* sub, const void* hm1,
                                   const void* dest, const void* prod,
                                   void* y, int H, int T, int m, int p1,
                                   int n_y, int span, void* stream) {
  return launch_route4_rows<double>(base, cs, win, lane, sub, hm1, dest,
                                    prod, y, H, T, m, p1, n_y, span, stream);
}

// bfloat16 products (2 bytes a slot), float32 y: the caller rounds y once.
extern "C" int xch_route4_rows_bf16(const void* base, const void* cs,
                                    const void* win, const void* lane,
                                    const void* sub, const void* hm1,
                                    const void* dest, const void* prod,
                                    void* y, int H, int T, int m, int p1,
                                    int n_y, int span, void* stream) {
  return launch_route4_rows<bf16>(base, cs, win, lane, sub, hm1, dest, prod,
                                  y, H, T, m, p1, n_y, span, stream);
}

// The fused spmv route: adds into `y` (n_y values of the accumulator type,
// zeroed by the caller before its first call) the run totals of the
// products val2 * x[col2], made in registers; val2 and col2 are the
// (H, 128) pass-2-ordered value and x-position streams of route_rows,
// every col2 inside x; base, hm1, dest and span as in xch_route4_rows.
extern "C" int xch_fused_rows_f32(const void* base, const void* val2,
                                  const void* col2, const void* hm1,
                                  const void* dest, const void* x, void* y,
                                  int H, int T, int n_y, int span,
                                  void* stream) {
  return launch_fused_rows<float>(base, val2, col2, hm1, dest, x, y, H, T,
                                  n_y, span, stream);
}

extern "C" int xch_fused_rows_f64(const void* base, const void* val2,
                                  const void* col2, const void* hm1,
                                  const void* dest, const void* x, void* y,
                                  int H, int T, int n_y, int span,
                                  void* stream) {
  return launch_fused_rows<double>(base, val2, col2, hm1, dest, x, y, H, T,
                                   n_y, span, stream);
}

// bfloat16 val2 and x (each product rounded once to bfloat16), float32 y:
// the caller rounds y once.
extern "C" int xch_fused_rows_bf16(const void* base, const void* val2,
                                   const void* col2, const void* hm1,
                                   const void* dest, const void* x, void* y,
                                   int H, int T, int n_y, int span,
                                   void* stream) {
  return launch_fused_rows<bf16>(base, val2, col2, hm1, dest, x, y, H, T,
                                 n_y, span, stream);
}

// `out` (H, 128, B) is written in full; `x` is the interleaved (cb, 128, B)
// panel; both of val's type.
extern "C" int xch_mul_panel_f32(const void* win, const void* lane,
                                 const void* sub, const void* val,
                                 const void* x, void* out, int H, int T,
                                 int m, int B, void* stream) {
  return launch_mul_panel<float>(win, lane, sub, val, x, out, H, T, m, B,
                                 stream);
}

// bfloat16 val, x panel and product panel (each product rounded once).
extern "C" int xch_mul_panel_bf16(const void* win, const void* lane,
                                  const void* sub, const void* val,
                                  const void* x, void* out, int H, int T,
                                  int m, int B, void* stream) {
  return launch_mul_panel<bf16>(win, lane, sub, val, x, out, H, T, m, B,
                                stream);
}

// `out` must be zeroed, of (n_out, 128) floats (ngb * g_grp * planes rows);
// `prod` is the (n_chunks, p1, 128) product grid of pass 1, `idx` the
// (planes, H, 128) sigma-plane end lanes, `uids` non-decreasing.  R is the
// chunk of rows a block takes, a multiple of T.
extern "C" int xch_route_f32(const void* uids, const void* cs,
                             const void* sg0, const void* sg1,
                             const void* win, const void* lane,
                             const void* sub, const void* hm1,
                             const void* idx, const void* prod, void* out,
                             int H, int T, int m, int planes, int pg, int p1,
                             int n_out, int R, void* stream) {
  return launch_route_planes<float>(uids, cs, sg0, sg1, win, lane, sub, hm1,
                                    idx, prod, out, H, T, m, planes, pg, p1,
                                    n_out, R, stream);
}

// bfloat16 product grid (2 bytes a product), float out: the caller rounds
// y once.
extern "C" int xch_route_bf16(const void* uids, const void* cs,
                              const void* sg0, const void* sg1,
                              const void* win, const void* lane,
                              const void* sub, const void* hm1,
                              const void* idx, const void* prod, void* out,
                              int H, int T, int m, int planes, int pg,
                              int p1, int n_out, int R, void* stream) {
  return launch_route_planes<bf16>(uids, cs, sg0, sg1, win, lane, sub, hm1,
                                   idx, prod, out, H, T, m, planes, pg, p1,
                                   n_out, R, stream);
}

// `out` must be zeroed, of (n_grp * gb, 128, B) floats; `prod` is the
// interleaved (n_chunks, p1, 128, B) product panel of pass 1.
extern "C" int xch_route4_panel_f32(const void* gids, const void* off,
                                    const void* cs, const void* win,
                                    const void* lane, const void* sub,
                                    const void* hm1, const void* sig,
                                    const void* idx, const void* prod,
                                    void* out, int H, int T, int m, int kblk,
                                    int p_oh, int n_grp, int gb, int p1,
                                    int B, int n_chunks, void* stream) {
  return launch_route4_panel<float>(gids, off, cs, win, lane, sub, hm1, sig,
                                    idx, prod, out, H, T, m, kblk, p_oh,
                                    n_grp, gb, p1, B, n_chunks, stream);
}

// bfloat16 product panel (2 bytes a value), float32 out: the caller rounds
// Y once.
extern "C" int xch_route4_panel_bf16(const void* gids, const void* off,
                                     const void* cs, const void* win,
                                     const void* lane, const void* sub,
                                     const void* hm1, const void* sig,
                                     const void* idx, const void* prod,
                                     void* out, int H, int T, int m,
                                     int kblk, int p_oh, int n_grp, int gb,
                                     int p1, int B, int n_chunks,
                                     void* stream) {
  return launch_route4_panel<bf16>(gids, off, cs, win, lane, sub, hm1, sig,
                                   idx, prod, out, H, T, m, kblk, p_oh,
                                   n_grp, gb, p1, B, n_chunks, stream);
}
