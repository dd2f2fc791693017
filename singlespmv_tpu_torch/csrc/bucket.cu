// Bucket-engine kernels of bkt, bkt_g and ellg for Hopper (sm_90a), bound
// through a plain C interface (ops/_build.py builds this file with ctypes,
// ops/bucket.py calls it).  Float and bfloat16 (the spmv path's kernels and
// the pair), as the reference's bkt refuses float64 on its chip.  At
// bfloat16 values and x are 2 bytes a slot in device memory, each product
// (exact in float) is rounded once to bfloat16, as the TPU's bfloat16
// multiply rounds it and as stage A stores it, and the sums are float into
// a float y, which the caller rounds once.
//
//   bucket_rows_kernel<GatherProducts<S>, D> and
//     bucket_rows_merge_kernel<GatherProducts<S>, D, RG> (bucket_fused_rows,
//     bkt's and bkt_g's spmv) replace block_gather_mul's kernels
//     (_mul_kernel, _mul_kernel_m: singlespmv_tpu/ops/pallas/bucket.py:62,
//     :74 and :91, pallas_call at :114 and :126) together with the stage B
//     below: the gather and the multiply happen in registers and stage B
//     consumes the products in the same launch;
//   ellg_rows_kernel<S> replaces, on ellg's path, block_gather_mul at gran
//     128 on every pass together with the reference's row sums and y-table
//     adds (singlespmv_tpu/formats/ellg.py:spmv): one launch for all the
//     passes of a state;
//   bucket_rows_kernel<StreamProducts<S>, D> and
//     bucket_rows_merge_kernel<StreamProducts<S>, D, RG> (bucket_rows)
//     replace, reading stage A's products back from device memory,
//     _reduce_kernel and _reduce_grouped_kernel, the kernels of
//     bucket_reduce and bucket_reduce_grouped (bucket.py:169, :198 and
//     :230, :264), and _unperm_kernel, the kernel of lane_unpermute
//     (bucket.py:298 and :313), that inverts the balance permutation after
//     them: stage B of 128-row and of 1024-row buckets alike, routed by a
//     run-end destination stream that formats/bkt.py:route_rows derives from
//     the TPU's idx planes, adding straight into y;
//   block_gather_mul_kernel (stage A, writing the product grid) and the
//     stream stage B, the first port of the pair, and bucket_reduce_kernel,
//     bucket_reduce_grouped_kernel and lane_unpermute_kernel, the first port
//     of stage B on the TPU's idx planes, are on no path: they stay as the
//     "first port" of harness/bucket_ab.py and for the parity tests.
//
// Why fused.  The TPU wrote the products to memory because a scatter there
// ran at 0.14 G elem/s ("the layout IS the destination"); on Hopper the work
// is a memory stream, and the product grid (4 bytes a slot written by stage
// A, read back by stage B in the same row order) was a third of the pair's
// bytes.  The fused kernels' bound is the pair's less that write and read:
// stage A's streams (lane 1 B, src 1 B when m > 1, val 4 B), stage B's
// (hm1r 1 B, dest 2 B bkt_g, 1 B bkt), the x table, yrow and y once.  The
// producer policy (StreamProducts or GatherProducts) is a template
// parameter of stage B's two kernels, so the run-total scan (lane_totals),
// the run-end adds and the merge kernel's shared accumulators are one code.
// On an H100 the fused launch took 0.58-0.82 of the pair's busy time on
// the smoke's bucket states but one (twotone, m 8: 1.03-1.05): nearer the
// sum of the two stages where the streams sit in L2 than where they come
// from device memory (harness/bucket_ab.py).  Tried there and left out:
// the block's unit of x rows staged in shared memory (1-4% slower: the
// gathers are not what bounds it); each row's stream words loaded while
// the row before it is summed (46 and 58 registers, so fewer warps: 14-50%
// slower on four states, 2-10% faster on two); fewer blocks, 4 or 16 rows
// a warp in turn (faster only on the two largest states).
//
// ellg's passes are row-positional (t slots a matrix row, t a power of two
// <= 128, so a row never crosses a 128-slot stream row): a warp takes a
// stream row of any pass from a by-value table of up to kMaxPasses passes,
// sums each row's t slots in the lane and by shuffles, and adds the sum
// into y (RED.ADD; passes, and non-full passes' zero padding, may share a
// y row; a zero sum adds nothing).
//
// Stage A, per slot s of the (H, W) stream (flat index s = r * W + l):
//   out[s] = val[s] * x[members[(s / gran) * m + src[s]] * 128 + lane[s]]
// (src unread if m == 1).  A thread takes 4 slots, which share a member unit
// because gran is a multiple of 128.  The TPU's m wide lane-gathers and
// m-way select become one indexed load per slot, from the x table in L2.
//
// Stage B on the run-end stream.  Stage A's products, read back from device
// memory (bucket_rows) or made in registers (bucket_fused_rows), come as
// (H, 128) stream rows, r = (c * nu_pad + n) * sh + j for
// col-group c, row unit n and the j-th of the sh = S / 128 rows of a
// bucket; every run of row r ends inside unit n's rg rows (rg = 128 for
// bkt, 1024 for bkt_g).  route_rows puts, at the slot e that ends a run,
// dest = sigma * 128 + bin (int16, bkt_g) or the bin (int8, bkt), the run's
// row in the unit, and -1 elsewhere; hm1r is hm1 in the same order; and
// yrow (nu_pad * rg int32) maps unit n's row d to y's row (the inverse of
// the balance permutation folded in, -1 past n_row).  Per row: the products
// and hm1r give the run totals (stream_row.cuh: lane_totals), and the lane
// that holds end slot e adds W[e] into y[yrow[n * rg + dest[e]]].
//   bucket_rows_kernel (direct): a warp a stream row over every row of
//     every unit, each run end a native global reduction (RED.ADD);
//   bucket_rows_merge_kernel: `parts` blocks a unit, its rows dealt to
//     their warps in turn; each warp adds its run totals into an rg-float
//     accumulator of its own in shared memory (a row's dests are distinct,
//     so plain adds), and the block sums its 8 in warp order and adds each
//     nonzero sum into y with one reduction.
// There is no zeroed out table, no relayout of the products, no
// lane_unpermute: y is zeroed once and one launch adds into it.
// route_rows picks the merge kernel, at 4 rows a warp, where the stream
// rows end on average MERGE_ENDS = 8 runs or more: on an H100 it took
// 10.89-35.57 us where the direct kernel took 12.53-45.46 on the four
// states with 18-36 run ends a row, and lost by 4-7% on the two with 1.2
// and 3.3, reading the products back (an earlier harness/bucket_ab.py,
// which also timed these designs): a thread block cluster a
// unit that sums its blocks' partials over distributed shared memory and
// adds each y row once, in a fixed order (y then repeats bitwise), ran
// 1.3-2.4x slower than the faster of the two on every state; two rows in
// flight a warp lost 2-11%; absolute int32 dests (yrow unread) won 5-27%
// on bkt_g's direct kernel and lost 35% on bkt's, whose int8 dest they
// quadruple, and the merge kernel needs unit rows.  The reductions make
// the order of the sums, and so their rounding, vary from run to run.
//
// The first port's stage B.  bucket_reduce, per block i of 8G j-interleaved
// stream rows r = i * 8G + rl: W = the run totals of row r, acc[r, b] = sum
// over the K planes k of W[r, idx[i, k, rl, b]] (idx < 0: nothing), and
// out[8i + c, b] = sum of acc over the rows rl = c (mod 8), warp c of the
// block owning those rows.  bucket_reduce_grouped, per row unit n: for
// every col-block c, W = the run totals of prod[c, n, :] with hm1[n, c]; for
// each entry e = idx[n, k, c, l] >= 0, out[8n + (e >> 7), l] += W[e & 127],
// a block a unit summing its warps' (8, 128) shared accumulators.  One
// block a unit and a serial walk a warp: 21-200 blocks on 132 SMs.
//
// lane_unpermute: out[r, j] = yt[r, src_chunk[r, j] * 128 + src_lane[r, j]],
// an indexed copy, one thread per element; a source outside the row gives 0,
// as the TPU's select over chunks does.
//
// Bound.  Stage A streams lane (1 B), src (1 B when m > 1) and val (4 B)
// and writes the product (4 B) per slot; stage B streams the product (4 B),
// hm1r (1 B) and dest (2 B bkt_g, 1 B bkt) per slot, yrow once and adds each
// run end into y; the first port streamed K idx planes (K * 2 B grouped) in
// place of dest; the fused kernels stream A's inputs and B's but the
// products; ellg_rows each pass's members, lane, val, src (m > 1) and blocks
// (not full), its x panel and y once.  All are bound by device memory
// bandwidth.  No TMA, no wgmma: the work is a stream with a scan.

#include "stream_row.cuh"

namespace {

constexpr int kSigmas = 8;  // 128-row blocks of a 1024-row unit

// The four x values of a lane's slots (their in-block columns ln and,
// where m > 1, their members sb; one member unit whose m ids are mu),
// widened to float: x[mu[sb] * 128 + ln] (a member outside [0, m) gives 0,
// as the TPU's m-way select does).
template <typename S>
__device__ __forceinline__ float4 member_gather4(
    const int32_t* __restrict__ mu, char4 ln, char4 sb,
    const S* __restrict__ x, int m) {
  if (m == 1) {
    const S* xr = x + (size_t)__ldg(mu) * kLanes;
    return make_float4(ldg_acc(xr + (ln.x & 127)), ldg_acc(xr + (ln.y & 127)),
                       ldg_acc(xr + (ln.z & 127)), ldg_acc(xr + (ln.w & 127)));
  }
  const int j[4] = {sb.x, sb.y, sb.z, sb.w};
  const int c[4] = {ln.x & 127, ln.y & 127, ln.z & 127, ln.w & 127};
  float gv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    gv[i] = (j[i] >= 0 && j[i] < m)
                ? ldg_acc(x + (size_t)__ldg(mu + j[i]) * kLanes + c[i])
                : 0.f;
  return make_float4(gv[0], gv[1], gv[2], gv[3]);
}

// src's four words at slot s, or nothing where m == 1 (src may be null).
__device__ __forceinline__ char4 load_src4(const int8_t* __restrict__ src,
                                           size_t s, int m) {
  return m > 1 ? load_c4(src + s) : make_char4(0, 0, 0, 0);
}

// val * x slot by slot, each product rounded to float: __fmul_rn is never
// contracted into an FMA with the sums that follow, so a product summed in
// registers is the one stage A stores.
__device__ __forceinline__ float4 products4(float4 v, float4 g) {
  return make_float4(__fmul_rn(v.x, g.x), __fmul_rn(v.y, g.y),
                     __fmul_rn(v.z, g.z), __fmul_rn(v.w, g.w));
}

// Four float products as stage A stores them (a value of the storage type
// of p), widened back: unchanged in float, each rounded once in bfloat16.
__device__ __forceinline__ float4 as_stored(const float*, float4 v) {
  return v;
}

__device__ __forceinline__ float4 as_stored(const bf16*, float4 v) {
  return make_float4(__bfloat162float(__float2bfloat16_rn(v.x)),
                     __bfloat162float(__float2bfloat16_rn(v.y)),
                     __bfloat162float(__float2bfloat16_rn(v.z)),
                     __bfloat162float(__float2bfloat16_rn(v.w)));
}

template <typename S>
__global__ void __launch_bounds__(kThreads) block_gather_mul_kernel(
    const int32_t* __restrict__ members, const int8_t* __restrict__ lane,
    const int8_t* __restrict__ src, const S* __restrict__ val,
    const S* __restrict__ x, S* __restrict__ out, long long n4,
    int gran, int m) {
  const long long q = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (q >= n4) return;
  const long long s = 4 * q;
  store4(out + s, mul4(load4(val + s),
                       member_gather4(members + (s / gran) * m,
                                      load_c4(lane + s),
                                      load_src4(src, (size_t)s, m), x, m)));
}

// Stage B's producers: the four values of stream row r that the calling
// lane holds (slots 4k..4k+3), in float.
//   StreamProducts reads them from stage A's products in device memory;
//   GatherProducts makes them in registers, as stage A would have stored
//   them: val * x gathered from the unit's members (gran / 128 stream rows
//   a unit), rounded once to bfloat16 where S is bfloat16.
template <typename S>
struct StreamProducts {
  const S* prod;
  __device__ __forceinline__ float4 operator()(int r) const {
    return load4(prod + (size_t)r * kLanes + 4 * (threadIdx.x & 31));
  }
};

template <typename S>
struct GatherProducts {
  const int32_t* members;
  const int8_t* lane;
  const int8_t* src;
  const S* val;
  const S* x;
  int unit_rows;  // gran / 128
  int m;
  __device__ __forceinline__ float4 operator()(int r) const {
    const size_t s = (size_t)r * kLanes + 4 * (threadIdx.x & 31);
    const int32_t* mu = members + (size_t)(r / unit_rows) * m;
    return as_stored(val, products4(load4(val + s),
                                    member_gather4(mu, load_c4(lane + s),
                                                   load_src4(src, s, m), x,
                                                   m)));
  }
};

__device__ __forceinline__ float pick(const float* w, int e) {
  return e >= 0 ? w[e] : 0.f;
}

__global__ void __launch_bounds__(kThreads) bucket_reduce_kernel(
    const float* __restrict__ prod, const int8_t* __restrict__ hm1,
    const int8_t* __restrict__ idx, float* __restrict__ out, int G, int K) {
  __shared__ __align__(16) float wbuf[kWarps][kLanes];
  const int warp = threadIdx.x >> 5, k = threadIdx.x & 31;
  const int blk = 8 * G;
  const int r0 = blockIdx.x * blk;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int rl = warp; rl < blk; rl += kWarps) {
    const int r = r0 + rl;
    run_totals<float>(r, load4(prod + (size_t)r * kLanes + 4 * k), hm1,
                      wbuf[warp]);
    for (int kk = 0; kk < K; ++kk) {
      const char4 e = *reinterpret_cast<const char4*>(
          idx + (((size_t)blockIdx.x * K + kk) * blk + rl) * kLanes + 4 * k);
      acc.x += pick(wbuf[warp], e.x);
      acc.y += pick(wbuf[warp], e.y);
      acc.z += pick(wbuf[warp], e.z);
      acc.w += pick(wbuf[warp], e.w);
    }
  }
  store4(out + ((size_t)blockIdx.x * 8 + warp) * kLanes + 4 * k, acc);
}

// acc_row[(e >> 7) * 128] += w[e & 127] for an entry e in [0, 1024).
__device__ __forceinline__ void route_sigma(int e, const float* w,
                                            float* acc_col) {
  if (e >= 0 && e < kSigmas * kLanes)
    acc_col[(e >> 7) * kLanes] += w[e & (kLanes - 1)];
}

__global__ void __launch_bounds__(kThreads) bucket_reduce_grouped_kernel(
    const float* __restrict__ prod, const int8_t* __restrict__ hm1,
    const int16_t* __restrict__ idx, float* __restrict__ out, int CB, int NU,
    int K) {
  __shared__ __align__(16) float wbuf[kWarps][kLanes];
  __shared__ __align__(16) float acc[kWarps][kSigmas * kLanes];
  const int warp = threadIdx.x >> 5, k = threadIdx.x & 31;
  const int n = blockIdx.x;
  float* mine = acc[warp];
  for (int sg = 0; sg < kSigmas; ++sg)
    store4(mine + sg * kLanes + 4 * k, make_float4(0.f, 0.f, 0.f, 0.f));
  for (int c = warp; c < CB; c += kWarps) {
    run_totals<float>(n * CB + c,
                      load4(prod + ((size_t)c * NU + n) * kLanes + 4 * k),
                      hm1, wbuf[warp]);
    for (int kk = 0; kk < K; ++kk) {
      const short4 e = *reinterpret_cast<const short4*>(
          idx + (((size_t)n * K + kk) * CB + c) * kLanes + 4 * k);
      route_sigma(e.x, wbuf[warp], mine + 4 * k + 0);
      route_sigma(e.y, wbuf[warp], mine + 4 * k + 1);
      route_sigma(e.z, wbuf[warp], mine + 4 * k + 2);
      route_sigma(e.w, wbuf[warp], mine + 4 * k + 3);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kSigmas * kLanes; i += kThreads) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += acc[w][i];
    out[(size_t)n * kSigmas * kLanes + i] = sum;
  }
}

__global__ void __launch_bounds__(kThreads) lane_unpermute_kernel(
    const float* __restrict__ yt, const int32_t* __restrict__ src_lane,
    const int32_t* __restrict__ src_chunk, float* __restrict__ out, int cols,
    long long n) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const long long r = i / cols;
  const int ln = src_lane[i], ch = src_chunk[i];
  const bool inside = ln >= 0 && ln < kLanes && ch >= 0 &&
                      (long long)ch * kLanes + ln < cols;
  out[i] = inside ? yt[r * cols + (long long)ch * kLanes + ln] : 0.f;
}

// ---------------------------------------- stage B on the run-end stream ---

using GroupDest = int16_t;       // bkt_g: sigma * 128 + bin
using BlockDest = int8_t;        // bkt: the bin

// y[yr[d]] += v for a run end d in [0, rg) whose y row is not dropped; an
// int32 dest (the A/B's absolute variant) is the y row itself.
template <typename D>
__device__ __forceinline__ void add_end(float* __restrict__ y,
                                        const int32_t* __restrict__ yr, int d,
                                        float v, int rg, int n_y) {
  if constexpr (sizeof(D) == sizeof(int32_t)) {
    if (d >= 0 && d < n_y) atomicAdd(y + d, v);  // RED.ADD
  } else if ((unsigned)d < (unsigned)rg) {
    const int pos = __ldg(yr + d);
    if (pos >= 0 && pos < n_y) atomicAdd(y + pos, v);  // RED.ADD
  }
}

// P is the producer of the products (StreamProducts or GatherProducts, of
// storage type float or bfloat16); y is float.  A warp a stream row.
template <typename P, typename D>
__global__ void __launch_bounds__(kThreads) bucket_rows_kernel(
    const P prod, const int8_t* __restrict__ hm1r,
    const D* __restrict__ dest, const int32_t* __restrict__ yrow,
    float* __restrict__ y, int H, int sh, int nu_pad, int rg, int n_y) {
  __shared__ __align__(16) float wbuf[kWarps][kLanes];
  const int warp = threadIdx.x >> 5, k = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + warp;
  if (r >= H) return;  // uniform over the warp
  const size_t off = (size_t)r * kLanes + 4 * k;
  const float4 a = prod(r);
  const char4 hd = load_c4(hm1r + off);
  const int4 d = load_dest4(dest + off);
  const float4 w = lane_totals<float>(a, hd, wbuf[warp]);
  const int32_t* const yr = yrow + (size_t)((r / sh) % nu_pad) * rg;
  add_end<D>(y, yr, d.x, w.x, rg, n_y);
  add_end<D>(y, yr, d.y, w.y, rg, n_y);
  add_end<D>(y, yr, d.z, w.z, rg, n_y);
  add_end<D>(y, yr, d.w, w.w, rg, n_y);
}

template <typename P, typename D, int RG>
__global__ void __launch_bounds__(kThreads) bucket_rows_merge_kernel(
    const P prod, const int8_t* __restrict__ hm1r,
    const D* __restrict__ dest, const int32_t* __restrict__ yrow,
    float* __restrict__ y, int G, int sh, int nu_pad, int parts, int n_y) {
  __shared__ __align__(16) float wbuf[kWarps][kLanes];
  __shared__ __align__(16) float acc[kWarps][RG];
  const int warp = threadIdx.x >> 5, k = threadIdx.x & 31;
  const int n = blockIdx.x / parts, part = blockIdx.x % parts;
  float* const mine = acc[warp];
  for (int i = 4 * k; i < RG; i += kLanes)
    store4(mine + i, make_float4(0.f, 0.f, 0.f, 0.f));
  __syncwarp();
  // the unit's G rows i = c * sh + j, dealt to its parts * 8 warps in turn
  for (int i = part * kWarps + warp; i < G; i += parts * kWarps) {
    const int r = ((i / sh) * nu_pad + n) * sh + i % sh;
    const size_t off = (size_t)r * kLanes + 4 * k;
    const int4 d = load_dest4(dest + off);
    const float4 w = lane_totals<float>(prod(r), load_c4(hm1r + off),
                                        wbuf[warp]);
    if ((unsigned)d.x < (unsigned)RG) mine[d.x] += w.x;
    if ((unsigned)d.y < (unsigned)RG) mine[d.y] += w.y;
    if ((unsigned)d.z < (unsigned)RG) mine[d.z] += w.z;
    if ((unsigned)d.w < (unsigned)RG) mine[d.w] += w.w;
    __syncwarp();  // the next row's lanes may add to these positions
  }
  __syncthreads();
  const int32_t* const yr = yrow + (size_t)n * RG;
  for (int i = threadIdx.x; i < RG; i += kThreads) {
    float s = acc[0][i];
#pragma unroll
    for (int q = 1; q < kWarps; ++q) s += acc[q][i];
    const int pos = __ldg(yr + i);
    if (s != 0.f && pos >= 0 && pos < n_y) atomicAdd(y + pos, s);  // RED.ADD
  }
}

// ---------------------------------------------------- ellg's passes ---

// One pass of ellg: a stream of n_blocks * t rows of 128 slots (t slots a
// matrix row, 128 / t matrix rows a stream row), one member unit a stream
// row (m ids), adding row sums into y's 128-row block blocks[b] (b itself
// where blocks is null: a full pass).
template <typename S>
struct EllgPass {
  const int32_t* members;
  const int8_t* lane;
  const int8_t* src;
  const S* val;
  const int32_t* blocks;
  const S* x;  // the pass's x panel
  int t, m;
};

constexpr int kMaxPasses = 32;  // passes a launch: a 2 KB parameter

template <typename S>
struct EllgPasses {
  EllgPass<S> p[kMaxPasses];
  int start[kMaxPasses + 1];  // first stream row of each pass, then the end
  int n;
};

// Adds v into y's row of pass row q (block q >> 7 of the pass, row q & 127
// of it); 0 adds nothing (y holds +0 and x + 0 = x), a block at or past rb
// and a row at or past n_y are dropped.
__device__ __forceinline__ void add_row(float* __restrict__ y,
                                        const int32_t* blocks, int q,
                                        float v, int rb, int n_y) {
  if (v == 0.f) return;
  const int b = blocks ? __ldg(blocks + (q >> 7)) : (q >> 7);
  if ((unsigned)b >= (unsigned)rb) return;
  const int pos = b * kLanes + (q & (kLanes - 1));
  if (pos < n_y) atomicAdd(y + pos, v);  // RED.ADD
}

// A warp a stream row of any pass: gather and multiply in registers (gran
// 128), sum each matrix row's t consecutive slots (within the lane for
// t <= 4, then over t / 4 lanes by shuffles), and add each row sum into y.
template <typename S>
__global__ void __launch_bounds__(kThreads) ellg_rows_kernel(
    const __grid_constant__ EllgPasses<S> ps, float* __restrict__ y, int rb,
    int n_y) {
  const int g = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (g >= ps.start[ps.n]) return;  // uniform over the warp
  int i = 0;
  while (g >= ps.start[i + 1]) ++i;
  const EllgPass<S>& p = ps.p[i];
  const int r = g - ps.start[i], k = threadIdx.x & 31, t = p.t;
  const size_t s = (size_t)r * kLanes + 4 * k;
  const float4 a = as_stored(
      p.val, products4(load4(p.val + s),
                       member_gather4(p.members + (size_t)r * p.m,
                                      load_c4(p.lane + s),
                                      load_src4(p.src, s, p.m), p.x, p.m)));
  const int q0 = r * (kLanes / t) + (4 * k) / t;  // the pass row of slot 4k
  if (t == 1) {
    add_row(y, p.blocks, q0, a.x, rb, n_y);
    add_row(y, p.blocks, q0 + 1, a.y, rb, n_y);
    add_row(y, p.blocks, q0 + 2, a.z, rb, n_y);
    add_row(y, p.blocks, q0 + 3, a.w, rb, n_y);
  } else if (t == 2) {
    add_row(y, p.blocks, q0, a.x + a.y, rb, n_y);
    add_row(y, p.blocks, q0 + 1, a.z + a.w, rb, n_y);
  } else {
    float v = (a.x + a.y) + (a.z + a.w);
    for (int d = 1; d < t / 4; d <<= 1) v += __shfl_xor_sync(kFull, v, d);
    if ((k & (t / 4 - 1)) == 0) add_row(y, p.blocks, q0, v, rb, n_y);
  }
}

template <typename S>
int launch_ellg_rows(const void* const* ptrs, const int* ints, int n_pass,
                     void* y, int rb, int n_y, void* stream) {
  if (n_pass < 0 || rb < 0 || n_y < 0) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n_pass; ++i) {
    const int t = ints[3 * i], m = ints[3 * i + 1], nb = ints[3 * i + 2];
    if (t < 1 || t > kLanes || (t & (t - 1)) || m < 1 || nb < 0 ||
        (long long)nb * t >= (1LL << 31) || (m > 1 && !ptrs[6 * i + 2]))
      return (int)cudaErrorInvalidValue;
  }
  for (int c = 0; c < n_pass; c += kMaxPasses) {
    EllgPasses<S> ps;
    ps.n = n_pass - c < kMaxPasses ? n_pass - c : kMaxPasses;
    long long rows = 0;
    for (int j = 0; j < ps.n; ++j) {
      const void* const* a = ptrs + 6 * (c + j);
      const int* v = ints + 3 * (c + j);
      ps.p[j] = {(const int32_t*)a[0], (const int8_t*)a[1],
                 (const int8_t*)a[2], (const S*)a[3], (const int32_t*)a[4],
                 (const S*)a[5], v[0], v[1]};
      ps.start[j] = (int)rows;
      rows += (long long)v[2] * v[0];
    }
    if (rows >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    ps.start[ps.n] = (int)rows;
    if (rows == 0) continue;
    ellg_rows_kernel<S><<<(unsigned)((rows + kWarps - 1) / kWarps), kThreads,
                          0, (cudaStream_t)stream>>>(ps, (float*)y, rb, n_y);
    const int rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  return 0;
}

long long blocks_for(long long n) { return (n + kThreads - 1) / kThreads; }

template <typename P, typename D, int RG>
int launch_merge(P prod, const void* hm1r, const void* dest,
                 const void* yrow, void* y, int G, int sh, int nu_pad,
                 int parts, int n_y, cudaStream_t stream) {
  bucket_rows_merge_kernel<P, D, RG><<<(unsigned)nu_pad * parts, kThreads, 0,
                                       stream>>>(
      prod, (const int8_t*)hm1r, (const D*)dest,
      (const int32_t*)yrow, (float*)y, G, sh, nu_pad, parts, n_y);
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry launches one kernel on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue, without a launch, for a shape it cannot take).
// Pointers are device pointers to contiguous arrays in the layout of
// ops/bucket.py.

// `out` (H, W) is written in full; members holds m ids per unit of gran
// slots.
namespace {

template <typename S>
int launch_gather_mul(const void* members, const void* lane, const void* src,
                      const void* val, const void* x, void* out, int H, int W,
                      int gran, int m, void* stream) {
  if (H < 0 || W < 1 || W % 4 || gran < kLanes || gran % kLanes || m < 1)
    return (int)cudaErrorInvalidValue;
  const long long n4 = (long long)H * W / 4;
  if (n4 == 0) return 0;
  block_gather_mul_kernel<S><<<(unsigned)blocks_for(n4), kThreads, 0,
                               (cudaStream_t)stream>>>(
      (const int32_t*)members, (const int8_t*)lane, (const int8_t*)src,
      (const S*)val, (const S*)x, (S*)out, n4, gran, m);
  return (int)cudaGetLastError();
}

template <typename P>
int launch_rows(P prod, const void* hm1r, const void* dest, const void* yrow,
                void* y, int H, int sh, int nu_pad, int rg, int n_y,
                int parts, void* stream) {
  if (H < 0 || sh < 1 || nu_pad < 1 || (rg != 128 && rg != 1024) ||
      H % (sh * nu_pad) || n_y < 0 || parts < 0)
    return (int)cudaErrorInvalidValue;
  if (H == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (parts == 0) {
    const unsigned blocks = (unsigned)((H + kWarps - 1) / kWarps);
    if (rg == 128)
      bucket_rows_kernel<P, BlockDest><<<blocks, kThreads, 0, s>>>(
          prod, (const int8_t*)hm1r, (const BlockDest*)dest,
          (const int32_t*)yrow, (float*)y, H, sh, nu_pad, rg, n_y);
    else
      bucket_rows_kernel<P, GroupDest><<<blocks, kThreads, 0, s>>>(
          prod, (const int8_t*)hm1r, (const GroupDest*)dest,
          (const int32_t*)yrow, (float*)y, H, sh, nu_pad, rg, n_y);
    return (int)cudaGetLastError();
  }
  const int G = H / nu_pad;  // stream rows a unit
  if (rg == 128)
    return launch_merge<P, BlockDest, 128>(prod, hm1r, dest, yrow, y, G, sh,
                                           nu_pad, parts, n_y, s);
  return launch_merge<P, GroupDest, 1024>(prod, hm1r, dest, yrow, y, G, sh,
                                          nu_pad, parts, n_y, s);
}

template <typename S>
int launch_stream_rows(const void* prod, const void* hm1r, const void* dest,
                       const void* yrow, void* y, int H, int sh, int nu_pad,
                       int rg, int n_y, int parts, void* stream) {
  return launch_rows(StreamProducts<S>{(const S*)prod}, hm1r, dest, yrow, y,
                     H, sh, nu_pad, rg, n_y, parts, stream);
}

template <typename S>
int launch_fused_rows(const void* members, const void* lane, const void* src,
                      const void* val, const void* x, const void* hm1r,
                      const void* dest, const void* yrow, void* y, int H,
                      int gran, int m, int sh, int nu_pad, int rg, int n_y,
                      int parts, void* stream) {
  if (H < 0 || gran < kLanes || gran % kLanes || m < 1 ||
      H % (gran / kLanes))
    return (int)cudaErrorInvalidValue;
  const GatherProducts<S> prod{(const int32_t*)members, (const int8_t*)lane,
                               (const int8_t*)src, (const S*)val,
                               (const S*)x, gran / kLanes, m};
  return launch_rows(prod, hm1r, dest, yrow, y, H, sh, nu_pad, rg, n_y,
                     parts, stream);
}

}  // namespace

extern "C" int block_gather_mul_f32(const void* members, const void* lane,
                                    const void* src, const void* val,
                                    const void* x, void* out, int H, int W,
                                    int gran, int m, void* stream) {
  return launch_gather_mul<float>(members, lane, src, val, x, out, H, W,
                                  gran, m, stream);
}

// bfloat16 val, x and `out` (each product rounded once).
extern "C" int block_gather_mul_bf16(const void* members, const void* lane,
                                     const void* src, const void* val,
                                     const void* x, void* out, int H, int W,
                                     int gran, int m, void* stream) {
  return launch_gather_mul<bf16>(members, lane, src, val, x, out, H, W, gran,
                                 m, stream);
}

// prod/hm1 (rb_pad * G, 128), idx (rb_pad / 8 * K * 8G, 128); `out`
// (rb_pad, 128) is written in full.
extern "C" int bucket_reduce_f32(const void* prod, const void* hm1,
                                 const void* idx, void* out, int rb_pad,
                                 int G, int K, void* stream) {
  if (rb_pad < 0 || rb_pad % 8 || G < 1 || K < 1)
    return (int)cudaErrorInvalidValue;
  if (rb_pad == 0) return 0;
  bucket_reduce_kernel<<<rb_pad / 8, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)prod, (const int8_t*)hm1, (const int8_t*)idx,
      (float*)out, G, K);
  return (int)cudaGetLastError();
}

// prod (CB, nu_pad, 128), hm1 (nu_pad, CB, 128), idx (nu_pad, K, CB, 128)
// int16; `out` (nu_pad * 8, 128) is written in full.
extern "C" int bucket_reduce_grouped_f32(const void* prod, const void* hm1,
                                         const void* idx, void* out, int CB,
                                         int nu_pad, int K, void* stream) {
  if (CB < 1 || nu_pad < 0 || K < 1) return (int)cudaErrorInvalidValue;
  if (nu_pad == 0) return 0;
  bucket_reduce_grouped_kernel<<<nu_pad, kThreads, 0,
                                 (cudaStream_t)stream>>>(
      (const float*)prod, (const int8_t*)hm1, (const int16_t*)idx,
      (float*)out, CB, nu_pad, K);
  return (int)cudaGetLastError();
}

// yt, src_lane, src_chunk and `out` are (rows, cols); `out` is written in
// full.
extern "C" int lane_unpermute_f32(const void* yt, const void* src_lane,
                                  const void* src_chunk, void* out, int rows,
                                  int cols, void* stream) {
  if (rows < 0 || cols < 1) return (int)cudaErrorInvalidValue;
  const long long n = (long long)rows * cols;
  if (n == 0) return 0;
  lane_unpermute_kernel<<<(unsigned)blocks_for(n), kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const float*)yt, (const int32_t*)src_lane, (const int32_t*)src_chunk,
      (float*)out, cols, n);
  return (int)cudaGetLastError();
}

// prod, hm1r and dest (H, 128) in stage A's stream order, H = G_tot * nu_pad
// * sh; dest int8 at rg 128, int16 at rg 1024; yrow (nu_pad * rg) int32.
// Adds into `y` (n_y floats, zeroed by the caller).  parts 0: a warp a
// stream row; else the merge kernel, `parts` blocks a unit.
extern "C" int bucket_rows_f32(const void* prod, const void* hm1r,
                               const void* dest, const void* yrow, void* y,
                               int H, int sh, int nu_pad, int rg, int n_y,
                               int parts, void* stream) {
  return launch_stream_rows<float>(prod, hm1r, dest, yrow, y, H, sh, nu_pad,
                                   rg, n_y, parts, stream);
}

// bfloat16 products (2 bytes a slot), float32 y.
extern "C" int bucket_rows_bf16(const void* prod, const void* hm1r,
                                const void* dest, const void* yrow, void* y,
                                int H, int sh, int nu_pad, int rg, int n_y,
                                int parts, void* stream) {
  return launch_stream_rows<bf16>(prod, hm1r, dest, yrow, y, H, sh, nu_pad,
                                  rg, n_y, parts, stream);
}

// members, lane, src, val, x, hm1r, dest, yrow: stage A's and stage B's
// streams in stage A's row order (H rows of 128 slots; gran slots a member
// unit); adds into `y` as bucket_rows does, the products made in registers.
extern "C" int bucket_fused_rows_f32(
    const void* members, const void* lane, const void* src, const void* val,
    const void* x, const void* hm1r, const void* dest, const void* yrow,
    void* y, int H, int gran, int m, int sh, int nu_pad, int rg, int n_y,
    int parts, void* stream) {
  return launch_fused_rows<float>(members, lane, src, val, x, hm1r, dest,
                                  yrow, y, H, gran, m, sh, nu_pad, rg, n_y,
                                  parts, stream);
}

// bfloat16 val and x; each product rounded once to bfloat16, float32 y.
extern "C" int bucket_fused_rows_bf16(
    const void* members, const void* lane, const void* src, const void* val,
    const void* x, const void* hm1r, const void* dest, const void* yrow,
    void* y, int H, int gran, int m, int sh, int nu_pad, int rg, int n_y,
    int parts, void* stream) {
  return launch_fused_rows<bf16>(members, lane, src, val, x, hm1r, dest,
                                 yrow, y, H, gran, m, sh, nu_pad, rg, n_y,
                                 parts, stream);
}

// ellg's passes: ptrs (host) holds 6 device pointers a pass (members, lane,
// src or null where m == 1, val, blocks or null where the pass is full, the
// pass's x panel), ints (host) 3 ints a pass (t, m, n_blocks).  Adds every
// row sum into `y` (n_y floats, zeroed by the caller; y's 128-row blocks at
// or past rb dropped), one launch a kMaxPasses passes.
extern "C" int ellg_rows_f32(const void* const* ptrs, const int* ints,
                             int n_pass, void* y, int rb, int n_y,
                             void* stream) {
  return launch_ellg_rows<float>(ptrs, ints, n_pass, y, rb, n_y, stream);
}

// bfloat16 val and x panels; each product rounded once, float32 y.
extern "C" int ellg_rows_bf16(const void* const* ptrs, const int* ints,
                              int n_pass, void* y, int rb, int n_y,
                              void* stream) {
  return launch_ellg_rows<bf16>(ptrs, ints, n_pass, y, rb, n_y, stream);
}
