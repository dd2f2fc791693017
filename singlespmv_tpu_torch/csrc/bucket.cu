// Bucket-engine kernels of bkt and bkt_g for Hopper (sm_90a), bound through
// a plain C interface (ops/_build.py builds this file with ctypes,
// ops/bucket.py calls it).  Float and bfloat16 (block_gather_mul and
// bucket_rows), as the reference's bkt refuses float64 on its chip.  At
// bfloat16 values, x and stage A's products are 2 bytes a slot in device
// memory (each product, exact in float, rounded once to bfloat16, as the
// TPU's bfloat16 multiply rounds it), and stage B sums in float into a float
// y, which the caller rounds once.
//
//   block_gather_mul_kernel replaces _mul_kernel and _mul_kernel_m, the
//     kernels of block_gather_mul (singlespmv_tpu/ops/pallas/bucket.py:62,
//     :74 and :91): stage A;
//   bucket_rows_kernel<D> and bucket_rows_merge_kernel<D, RG> replace, on
//     the spmv path, _reduce_kernel and _reduce_grouped_kernel, the kernels
//     of bucket_reduce and bucket_reduce_grouped (bucket.py:169, :198 and
//     :230, :264), and _unperm_kernel, the kernel of lane_unpermute
//     (bucket.py:298 and :313), that inverts the balance permutation after
//     them: stage B of 128-row and of 1024-row buckets alike, routed by a
//     run-end destination stream that formats/bkt.py:route_rows derives from
//     the TPU's idx planes, adding straight into y;
//   bucket_reduce_kernel, bucket_reduce_grouped_kernel and
//     lane_unpermute_kernel, the first port of those three on the TPU's idx
//     planes, are on no path: they stay as the "first port" of
//     harness/bucket_ab.py and for the parity tests.
//
// Stage A, per slot s of the (H, W) stream (flat index s = r * W + l):
//   out[s] = val[s] * x[members[(s / gran) * m + src[s]] * 128 + lane[s]]
// (src unread if m == 1).  A thread takes 4 slots, which share a member unit
// because gran is a multiple of 128.  The TPU's m wide lane-gathers and
// m-way select become one indexed load per slot, from the x table in L2.
//
// Stage B on the run-end stream (bucket_rows).  Stage A's products are read
// in place as (H, 128) stream rows, r = (c * nu_pad + n) * sh + j for
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
// and 3.3 (harness/bucket_ab.py).  Also there: a thread block cluster a
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
// Bound.  Stage A streams lane (1 B), src (1 B when m > 1) and val (4 B) and
// writes the product (4 B) per slot; stage B streams the product (4 B), hm1r
// (1 B) and dest (2 B bkt_g, 1 B bkt) per slot, yrow once and adds each run
// end into y; the first port streamed K idx planes (K * 2 B grouped) in
// place of dest.  Both are bound by device memory bandwidth.  No TMA, no
// wgmma: the work is a stream with a scan.

#include "stream_row.cuh"

namespace {

constexpr int kSigmas = 8;  // 128-row blocks of a 1024-row unit

template <typename S>
__global__ void __launch_bounds__(kThreads) block_gather_mul_kernel(
    const int32_t* __restrict__ members, const int8_t* __restrict__ lane,
    const int8_t* __restrict__ src, const S* __restrict__ val,
    const S* __restrict__ x, S* __restrict__ out, long long n4,
    int gran, int m) {
  const long long q = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (q >= n4) return;
  const long long s = 4 * q;
  const int32_t* mu = members + (s / gran) * m;
  const char4 ln = *reinterpret_cast<const char4*>(lane + s);
  float4 g;
  if (m == 1) {
    const S* xr = x + (size_t)__ldg(mu) * kLanes;
    g = make_float4(ldg_acc(xr + (ln.x & 127)), ldg_acc(xr + (ln.y & 127)),
                    ldg_acc(xr + (ln.z & 127)), ldg_acc(xr + (ln.w & 127)));
  } else {
    const char4 sb = *reinterpret_cast<const char4*>(src + s);
    const int j[4] = {sb.x, sb.y, sb.z, sb.w};
    const int c[4] = {ln.x & 127, ln.y & 127, ln.z & 127, ln.w & 127};
    float gv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      gv[i] = (j[i] >= 0 && j[i] < m)
                  ? ldg_acc(x + (size_t)__ldg(mu + j[i]) * kLanes + c[i])
                  : 0.f;
    g = make_float4(gv[0], gv[1], gv[2], gv[3]);
  }
  store4(out + s, mul4(load4(val + s), g));
}

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

constexpr int kRowsAWarp = 1;    // direct kernel: rows a warp, loaded together
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

// S is the storage type of the products (float or bfloat16); y is float.
template <typename S, typename D>
__global__ void __launch_bounds__(kThreads) bucket_rows_kernel(
    const S* __restrict__ prod, const int8_t* __restrict__ hm1r,
    const D* __restrict__ dest, const int32_t* __restrict__ yrow,
    float* __restrict__ y, int H, int sh, int nu_pad, int rg, int n_y) {
  __shared__ __align__(16) float wbuf[kWarps][kLanes];
  const int warp = threadIdx.x >> 5, k = threadIdx.x & 31;
  const int r0 = (blockIdx.x * kWarps + warp) * kRowsAWarp;
  if (r0 >= H) return;  // uniform over the warp
  float4 a[kRowsAWarp];
  char4 hd[kRowsAWarp];
  int4 d[kRowsAWarp];
#pragma unroll
  for (int i = 0; i < kRowsAWarp; ++i) {
    const size_t off = (size_t)min(r0 + i, H - 1) * kLanes + 4 * k;
    a[i] = load4(prod + off);
    hd[i] = load_c4(hm1r + off);
    d[i] = load_dest4(dest + off);
  }
#pragma unroll
  for (int i = 0; i < kRowsAWarp; ++i) {
    const int r = r0 + i;
    if (r >= H) break;  // uniform over the warp
    const float4 w = lane_totals<float>(a[i], hd[i], wbuf[warp]);
    const int32_t* const yr = yrow + (size_t)((r / sh) % nu_pad) * rg;
    add_end<D>(y, yr, d[i].x, w.x, rg, n_y);
    add_end<D>(y, yr, d[i].y, w.y, rg, n_y);
    add_end<D>(y, yr, d[i].z, w.z, rg, n_y);
    add_end<D>(y, yr, d[i].w, w.w, rg, n_y);
  }
}

template <typename S, typename D, int RG>
__global__ void __launch_bounds__(kThreads) bucket_rows_merge_kernel(
    const S* __restrict__ prod, const int8_t* __restrict__ hm1r,
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
    const float4 w = lane_totals<float>(load4(prod + off),
                                        load_c4(hm1r + off), wbuf[warp]);
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

long long blocks_for(long long n) { return (n + kThreads - 1) / kThreads; }

template <typename S, typename D, int RG>
int launch_merge(const void* prod, const void* hm1r, const void* dest,
                 const void* yrow, void* y, int G, int sh, int nu_pad,
                 int parts, int n_y, cudaStream_t stream) {
  bucket_rows_merge_kernel<S, D, RG><<<(unsigned)nu_pad * parts, kThreads, 0,
                                       stream>>>(
      (const S*)prod, (const int8_t*)hm1r, (const D*)dest,
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

template <typename S>
int launch_rows(const void* prod, const void* hm1r, const void* dest,
                const void* yrow, void* y, int H, int sh, int nu_pad, int rg,
                int n_y, int parts, void* stream) {
  if (H < 0 || sh < 1 || nu_pad < 1 || (rg != 128 && rg != 1024) ||
      H % (sh * nu_pad) || n_y < 0 || parts < 0)
    return (int)cudaErrorInvalidValue;
  if (H == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (parts == 0) {
    const unsigned blocks =
        (unsigned)((H + kWarps * kRowsAWarp - 1) / (kWarps * kRowsAWarp));
    if (rg == 128)
      bucket_rows_kernel<S, BlockDest><<<blocks, kThreads, 0, s>>>(
          (const S*)prod, (const int8_t*)hm1r, (const BlockDest*)dest,
          (const int32_t*)yrow, (float*)y, H, sh, nu_pad, rg, n_y);
    else
      bucket_rows_kernel<S, GroupDest><<<blocks, kThreads, 0, s>>>(
          (const S*)prod, (const int8_t*)hm1r, (const GroupDest*)dest,
          (const int32_t*)yrow, (float*)y, H, sh, nu_pad, rg, n_y);
    return (int)cudaGetLastError();
  }
  const int G = H / nu_pad;  // stream rows a unit
  if (rg == 128)
    return launch_merge<S, BlockDest, 128>(prod, hm1r, dest, yrow, y, G, sh,
                                           nu_pad, parts, n_y, s);
  return launch_merge<S, GroupDest, 1024>(prod, hm1r, dest, yrow, y, G, sh,
                                          nu_pad, parts, n_y, s);
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
  return launch_rows<float>(prod, hm1r, dest, yrow, y, H, sh, nu_pad, rg,
                            n_y, parts, stream);
}

// bfloat16 products (2 bytes a slot), float32 y.
extern "C" int bucket_rows_bf16(const void* prod, const void* hm1r,
                                const void* dest, const void* yrow, void* y,
                                int H, int sh, int nu_pad, int rg, int n_y,
                                int parts, void* stream) {
  return launch_rows<bf16>(prod, hm1r, dest, yrow, y, H, sh, nu_pad, rg, n_y,
                           parts, stream);
}
