// Hopper counterparts of the ten Pallas probes of the reference's
// microbenchmark suite (singlespmv_tpu/harness/microbench.py), bound through
// a plain C interface (ops/_build.py builds this file with ctypes,
// ops/probes.py calls it).  Each computes what its probe's kernel computes;
// what it measures on the card is the card's own rate for that data motion.
//
//   gather_mul_kernel replaces the kernels of five probes, which differ only
//     in which x row an element reads (element (R, c) of an (h, w) array
//     lies in lane-row p = (R % 8) * (w / 128) + c / 128 of its (8, w) tile
//     t = R / 8, at lane c % 128):
//       kLane     probe_lane_gather (:118, pallas_call :150): x[0, col] when
//                 table_rows == 1, else x[p, col]; float32, and bfloat16 with
//                 int16 col (the product rounded once to bfloat16, which is
//                 the bfloat16 product);
//       kLevels   probe_gather1024 (:166, :196): x[(col / 128) % 8,
//                 col % 128] where 0 <= col / 128 < levels, else 0;
//       kPalette  probe_palette_gather (:212, :246): x[blk[t * nb + p / per],
//                 col];
//       kPal2step probe_pal2step (:265, :304): x[blk[t * g + p] +
//                 sub[k][R, c - c % 128 + col], col] with k = sel[R, c] where
//                 1 <= sel < K, else 0 (the sublane is picked before the
//                 lane, as the TPU's two takes do);
//       kSublane  probe_sublane_gather (:364, :382): x[idx[R, c], c], w 128;
//     each times val[R, c].  One thread an element, grid-stride.
//   onehot_bins_kernel replaces probe_onehot_inkernel (:324, :348): per
//     (8, 128) tile the 128 sums of val by bin (the TPU's in-kernel one-hot
//     matmul), written to all 8 rows of the tile; a bin outside [0, 128)
//     adds nowhere.  A block takes a tile, a warp a row of it (one int4 and
//     one float4 load a lane), and adds it into a 128-float histogram of
//     its own, four steps of 32 values: the lanes of one bin add one at a
//     time in lane order, each round's turn won by an integer atomicMax bid
//     in shared memory, or, where bins pile up, are matched by
//     __match_any_sync and summed by shuffles over their ranks (add_step).
//     The eight histograms are summed in warp order and the 8 rows stored
//     with float4.  No float atomics (a float atomicAdd to shared memory is
//     a compare-and-swap loop on sm_90), and the order of every sum is
//     fixed by the data alone.
//   dynslice_accum_kernel replaces probe_dynslice_accum (:435, :458):
//     out[off_t + i, l] += v[8t + i, l] with off_t = offs[t] clamped to
//     [0, rows - 8] (the clamp of a dynamic slice).  The TPU walks t in order
//     over a VMEM-resident out; here every element adds itself with one
//     global atomicAdd (the windows of neighbouring t overlap).
//   segscan_steps_kernel replaces probe_seg_scan (:478, :504; 7 steps, int32
//     heads) and probe_seg_scan_roll (:520, :549; int8 heads): `steps`
//     segmented Hillis-Steele steps over each 128-lane row, exactly the
//     probe's (a windowed scan when steps < 7).  A warp holds a row, four
//     lanes a thread: shifts of 1 and 2 lanes take one shuffle of the
//     neighbour's registers, longer ones a shuffle by d / 4 threads.
//   tile_transpose_kernel replaces probe_pallas_tile_transpose (:565, :581):
//     out[nu, cb * S + s] = in[cb, nu * S + s], a permutation of CB * NU
//     runs of S contiguous floats: run (cb, nu) goes from in + (cb * NU + nu)
//     * S to out + (nu * CB + cb) * S.  A block takes the reference's brick
//     of 8 cb x 8 nu runs (more nu where runs are shorter than 32 lanes'
//     worth): it reads 8 stretches of 8 * S contiguous floats and writes 8
//     (4 KB each at S = 128).  A group of up to 32 lanes copies a run, in
//     float4 where S % 4 == 0 and both pointers are 16-byte aligned, else in
//     floats; each lane issues its 8 runs' loads before it stores them.
//     Index arithmetic once a run, offsets in 32 bits where the sizes allow;
//     streaming loads (nothing rereads the input; streaming stores were no
//     faster in harness/probes_ab.py).
//
// Bound.  Every one is a stream: its inputs read once and its output written
// once at 3.35 TB/s (the gathered x tables are at most 16 MB and stay in the
// 50 MB L2).  At the probes' sizes (1 M elements, 12-20 MB) that is 4-6 us,
// near a launch's own cost, so the probes' loops of eager launches measure
// the launch path as much as the kernel; chip_smoke.py reads each kernel's
// own device time beside its bound.  The gathers, the accumulate and the
// scans are first versions that aim to be right: scalar loads, no vector
// widths, no TMA.  The bin sums and the transpose are designed for the card
// (the first versions lost to scatter_add_ and to a PyTorch transpose: one
// warp a tile with shared atomics, one thread an element with 64-bit
// divisions; harness/probes_ab.py keeps them for its A/B).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

enum GatherKind { kLane = 0, kLevels = 1, kPalette = 2, kPal2step = 3,
                  kSublane = 4 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

int grid_of(long long n) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  return (int)(blocks < (1 << 20) ? blocks : (1 << 20));
}

// a and b by kind: kLane a = (table_rows == 1); kLevels a = levels;
// kPalette a = nb, b = per; kPal2step a = g, b = K.
template <typename V, typename I>
__global__ void __launch_bounds__(kThreads) gather_mul_kernel(
    const I* __restrict__ col, const V* __restrict__ val,
    const V* __restrict__ x, const int32_t* __restrict__ blk,
    const int32_t* __restrict__ sub, const int32_t* __restrict__ sel,
    V* __restrict__ out, long long n, int w, int kind, int a, int b) {
  const int per_row = w / kLanes;  // lane-rows of one tile row
  for (long long e = blockIdx.x * (long long)kThreads + threadIdx.x; e < n;
       e += (long long)gridDim.x * kThreads) {
    const long long R = e / w;
    const int c = (int)(e - R * w);
    const int p = (int)(R % 8) * per_row + c / kLanes;
    const long long t = R / 8;
    const int ci = (int)col[e];
    long long row = 0;
    int ln = ci;
    bool hit = true;
    switch (kind) {
      case kLane:
        row = a ? 0 : p;
        break;
      case kLevels: {
        const int s = ci >> 7;  // floor division, as the probe's //
        hit = s >= 0 && s < a;
        row = s & 7;
        ln = ci & (kLanes - 1);
        break;
      }
      case kPalette:
        row = blk[t * a + p / b];
        break;
      case kPal2step: {
        const int q = sel[e];
        const long long k = (q >= 1 && q < b) ? q : 0;
        row = (long long)blk[t * a + p] +
              sub[k * n + R * w + (c - c % kLanes) + ci];
        break;
      }
      default:  // kSublane
        row = ci;
        ln = c;
    }
    const float g = hit ? to_f(x[row * kLanes + ln]) : 0.f;
    put(out + e, to_f(val[e]) * g);
  }
}

// The sum of v over the lanes of `peers` (the lanes holding one key), by a
// tree over their ranks in lane order; the first lane of `peers` returns
// it.  The tree depends only on which lanes are peers, so the adds' order is
// fixed.  All 32 lanes call it.
__device__ __forceinline__ float sum_peers(unsigned peers, float v) {
  const int lane = threadIdx.x & 31;
  int rank = __popc(peers & ((1u << lane) - 1));
  unsigned above = peers & (0xfffffffeu << lane);  // the peers past this lane
  while (__any_sync(kFull, above)) {
    const int next = __ffs(above);  // 1 + the nearest such lane, 0 if none
    const float t = __shfl_sync(kFull, v, next ? next - 1 : lane);
    if (next) v += t;
    above &= ~__ballot_sync(kFull, rank & 1);  // odd ranks are summed up
    rank >>= 1;
  }
  return v;
}

constexpr int kTileWarps = 8;  // warps a tile: 8 / kTileWarps rows each
constexpr int kTileThreads = 32 * kTileWarps;
constexpr int kWarpRows = 8 / kTileWarps;
constexpr int kBidRounds = 2;  // bidding rounds a step before the tree
constexpr int kBidLeft = 4;    // ... or once more lanes are left after one

// One step of a warp: each lane adds v into bin `key` of the warp's
// histogram (kLanes: no bin), the lanes of one bin in an order that only
// the data fix.  In each round the lanes still to add bid round * 32 + 31 -
// lane for their bin with an integer atomicMax into `tags`; the highest bid,
// the lowest lane, adds with a plain shared load and store.  Where bins pile
// up (more than kBidLeft lanes left after a round, or kBidRounds rounds
// done), the lanes left are matched by __match_any_sync (quick once few
// distinct bins are left: it takes longer the more distinct keys a warp
// holds) and summed by the shuffle tree, and the first of each bin adds.
// `round` counts the warp's rounds, so that no tag needs clearing.
__device__ __forceinline__ void add_step(float* hist, int* tags, int key,
                                         float v, int& round) {
  const int k = threadIdx.x & 31;
  bool todo = key < kLanes;
  unsigned left = __ballot_sync(kFull, todo);
  for (int r = 0; left && r < kBidRounds; ++r) {
    const int bid = ++round * 32 + 31 - k;
    if (todo) atomicMax(tags + key, bid);
    __syncwarp();
    if (todo && tags[key] == bid) {
      hist[key] += v;
      todo = false;
    }
    __syncwarp();
    left = __ballot_sync(kFull, todo);
    if (__popc(left) > kBidLeft) break;
  }
  if (left) {
    unsigned peers = __match_any_sync(kFull, todo ? key : kLanes);
    if (!todo) peers = 1u << k;  // a lane done stands alone, out of the trees
    const float sum = sum_peers(peers, v);
    if (todo && !(peers & ((1u << k) - 1))) hist[key] += sum;
  }
}

__global__ void __launch_bounds__(kTileThreads) onehot_bins_kernel(
    const int32_t* __restrict__ bins, const float* __restrict__ val,
    float* __restrict__ out) {
  __shared__ __align__(16) float hist[kTileWarps][kLanes];
  __shared__ __align__(16) int tags[kTileWarps][kLanes];
  __shared__ float4 sums[kLanes / 4];
  const int warp = threadIdx.x >> 5, k = threadIdx.x & 31;
  const size_t tile = (size_t)blockIdx.x * 8 * kLanes;
  const int q = warp * kWarpRows * 32 + k;  // this lane's first float4
  int b[4 * kWarpRows];
  float v[4 * kWarpRows];
#pragma unroll
  for (int r = 0; r < kWarpRows; ++r) {
    const int4 bb = __ldcs(reinterpret_cast<const int4*>(bins + tile) + q +
                           32 * r);
    const float4 vv = __ldcs(reinterpret_cast<const float4*>(val + tile) + q +
                             32 * r);
    b[4 * r] = bb.x, b[4 * r + 1] = bb.y, b[4 * r + 2] = bb.z;
    b[4 * r + 3] = bb.w;
    v[4 * r] = vv.x, v[4 * r + 1] = vv.y, v[4 * r + 2] = vv.z;
    v[4 * r + 3] = vv.w;
  }
  float* hw = hist[warp];
  int* tw = tags[warp];
  reinterpret_cast<float4*>(hw)[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  reinterpret_cast<int4*>(tw)[k] = make_int4(0, 0, 0, 0);
  __syncwarp();
  int round = 0;
#pragma unroll
  for (int j = 0; j < 4 * kWarpRows; ++j) {
    const int key = b[j] >= 0 && b[j] < kLanes ? b[j] : kLanes;  // no bin
    add_step(hw, tw, key, v[j], round);
    __syncwarp();
  }
  __syncthreads();
  for (int l = threadIdx.x; l < kLanes; l += kTileThreads) {
    float sum = hist[0][l];
#pragma unroll
    for (int w = 1; w < kTileWarps; ++w) sum += hist[w][l];
    reinterpret_cast<float*>(sums)[l] = sum;
  }
  __syncthreads();
  float4* o = reinterpret_cast<float4*>(out + tile);
  for (int i = threadIdx.x; i < 8 * kLanes / 4; i += kTileThreads)
    o[i] = sums[i & (kLanes / 4 - 1)];
}

__global__ void __launch_bounds__(kThreads) dynslice_accum_kernel(
    const int32_t* __restrict__ offs, const float* __restrict__ v,
    float* __restrict__ out, long long n, int rows) {
  for (long long e = blockIdx.x * (long long)kThreads + threadIdx.x; e < n;
       e += (long long)gridDim.x * kThreads) {
    const long long t = e / (8 * kLanes);
    const int i = (int)(e / kLanes) & 7, l = (int)(e % kLanes);
    const int off = min(max(offs[t], 0), rows - 8);
    atomicAdd(out + (size_t)(off + i) * kLanes + l, v[e]);
  }
}

// One Hillis-Steele step: (vz, fz) of the lane d to the left, or (0, 1)
// where there is none; then v keeps its value under a head and adds vz
// elsewhere, and f takes the larger flag.
template <typename F>
__global__ void __launch_bounds__(kThreads) segscan_steps_kernel(
    const F* __restrict__ heads, const float* __restrict__ val,
    float* __restrict__ out, int G, int steps) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= G) return;
  const int k = threadIdx.x & 31;
  const size_t off = (size_t)row * kLanes + 4 * k;
  float v[4];
  int f[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[j] = val[off + j];
    f[j] = (int)heads[off + j];
  }
  // d stops at 128: every later step finds no lane d to the left
  for (int st = 0, d = 1; st < steps; ++st, d = d < kLanes ? 2 * d : d) {
    float vz[4];
    int fz[4];
    if (d < 4) {  // d is 1 or 2: this thread's lanes and its left neighbour's
      float pv[4];
      int pf[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        pv[j] = __shfl_up_sync(kFull, v[j], 1);
        pf[j] = __shfl_up_sync(kFull, f[j], 1);
      }
      if (d == 1) {
        vz[0] = pv[3], vz[1] = v[0], vz[2] = v[1], vz[3] = v[2];
        fz[0] = pf[3], fz[1] = f[0], fz[2] = f[1], fz[3] = f[2];
      } else {
        vz[0] = pv[2], vz[1] = pv[3], vz[2] = v[0], vz[3] = v[1];
        fz[0] = pf[2], fz[1] = pf[3], fz[2] = f[0], fz[3] = f[1];
      }
    } else {  // the same lane of the thread d / 4 to the left
      const int dd = d >> 2;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        vz[j] = dd < 32 ? __shfl_up_sync(kFull, v[j], dd) : 0.f;
        fz[j] = dd < 32 ? __shfl_up_sync(kFull, f[j], dd) : 1;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (4 * k + j < d) {  // no lane d to the left
        vz[j] = 0.f;
        fz[j] = 1;
      }
      v[j] = f[j] > 0 ? v[j] : v[j] + vz[j];
      f[j] = max(f[j], fz[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) out[off + j] = v[j];
}

constexpr int kBrick = 8;  // a transpose brick's cb
constexpr int kRunBatch = kBrick * kBrick / kWarps;  // runs a lane group

// log2 of the lanes that copy a run of L elements: the power of 2 at or
// above L, at most 32.  A brick is kBrick cb x (kBrick << (5 - log2)) nu
// runs: the reference's 8 x 8 at L >= 32, more nu where a run is shorter,
// so that every lane group takes kRunBatch runs.
__host__ __device__ inline int run_lanes_log2(int L) {
  int lg = 0;
  while (lg < 5 && (1 << lg) < L) ++lg;
  return lg;
}

// The runs of one brick, in out order (nu-major), `ncb` x `nnu` of them from
// (cb0, nu0), each L elements of T, offsets in Off.  The block's groups of
// 2^lg lanes take runs slot, slot + slots, ...: at most kRunBatch each, whose
// loads are all issued before the stores.
template <typename T, typename Off>
__device__ __forceinline__ void copy_brick(const T* __restrict__ in,
                                           T* __restrict__ out, int CB,
                                           int NU, int L, int lg, int cb0,
                                           int nu0, int ncb, int nnu) {
  const int slots = kThreads >> lg, slot = threadIdx.x >> lg;
  const int runs = ncb * nnu;
  Off src[kRunBatch], dst[kRunBatch];
#pragma unroll
  for (int u = 0; u < kRunBatch; ++u) {
    const int r = slot + u * slots;
    const int j = ncb == kBrick ? r / kBrick : r / ncb, c = r - j * ncb;
    src[u] = ((Off)(cb0 + c) * NU + nu0 + j) * L;
    dst[u] = ((Off)(nu0 + j) * CB + cb0 + c) * L;
  }
  for (int e = threadIdx.x & ((1 << lg) - 1); e < L; e += 1 << lg) {
    T v[kRunBatch];
#pragma unroll
    for (int u = 0; u < kRunBatch; ++u)
      if (slot + u * slots < runs) v[u] = __ldcs(in + src[u] + e);
#pragma unroll
    for (int u = 0; u < kRunBatch; ++u)
      if (slot + u * slots < runs) out[dst[u] + e] = v[u];
  }
}

// One block a brick of kBrick cb x `bnu` nu; `vec` copies float4s (S % 4 ==
// 0, both pointers on 16 bytes), else floats.  Off holds element offsets:
// 32 bits where CB * NU * S < 2^32.
template <typename Off>
__global__ void __launch_bounds__(kThreads) tile_transpose_kernel(
    const float* __restrict__ in, float* __restrict__ out, int CB, int NU,
    int S, int vec, int bnu) {
  const int bricks_nu = (NU + bnu - 1) / bnu;
  const int bc = blockIdx.x / bricks_nu, bn = blockIdx.x - bc * bricks_nu;
  const int cb0 = bc * kBrick, nu0 = bn * bnu;
  const int ncb = min(kBrick, CB - cb0), nnu = min(bnu, NU - nu0);
  const int L = vec ? S / 4 : S;
  if (vec)
    copy_brick<float4, Off>(reinterpret_cast<const float4*>(in),
                            reinterpret_cast<float4*>(out), CB, NU, L,
                            run_lanes_log2(L), cb0, nu0, ncb, nnu);
  else
    copy_brick<float, Off>(in, out, CB, NU, L, run_lanes_log2(L), cb0, nu0,
                           ncb, nnu);
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

template <typename V, typename I>
int launch_gather(const void* col, const void* val, const void* x,
                  const void* blk, const void* sub, const void* sel,
                  void* out, int n, int w, int kind, int a, int b,
                  void* stream) {
  if (n < 0 || w < kLanes || w % kLanes || n % w || kind < kLane ||
      kind > kSublane || (kind == kSublane && w != kLanes) ||
      (kind == kPalette && b < 1))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  gather_mul_kernel<V, I><<<grid_of(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const I*)col, (const V*)val, (const V*)x, (const int32_t*)blk,
      (const int32_t*)sub, (const int32_t*)sel, (V*)out, n, w, kind, a, b);
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry launches one kernel on `stream` and returns cudaGetLastError().
// Pointers are device pointers to contiguous arrays in the layout of
// ops/probes.py; a pointer that the kind does not read may be null.

// out (h, w) = val * x[row, lane] over n = h * w elements, rows and lanes by
// `kind`; blk, sub and sel only for the palette kinds.
extern "C" int probe_gather_f32(const void* col, const void* val,
                                const void* x, const void* blk,
                                const void* sub, const void* sel, void* out,
                                int n, int w, int kind, int a, int b,
                                void* stream) {
  return launch_gather<float, int32_t>(col, val, x, blk, sub, sel, out, n, w,
                                       kind, a, b, stream);
}

// The same over bfloat16 values with int16 col.
extern "C" int probe_gather_bf16(const void* col, const void* val,
                                 const void* x, const void* blk,
                                 const void* sub, const void* sel, void* out,
                                 int n, int w, int kind, int a, int b,
                                 void* stream) {
  return launch_gather<__nv_bfloat16, int16_t>(col, val, x, blk, sub, sel,
                                               out, n, w, kind, a, b, stream);
}

// out (G, 128): every row of tile t holds the 128 bin sums of tile t; the
// three arrays start on 16 bytes.
extern "C" int probe_onehot_f32(const void* bins, const void* val, void* out,
                                int G, void* stream) {
  if (G < 0 || G % 8 || !aligned16(bins) || !aligned16(val) ||
      !aligned16(out))
    return (int)cudaErrorInvalidValue;
  if (G == 0) return 0;
  onehot_bins_kernel<<<G / 8, kTileThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)bins, (const float*)val, (float*)out);
  return (int)cudaGetLastError();
}

// `out` (rows, 128) must be zeroed; v is (T * 8, 128).
extern "C" int probe_dynslice_f32(const void* offs, const void* v, void* out,
                                  int T, int rows, void* stream) {
  if (T < 0 || rows < 8) return (int)cudaErrorInvalidValue;
  if (T == 0) return 0;
  const long long n = (long long)T * 8 * kLanes;
  dynslice_accum_kernel<<<grid_of(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)offs, (const float*)v, (float*)out, n, rows);
  return (int)cudaGetLastError();
}

// heads (G, 128) int32, or int8 when heads_i8 != 0.
extern "C" int probe_segscan_f32(const void* heads, const void* val,
                                 void* out, int G, int steps, int heads_i8,
                                 void* stream) {
  if (G < 0 || steps < 0) return (int)cudaErrorInvalidValue;
  if (G == 0) return 0;
  const int blocks = (G + kWarps - 1) / kWarps;
  if (heads_i8)
    segscan_steps_kernel<int8_t><<<blocks, kThreads, 0,
                                   (cudaStream_t)stream>>>(
        (const int8_t*)heads, (const float*)val, (float*)out, G, steps);
  else
    segscan_steps_kernel<int32_t><<<blocks, kThreads, 0,
                                    (cudaStream_t)stream>>>(
        (const int32_t*)heads, (const float*)val, (float*)out, G, steps);
  return (int)cudaGetLastError();
}

// in (CB, NU * S) -> out (NU, CB * S).
extern "C" int probe_transpose_f32(const void* in, void* out, int CB, int NU,
                                   int S, void* stream) {
  if (CB < 0 || NU < 0 || S < 0) return (int)cudaErrorInvalidValue;
  if ((long long)CB * NU * S == 0) return 0;
  const int vec = S % 4 == 0 && aligned16(in) && aligned16(out);
  const int bnu = kBrick << (5 - run_lanes_log2(vec ? S / 4 : S));
  const long long bricks = (long long)((CB + kBrick - 1) / kBrick) *
                           ((NU + bnu - 1) / bnu);
  if (bricks > INT32_MAX) return (int)cudaErrorInvalidValue;
  if ((unsigned long long)CB * NU * S < (1ull << 32))
    tile_transpose_kernel<uint32_t><<<(int)bricks, kThreads, 0,
                                      (cudaStream_t)stream>>>(
        (const float*)in, (float*)out, CB, NU, S, vec, bnu);
  else
    tile_transpose_kernel<uint64_t><<<(int)bricks, kThreads, 0,
                                      (cudaStream_t)stream>>>(
        (const float*)in, (float*)out, CB, NU, S, vec, bnu);
  return (int)cudaGetLastError();
}
