// Hopper counterparts of the ten Pallas probes of the reference's
// microbenchmark suite (singlespmv_tpu/harness/microbench.py), bound through
// a plain C interface (ops/_build.py builds this file with ctypes,
// ops/probes.py calls it).  Each computes what its probe's kernel computes;
// what it measures on the card is the card's own rate for that data motion.
//
//   gather_mul_kernel<V, I, kind, N> replaces the kernels of five probes,
//     which differ only in which x row an element reads (element (R, c) of an
//     (h, w) array lies in lane-row p = (R % 8) * (w / 128) + c / 128 of its
//     (8, w) tile t = R / 8, at lane c % 128):
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
//     each times val[R, c].  The kind is a template parameter; a thread takes
//     N consecutive elements of one lane-row (4 float32, 8 bfloat16: one
//     16-byte load of col and of val, one 16-byte store), N = 1 where a
//     pointer is off 16 bytes.  R, p and t come once a vector in 32-bit
//     arithmetic (one 32-bit division by w / 128, none at w 128); the x
//     tables come through the read-only path.
//   gather_mul_table_kernel<V, I, SL> runs kSublane from shared memory: a
//     block stages lanes [s * SL, s * SL + SL) of every x row, row-major
//     ([row][lane]: lane l in bank l % 32, whatever idx is), SL =
//     kSliceLanes = 32 (up to 1,816 rows of float32); one persistent block
//     an SM keeps its slice for all its rows.  A thread takes one lane of
//     kRowsInFlight rows at a time, loaded before it multiplies the ones
//     before (the first batch before the table is staged).  A table past
//     the SM's shared memory reads x from device memory
//     (gather_mul_kernel's kSublane).
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
//     out[off_t + i, l] += v[8t + i, l] with off_t = offs[t], plus rows
//     where negative, clamped to [0, rows - 8] (slice_start: a dynamic
//     slice's start as the reference's kernel takes it).  The TPU walks t
//     in order over a VMEM-resident out; here a one-warp block takes
//     kDynChunk consecutive steps, brought into shared memory by bulk
//     copies of kDynPiece steps (kDynBufs in flight), and sums them on chip:
//     a lane holds 4 lanes (float4) of a window of 8 y rows [cur, cur + 8)
//     in registers.  A step at off > cur within the window makes rows cur ..
//     off - 1 final for the chunk: each is added into y with one float4 RED
//     (a global atomic add whose result is unused), and the window slides.
//     A step outside it (a jump back, or 8 rows or more ahead) flushes the
//     window and starts a new one there; the chunk's end flushes the rest.
//     With the probe's sorted offs that is one RED a row a chunk touches
//     (about kDynChunk / 4 + 8 rows) in place of one per element.
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
// own device time beside its bound.  The scans are first versions that aim
// to be right: scalar loads, no vector widths, no TMA.  The gathers, the
// accumulate, the bin sums and the transpose are designed for the card: the
// first versions took one thread an element with 64-bit divisions (the
// gathers, the transpose, and the accumulate, one global atomicAdd an
// element), or lost to scatter_add_ (the bin sums: one warp a tile with
// shared atomics); harness/probes_ab.py keeps them for its A/B.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

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
__device__ __forceinline__ void from_f(float& o, float v) { o = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16& o, float v) {
  o = __float2bfloat16(v);
}

// Element i of an x table, through the read-only path.
__device__ __forceinline__ float load_x(const float* x, size_t i) {
  return __ldg(x + i);
}
__device__ __forceinline__ float load_x(const __nv_bfloat16* x, size_t i) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldg(reinterpret_cast<const unsigned short*>(x) + i)));
}

// N consecutive elements at p: 16-byte accesses where they fill them (p on
// 16 bytes), else one element at a time.  Plain loads and stores: the
// probes' inputs stay in L2 from call to call, which streaming hints undo
// (harness/probes_ab.py).
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* __restrict__ p,
                                         T (&v)[N]) {
  if constexpr (N * sizeof(T) % 16 == 0) {
    int4 raw[N * sizeof(T) / 16];
#pragma unroll
    for (int q = 0; q < (int)(N * sizeof(T) / 16); ++q)
      raw[q] = reinterpret_cast<const int4*>(p)[q];
    memcpy(v, raw, sizeof(raw));
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = p[j];
  }
}
template <typename T, int N>
__device__ __forceinline__ void store_vec(T* __restrict__ p,
                                          const T (&v)[N]) {
  if constexpr (N * sizeof(T) % 16 == 0) {
    int4 raw[N * sizeof(T) / 16];
    memcpy(raw, v, sizeof(raw));
#pragma unroll
    for (int q = 0; q < (int)(N * sizeof(T) / 16); ++q)
      reinterpret_cast<int4*>(p)[q] = raw[q];
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) p[j] = v[j];
  }
}

int grid_of(long long n) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  return (int)(blocks < (1 << 20) ? blocks : (1 << 20));
}

// a and b by kind: kLane a = (table_rows == 1); kLevels a = levels;
// kPalette a = nb, b = per; kPal2step a = g, b = K.  A thread takes N
// consecutive elements of one lane-row (N divides 128), grid-stride; n < 2^31.
template <typename V, typename I, int K, int N>
__global__ void __launch_bounds__(kThreads) gather_mul_kernel(
    const I* __restrict__ col, const V* __restrict__ val,
    const V* __restrict__ x, const int32_t* __restrict__ blk,
    const int32_t* __restrict__ sub, const int32_t* __restrict__ sel,
    V* __restrict__ out, int n, int w, int a, int b) {
  const unsigned per_row = (unsigned)w / kLanes;  // lane-rows of one tile row
  const unsigned n_vec = (unsigned)n / N;
  for (unsigned i = blockIdx.x * kThreads + threadIdx.x; i < n_vec;
       i += gridDim.x * kThreads) {
    const unsigned e = i * N;
    const unsigned seg = e / kLanes;  // R * per_row + c / 128
    const unsigned R = per_row == 1 ? seg : seg / per_row;
    const unsigned p = (R & 7) * per_row + (seg - R * per_row);
    const unsigned t = R >> 3;
    I ci[N];
    V vv[N];
    load_vec(col + e, ci);
    load_vec(val + e, vv);
    float g[N];
    if constexpr (K == kLane) {
      const size_t row = a ? 0 : (size_t)p * kLanes;
#pragma unroll
      for (int j = 0; j < N; ++j) g[j] = load_x(x, row + (int)ci[j]);
    } else if constexpr (K == kLevels) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const int c = (int)ci[j], s = c >> 7;  // floor division, as the //
        g[j] = s >= 0 && s < a
                   ? load_x(x, (size_t)(s & 7) * kLanes + (c & (kLanes - 1)))
                   : 0.f;
      }
    } else if constexpr (K == kPalette) {
      const unsigned q = b == 1 ? p : p / (unsigned)b;
      const size_t row = (size_t)__ldg(blk + t * (unsigned)a + q) * kLanes;
#pragma unroll
      for (int j = 0; j < N; ++j) g[j] = load_x(x, row + (int)ci[j]);
    } else if constexpr (K == kPal2step) {
      int32_t k[N];
      load_vec(sel + e, k);
      const int base = __ldg(blk + t * (unsigned)a + p);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const size_t plane = k[j] >= 1 && k[j] < b ? (size_t)k[j] * n : 0;
        const int row = base + __ldg(sub + plane + seg * kLanes + (int)ci[j]);
        g[j] = load_x(x, (size_t)row * kLanes + (int)ci[j]);
      }
    } else {  // kSublane, from global memory: the table past shared memory
      const unsigned c = e - seg * kLanes;
#pragma unroll
      for (int j = 0; j < N; ++j)
        g[j] = load_x(x, (size_t)(int)ci[j] * kLanes + c + j);
    }
    V o[N];
#pragma unroll
    for (int j = 0; j < N; ++j) from_f(o[j], to_f(vv[j]) * g[j]);
    store_vec(out + e, o);
  }
}

constexpr int kTableThreads = 1024;
constexpr int kRowsInFlight = 4;         // rows a thread loads at once
constexpr int kSliceLanes = 32;          // lanes of x a block stages
constexpr int kTableBlocksPerSM = 1;
constexpr int kMaxSharedBytes = 232448;  // a block's dynamic maximum

// out (G, 128) = val * x[idx, lane] with lanes [s * SL, s * SL + SL) of
// every x row in shared memory: block b takes slice s = b % (128 / SL) and
// the b / (128 / SL)-th of `parts` runs of G rows (SL = 128: the whole
// table, which harness/probes_ab.py tries).
template <typename V, typename I, int SL>
__global__ void __launch_bounds__(kTableThreads) gather_mul_table_kernel(
    const I* __restrict__ idx, const V* __restrict__ val,
    const V* __restrict__ x, V* __restrict__ out, int G, int rows, int parts,
    int vec) {
  extern __shared__ __align__(16) unsigned char table_bytes[];
  V* table = reinterpret_cast<V*>(table_bytes);  // [rows][SL]
  constexpr int kSlices = kLanes / SL, kGroups = kTableThreads / SL;
  constexpr int kStride = kRowsInFlight * kGroups;
  const int slice = blockIdx.x % kSlices, part = blockIdx.x / kSlices;
  const int per = (G + parts - 1) / parts;
  const int r1 = min(G, part * per + per);
  const int l = threadIdx.x % SL, c = slice * SL + l;
  int R0 = part * per + threadIdx.x / SL;
  I ix[kRowsInFlight];
  V vv[kRowsInFlight];
#pragma unroll
  for (int u = 0; u < kRowsInFlight; ++u) {
    const int R = R0 + u * kGroups;
    if (R < r1) {
      ix[u] = idx[R * kLanes + c];
      vv[u] = val[R * kLanes + c];
    }
  }
  if (vec) {  // x on 16 bytes: 16-byte copies
    constexpr int E = 16 / sizeof(V), Q = SL / E;  // copies a row's slice
    const int4* src = reinterpret_cast<const int4*>(x + slice * SL);
    for (int q = threadIdx.x; q < rows * Q; q += kTableThreads)
      reinterpret_cast<int4*>(table)[q] =
          __ldg(src + (q / Q) * (kLanes / E) + q % Q);
  } else {
    for (int q = threadIdx.x; q < rows * SL; q += kTableThreads)
      table[q] = x[(size_t)(q / SL) * kLanes + slice * SL + q % SL];
  }
  __syncthreads();
  for (; R0 < r1; R0 += kStride) {
    I nix[kRowsInFlight];
    V nvv[kRowsInFlight];
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
      const int R = R0 + kStride + u * kGroups;
      if (R < r1) {
        nix[u] = idx[R * kLanes + c];
        nvv[u] = val[R * kLanes + c];
      }
    }
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
      const int R = R0 + u * kGroups;
      if (R < r1) {
        V o;
        from_f(o, to_f(vv[u]) * to_f(table[(int)ix[u] * SL + l]));
        out[R * kLanes + c] = o;
      }
      ix[u] = nix[u];
      vv[u] = nvv[u];
    }
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

constexpr int kDynChunk = 16;  // steps a block
constexpr int kDynPiece = 4;   // steps a bulk copy
constexpr int kDynBufs = 2;    // bulk copies in flight
constexpr int kStepFloats = 8 * kLanes;
constexpr int kDynSharedBytes = kDynBufs * kDynPiece * kStepFloats * 4;

// A float4 added into global memory with no result read back: one vector
// RED (sm_90's float4 atomicAdd).
__device__ __forceinline__ void red4(float* p, float4 v) {
  atomicAdd(reinterpret_cast<float4*>(p), v);
}

__device__ __forceinline__ void bar_init(unsigned long long* bar) {
  const unsigned b = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(b) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One bulk copy of `bytes` (a multiple of 16, both ends on 16 bytes) from
// global `src` to shared `dst`, counted by `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  const unsigned b = (unsigned)__cvta_generic_to_shared(bar);
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(b), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];"
      ::"r"(d), "l"(src), "r"(bytes), "r"(b) : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned long long* bar,
                                         unsigned parity) {
  const unsigned b = (unsigned)__cvta_generic_to_shared(bar);
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(b), "r"(parity) : "memory");
}

// The first y row of a step's window: off, plus rows where negative (a
// negative index counts from the end), clamped to [0, rows - 8].
__device__ __forceinline__ int slice_start(int off, int rows) {
  return min(max(off < 0 ? off + rows : off, 0), rows - 8);
}

// Adds the window's rows [cur, cur + 8) into y (lanes 4k .. 4k + 3).
__device__ __forceinline__ void flush_window(float* __restrict__ out,
                                             const float4 (&acc)[8], int cur,
                                             int k) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
    red4(out + (size_t)(cur + i) * kLanes + 4 * k, acc[i]);
}

// Moves the window to start at `off`: rows cur .. off - 1 leave it, each
// final for the chunk, when 0 < off - cur < 8; else all eight (a jump back,
// or past the window) and a new window starts empty.  cur < 0: none yet.
__device__ __forceinline__ void move_window(float* __restrict__ out,
                                            float4 (&acc)[8], int& cur,
                                            int off, int k) {
  if (cur >= 0 && off > cur && off - cur < 8) {
    for (; cur < off; ++cur) {
      red4(out + (size_t)cur * kLanes + 4 * k, acc[0]);
#pragma unroll
      for (int i = 0; i < 7; ++i) acc[i] = acc[i + 1];
      acc[7] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }
  if (cur >= 0) flush_window(out, acc, cur, k);
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  cur = off;
}

// One warp a block, steps [kDynChunk * b, kDynChunk * b + kDynChunk): v's
// rows of kDynPiece steps at a time by bulk copies into kDynBufs buffers,
// summed into the window and added into the zeroed out.
__global__ void __launch_bounds__(32) dynslice_accum_kernel(
    const int32_t* __restrict__ offs, const float* __restrict__ v,
    float* __restrict__ out, int T, int rows) {
  extern __shared__ __align__(128) float4 steps[];  // [buf][step][row][32]
  __shared__ __align__(8) unsigned long long bar[kDynBufs];
  const int k = threadIdx.x;
  const int t0 = blockIdx.x * kDynChunk, n_t = min(kDynChunk, T - t0);
  const int pieces = (n_t + kDynPiece - 1) / kDynPiece;
  auto piece_steps = [&](int p) {
    return min(kDynPiece, n_t - p * kDynPiece);
  };
  auto issue = [&](int p) {
    bulk_load(steps + (p % kDynBufs) * kDynPiece * 8 * 32,
              v + (size_t)(t0 + p * kDynPiece) * kStepFloats,
              piece_steps(p) * kStepFloats * 4, bar + p % kDynBufs);
  };
  if (k == 0) {
    for (int i = 0; i < kDynBufs; ++i) bar_init(bar + i);
    for (int p = 0; p < pieces && p < kDynBufs; ++p) issue(p);
  }
  __syncwarp();
  float4 acc[8];
  int cur = -1;
  for (int p = 0; p < pieces; ++p) {
    const int ns = piece_steps(p);
    const int my_off =
        k < ns ? slice_start(__ldg(offs + t0 + p * kDynPiece + k), rows) : 0;
    bar_wait(bar + p % kDynBufs, (p / kDynBufs) & 1);
    const float4* s = steps + (p % kDynBufs) * kDynPiece * 8 * 32;
    for (int st = 0; st < ns; ++st) {
      const int off = __shfl_sync(kFull, my_off, st);
      float4 r[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) r[i] = s[(st * 8 + i) * 32 + k];
      if (off != cur) move_window(out, acc, cur, off, k);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[i].x += r[i].x;
        acc[i].y += r[i].y;
        acc[i].z += r[i].z;
        acc[i].w += r[i].w;
      }
    }
    __syncwarp();  // every lane has read the buffer before it is refilled
    if (k == 0 && p + kDynBufs < pieces) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      issue(p + kDynBufs);
    }
  }
  if (cur >= 0) flush_window(out, acc, cur, k);
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

constexpr int kMaxDevices = 64;

// Lets `kernel` take `bytes` of dynamic shared memory on the current
// device; `allowed` (one a kernel) keeps what each device was given, so the
// attribute is set once a device and size: a call costs the host time of a
// launch or more, which the probes' loops of eager calls would read.
cudaError_t allow_shared(const void* kernel, int bytes,
                         int (&allowed)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes <= allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) allowed[dev] = bytes;
  return err;
}

// out (G, 128) = val * x[idx, lane] from a table in shared memory, SL
// lanes of it a block, kTableBlocksPerSM blocks an SM.
template <typename V, typename I, int SL>
int launch_table(const I* idx, const V* val, const V* x, V* out, int G,
                 int rows, cudaStream_t stream) {
  const int bytes = rows * SL * (int)sizeof(V);
  static int allowed[kMaxDevices] = {};
  auto kernel = gather_mul_table_kernel<V, I, SL>;
  cudaError_t err = allow_shared((const void*)kernel, bytes, allowed);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  constexpr int kSlices = kLanes / SL;
  const int parts =
      max(1, min(G, (sms * kTableBlocksPerSM + kSlices - 1) / kSlices));
  kernel<<<kSlices * parts, kTableThreads, bytes, stream>>>(
      idx, val, x, out, G, rows, parts, aligned16(x));
  return (int)cudaGetLastError();
}

template <typename V, typename I, int K>
int launch_kind(const void* col, const void* val, const void* x,
                const void* blk, const void* sub, const void* sel, void* out,
                int n, int w, int a, int b, cudaStream_t stream) {
  constexpr int N = 16 / sizeof(V);  // elements a 16-byte access of val
  const bool vec = aligned16(col) && aligned16(val) && aligned16(out) &&
                   (K != kPal2step || aligned16(sel));
  if (vec)
    gather_mul_kernel<V, I, K, N><<<grid_of(n / N), kThreads, 0, stream>>>(
        (const I*)col, (const V*)val, (const V*)x, (const int32_t*)blk,
        (const int32_t*)sub, (const int32_t*)sel, (V*)out, n, w, a, b);
  else
    gather_mul_kernel<V, I, K, 1><<<grid_of(n), kThreads, 0, stream>>>(
        (const I*)col, (const V*)val, (const V*)x, (const int32_t*)blk,
        (const int32_t*)sub, (const int32_t*)sel, (V*)out, n, w, a, b);
  return (int)cudaGetLastError();
}

// kSublane takes a = the rows of x.
template <typename V, typename I>
int launch_gather(const void* col, const void* val, const void* x,
                  const void* blk, const void* sub, const void* sel,
                  void* out, int n, int w, int kind, int a, int b,
                  void* stream) {
  if (n < 0 || w < kLanes || w % kLanes || n % w || kind < kLane ||
      kind > kSublane || (kind == kSublane && (w != kLanes || a < 1)) ||
      (kind == kPalette && b < 1))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (kind) {
    case kLane:
      return launch_kind<V, I, kLane>(col, val, x, blk, sub, sel, out, n, w,
                                      a, b, st);
    case kLevels:
      return launch_kind<V, I, kLevels>(col, val, x, blk, sub, sel, out, n,
                                        w, a, b, st);
    case kPalette:
      return launch_kind<V, I, kPalette>(col, val, x, blk, sub, sel, out, n,
                                         w, a, b, st);
    case kPal2step:
      return launch_kind<V, I, kPal2step>(col, val, x, blk, sub, sel, out, n,
                                          w, a, b, st);
  }
  // kSublane: a slice of lanes of every row of x in shared memory, or x
  // in device memory where the slice does not fit
  if ((long long)a * kSliceLanes * (long long)sizeof(V) <= kMaxSharedBytes)
    return launch_table<V, I, kSliceLanes>((const I*)col, (const V*)val,
                                           (const V*)x, (V*)out, n / kLanes,
                                           a, st);
  return launch_kind<V, I, kSublane>(col, val, x, blk, sub, sel, out, n, w,
                                     a, b, st);
}

}  // namespace

// Each entry launches one kernel on `stream` and returns cudaGetLastError().
// Pointers are device pointers to contiguous arrays in the layout of
// ops/probes.py; a pointer that the kind does not read may be null.

// out (h, w) = val * x[row, lane] over n = h * w elements, rows and lanes by
// `kind`; blk, sub and sel only for the palette kinds; kSublane takes the
// rows of x as `a`.
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

// `out` (rows, 128) must be zeroed; v is (T * 8, 128) on 16 bytes.
extern "C" int probe_dynslice_f32(const void* offs, const void* v, void* out,
                                  int T, int rows, void* stream) {
  if (T < 0 || rows < 8 || !aligned16(v)) return (int)cudaErrorInvalidValue;
  if (T == 0) return 0;
  static int allowed[kMaxDevices] = {};
  const cudaError_t err = allow_shared((const void*)dynslice_accum_kernel,
                                       kDynSharedBytes, allowed);
  if (err != cudaSuccess) return (int)err;
  dynslice_accum_kernel<<<(T + kDynChunk - 1) / kDynChunk, 32,
                          kDynSharedBytes, (cudaStream_t)stream>>>(
      (const int32_t*)offs, (const float*)v, (float*)out, T, rows);
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
