// Stream-row machinery of the panel (SpMM) kernels: slab_spmm_kernel
// (slab.cu), xch_mul_panel_kernel and xch_route4_panel_kernel (xch.cu),
// for storage type S = float or __nv_bfloat16 of val and of the panel they
// gather.  A bfloat16 value is widened to float where it is loaded
// (stage_row, load_cols, walk_batch): the staged values, the run sums, the
// carries and out stay float, so every sum is taken in float and out is
// never added to by a bfloat16 atomic.
//
// The panels are interleaved: panel row c holds the B column values of
// slot column c contiguously ((CB, 128, B) for x, (n_chunks, P1, 128, B)
// for xch's products, (rows, 128, B) for the routes' out), so one slot's B
// values are one access of 4B bytes.
//
// A warp owns a stream row of 128 slots, as in stream_row.cuh, but its
// lanes map to columns: a group of C lanes (C a power of two up to 32, the
// column tile) takes C consecutive columns, and the warp's G = 32 / C groups
// each walk S = 128 / G = 4C consecutive slots.  Per row:
//   stage  each lane loads its four slots' lane, sub, hm1 (and val) as in
//          stream_row.cuh and writes them, with the panel row the slot
//          gathers, to a per-warp shared buffer; slot l sits at l + l / S,
//          so the G groups' reads of one step fall in distinct banks;
//   dest   the kernel reads each of its index planes once and writes,
//          into the staged slot of each routed end lane e, the out
//          position where e's run goes;
//   walk   lane (g, c) walks the S slots of segment g: gathers column c of
//          the slot's panel row (the group's C lanes read C consecutive
//          values: one coalesced access per slot), multiplies by val
//          (slab), and keeps a run sum that restarts at each run head
//          (hm1 = l - 1).  At a slot with a destination it adds the run
//          sum into out with a global atomic (the group's C lanes: C
//          consecutive floats), unless no head came before it in the
//          segment: that run began in an earlier segment, and its end
//          waits for the carry;
//   carry  a segmented scan over the G groups (shuffles C lanes apart)
//          gives each segment the sum of the run that enters it; the
//          waiting end (at most one per segment) adds its run sum plus
//          that carry.
// The prefix of stream_row.cuh (a 32-lane shuffle scan per column) becomes
// serial sums plus a scan of G steps, and the run totals are taken once
// per row and column tile.  An added run sum equals W[e] = P[e] - P[hm1[e]]
// of stream_row.cuh where hm1 and idx describe runs as the converts lay
// them out: every slot of a run holds its head - 1 in hm1, and a stream
// row routes each run end at most once (idx names distinct end lanes).
#pragma once

#include "stream_row.cuh"

namespace {

// One staged slot of a stream row (16 bytes: one shared access per step).
struct PanelSlot {
  int col;    // the panel row the slot gathers
  float val;  // the slot's value (unread by the kernels without a multiply)
  int hd;     // hm1: the head of the slot's run, less one
  int dest;   // where the run ending at the slot goes; -1: nowhere
};

// Staged slots per warp: the row's 128 and a gap after each segment.
constexpr int kPanelStage = kLanes + 32;
// Slots a lane walks per batch: their panel gathers are in flight together.
constexpr int kWalkBatch = 8;

// The lane groups of a column tile of C columns (C a power of two <= 32),
// each lane taking V adjacent columns (the routes: 1; xch_mul_panel: 4,
// with one 16-byte gather, where B is a multiple of 4): a group of
// L = C / V lanes walks S = 4L slots, and lane (g, j) takes columns
// c..c+V-1, c = jV, of the tile.
struct LaneGroups {
  int C, L, G, S, g, c, l_log, s_log;
  __device__ LaneGroups(int C_, int V) {
    const int k = threadIdx.x & 31;
    C = C_;
    L = C_ / V;
    l_log = __ffs(L) - 1;
    G = 32 >> l_log;
    S = 4 * L;
    s_log = l_log + 2;
    g = k >> l_log;
    c = (k & (L - 1)) * V;
  }
  // where slot l of the row is staged
  __device__ int pos(int l) const { return l + (l >> s_log); }
};

// The widest column tile, a power of two up to 32, that covers B columns;
// at least 4 where a lane takes 4 columns.
__device__ __forceinline__ int column_tile(int B, int V = 1) {
  int C = V;
  while (C < B && C < 32) C <<= 1;
  return C;
}

// The V consecutive values at p, widened to float: where V is 4, one
// 16-byte load of four floats or one 8-byte load of four bfloat16 (p
// aligned to it).
template <int V, typename S>
__device__ __forceinline__ void load_cols(const S* __restrict__ p,
                                          float (&v)[V]) {
  if constexpr (V == 4) {
    float4 a;
    if constexpr (sizeof(S) == 2) {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
      a = make_float4(bf16_bits(u.x & 0xffffu), bf16_bits(u.x >> 16),
                      bf16_bits(u.y & 0xffffu), bf16_bits(u.y >> 16));
    } else {
      a = __ldg(reinterpret_cast<const float4*>(p));
    }
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = ldg_acc(p + j);
  }
}

// The V floats v stored at p in storage type S, each rounded once (to
// nearest) at bfloat16: one 16-byte store of four floats or one 8-byte
// store of four bfloat16 where V is 4 (p aligned to it).
template <int V, typename S>
__device__ __forceinline__ void store_cols(S* __restrict__ p,
                                           const float (&v)[V]) {
  if constexpr (V == 4) {
    store4(p, make_float4(v[0], v[1], v[2], v[3]));
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if constexpr (sizeof(S) == 2)
        p[j] = __float2bfloat16_rn(v[j]);
      else
        p[j] = v[j];
    }
  }
}

// Stages stream row r: the calling lane writes its slots 4k..4k+3, each
// gathering panel row col0 + (win[r] + sub) * 128 + lane, with no
// destination.  val (of storage type S, staged as float) is read only when
// kVal, hm1 only when not null.
template <bool kVal, typename S>
__device__ __forceinline__ void stage_row(PanelSlot* st, const LaneGroups& lg,
                                          int r, int m, int col0,
                                          const int32_t* __restrict__ win,
                                          const int8_t* __restrict__ lane,
                                          const int8_t* __restrict__ sub,
                                          const S* __restrict__ val,
                                          const int8_t* __restrict__ hm1) {
  const int k = threadIdx.x & 31;
  const size_t o = (size_t)r * kLanes + 4 * k;
  const char4 ln = load_c4(lane + o);
  const char4 hd = hm1 ? load_c4(hm1 + o) : make_char4(0, 0, 0, 0);
  const char4 sb = m > 1 ? load_c4(sub + o) : make_char4(0, 0, 0, 0);
  const float4 v = kVal ? load4(val + o) : make_float4(0.f, 0.f, 0.f, 0.f);
  const int base = col0 + win[r] * kLanes;
  PanelSlot* p = st + lg.pos(4 * k);  // S >= 4: the four share a segment
  p[0] = {base + sb.x * kLanes + ln.x, v.x, hd.x, -1};
  p[1] = {base + sb.y * kLanes + ln.y, v.y, hd.y, -1};
  p[2] = {base + sb.z * kLanes + ln.z, v.z, hd.z, -1};
  p[3] = {base + sb.w * kLanes + ln.w, v.w, hd.w, -1};
}

// Destinations d..d+3 for the end lanes e of the calling lane's four
// entries of one index plane (e < 0: none).
__device__ __forceinline__ void set_dest(PanelSlot* st, const LaneGroups& lg,
                                         char4 e, int d) {
  if (e.x >= 0) st[lg.pos(e.x)].dest = d;
  if (e.y >= 0) st[lg.pos(e.y)].dest = d + 1;
  if (e.z >= 0) st[lg.pos(e.z)].dest = d + 2;
  if (e.w >= 0) st[lg.pos(e.w)].dest = d + 3;
}

// Reads n index planes of the staged row, plane j's 128 end lanes at
// e0 + j * stride, and gives the routed end lanes of plane j the out
// positions d0 + j * 128 + their lane.
__device__ __forceinline__ void read_dests(PanelSlot* st, const LaneGroups& lg,
                                           const int8_t* __restrict__ e0,
                                           size_t stride, int n, int d0) {
  const int k = threadIdx.x & 31;
  for (int j = 0; j < n; ++j)
    set_dest(st, lg, load_c4(e0 + j * stride + 4 * k),
             d0 + j * kLanes + 4 * k);
}

// One batch of U slots from slot i of segment g (see walk_row).
template <int U, bool kVal, typename S>
__device__ __forceinline__ void walk_batch(const PanelSlot* sp, int i, int l0,
                                           const S* __restrict__ xc,
                                           int B, bool on, float& run,
                                           bool& headed, int& wait,
                                           float& wait_sum,
                                           float* __restrict__ oc) {
  PanelSlot q[U];
  float xv[U];
#pragma unroll
  for (int u = 0; u < U; ++u) q[u] = sp[i + u];
#pragma unroll
  for (int u = 0; u < U; ++u)
    xv[u] = on ? ldg_acc(xc + (size_t)q[u].col * B) : 0.f;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const float p = kVal ? q[u].val * xv[u] : xv[u];
    const bool head = q[u].hd == l0 + i + u - 1;
    run = head ? p : run + p;
    headed |= head;
    if (q[u].dest >= 0) {
      if (!headed) {
        wait = q[u].dest;
        wait_sum = run;
      } else if (on) {
        atomicAdd(oc + (size_t)q[u].dest * B, run);
      }
    }
  }
}

// Walks segment g of a staged row for column c of the tile and adds each
// run total into out position dest: xc and oc point at column c of panel
// row 0 (of storage type S) and of out position 0 (float), B is the width
// of both (their row stride), `on` is false past the panel's last column
// (those lanes gather and add nothing, but take part in the carry's
// shuffles).  Called by the whole warp.
template <bool kVal, typename S>
__device__ __forceinline__ void walk_row(const PanelSlot* st,
                                         const LaneGroups& lg,
                                         const S* __restrict__ xc,
                                         float* __restrict__ oc, int B,
                                         bool on) {
  const PanelSlot* sp = st + lg.g * (lg.S + 1);
  const int l0 = lg.g * lg.S;
  float run = 0.f, wait_sum = 0.f;
  bool headed = false;  // a run head came before, in this segment
  int wait = -1;        // the end whose run began before the segment
  int i = 0;
  for (; i + kWalkBatch <= lg.S; i += kWalkBatch)
    walk_batch<kWalkBatch, kVal, S>(sp, i, l0, xc, B, on, run, headed,
                                    wait, wait_sum, oc);
  for (; i < lg.S; i += 4)  // S = 4L: a multiple of 4
    walk_batch<4, kVal, S>(sp, i, l0, xc, B, on, run, headed, wait,
                           wait_sum, oc);
  // segmented inclusive scan of (headed, run) over the groups: run becomes
  // the sum since the last head up to the end of segment g; the carry into
  // g is g - 1's
  int f = headed;
  for (int d = 1; d < lg.G; d <<= 1) {
    const float vu = __shfl_up_sync(kFull, run, d * lg.L);
    const int fu = __shfl_up_sync(kFull, f, d * lg.L);
    if (lg.g >= d) {
      if (!f) run += vu;
      f |= fu;
    }
  }
  const float carry = __shfl_up_sync(kFull, run, lg.L & 31);
  if (wait >= 0 && on)
    atomicAdd(oc + (size_t)wait * B, wait_sum + (lg.g > 0 ? carry : 0.f));
}

// The route of a staged row with destinations: walk_row for each column
// tile of the B columns, the panel (of storage type S) at x, the float out
// positions at out.
template <bool kVal, typename S>
__device__ __forceinline__ void route_row(const PanelSlot* st,
                                          const LaneGroups& lg,
                                          const S* __restrict__ x,
                                          float* __restrict__ out, int B) {
  for (int b0 = 0; b0 < B; b0 += lg.C)
    walk_row<kVal, S>(st, lg, x + b0 + lg.c, out + b0 + lg.c, B,
                      lg.c < B - b0);
}

}  // namespace
