"""A/B of the probe kernels redesigned for the card: ``tile_transpose``,
``onehot_bins``, the gathers (``gather_mul_kernel`` and its shared-memory
sublane table, ``gather_mul_table_kernel``) and ``dynslice_accum``
(``csrc/probes.cu``).

    python -m singlespmv_tpu_torch.harness.probes_ab [variant ...]
                                          # needs a GPU and nvcc

Builds ``csrc/probes.cu`` as it is and the variants of ``VARIANTS``, each a
copy of ``csrc/`` with text substitutions, with the flags of
``ops/_build.py`` into temporary directories (``panel_ab.build_variant``,
eight builds at a time).  The first port's kernels (one thread an out
element with 64-bit divisions for the transpose and the gathers, the
gathers' kind a run-time switch; a warp a tile with shared atomics for the
bin sums; one global atomicAdd an element for the accumulate) live here,
not in ``csrc/``, and come back as variants.  Then it times each kernel
family on its cases, loading each build in turn in place of the port's
library, over two passes (the variants in order, then reversed): the
transpose at the probe's 256 × 256 × 128 and at the three ``xla_transpose``
shapes of the reference's suite; the bin sums at the probe's G 8,192 with
its uniform bins and with bins in [0, 16) and [0, 4); every gather call of
``microbench.KERNEL_CASES`` (lane, levels, palette, pal2step and sublane, 22
calls); the accumulate at the probe's T 4,096 sorted offs, the same offs
permuted, every off equal, offs over [−64, 1,100) (both clamps act), and T
1 and 3.  A time is the device busy µs of one wrapper call from a complete
torch.profiler trace (``driver.busy_seconds``): every device event of it
(kernels and memsets), but the accumulate's kernel alone (its wrapper's
memset of y apart).  Beside them: the PyTorch call that computes the same
function (``.transpose(0, 1).contiguous()``, ``scatter_add_`` into a zeroed
(tiles, 128) grid, ``index_add_``; none for the gathers) and the bound (each
input read once, the output written once, at 3.35 TB/s).  Every variant
computes the same function and is held to the plain version (the transpose
and the gathers exactly, the sums within 1e-5·max|out|).  It prints the
card's name and power limit and, for each build's kernels, ptxas's
registers and static shared memory and the counts of shared-memory
compare-and-swap (``ATOMS.CAST``), global reduction (``RED``) and global
atomic (``ATOM``) instructions in the SASS (cuobjdump).
"""
from __future__ import annotations

import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..ops import _build, probes
from .driver import busy_seconds
from .microbench import (KERNEL_CASES, dynslice_accum_case,
                         dynslice_odd_offs, onehot_bins_case)
from .panel_ab import build_variant

HBM_BPS = 3.35e12   # H100 SXM device memory, NVIDIA's data sheet
TOL = 1e-5
# the variants' own kernels go above the C entries, at file scope
ENTRIES = "// Each entry launches one kernel on `stream`"
TRANSPOSE_LAUNCH = "  if ((unsigned long long)CB * NU * S < (1ull << 32))"
ONEHOT_LAUNCH = ("  onehot_bins_kernel<<<G / 8, kTileThreads, 0, "
                 "(cudaStream_t)stream>>>(\n"
                 "      (const int32_t*)bins, (const float*)val, "
                 "(float*)out);")

# the first port's transpose: one thread an out element, 64-bit divisions
FIRST_TRANSPOSE = r"""
__global__ void __launch_bounds__(256) tile_transpose_first_kernel(
    const float* __restrict__ in, float* __restrict__ out, int CB, int NU,
    int S) {
  const long long n = (long long)CB * NU * S, row = (long long)CB * S;
  for (long long o = blockIdx.x * 256LL + threadIdx.x; o < n;
       o += (long long)gridDim.x * 256) {
    const long long nu = o / row, rem = o - nu * row;
    const long long cb = rem / S, s = rem - cb * S;
    out[o] = in[(cb * NU + nu) * S + s];
  }
}
"""
# a warp a run, a block 64 consecutive runs of out (no brick), float4 only
FLAT_TRANSPOSE = r"""
__global__ void __launch_bounds__(256) tile_transpose_flat_kernel(
    const float4* __restrict__ in, float4* __restrict__ out, int CB, int NU,
    int L) {
  const long long runs = (long long)CB * NU;
  const int warp = threadIdx.x >> 5, k = threadIdx.x & 31;
  size_t src[8], dst[8];
  bool ok[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const long long R = blockIdx.x * 64LL + u * 8 + warp;
    const int nu = (int)(R / CB), cb = (int)(R - (long long)nu * CB);
    ok[u] = R < runs;
    src[u] = ((size_t)cb * NU + nu) * L;
    dst[u] = (size_t)R * L;
  }
  for (int e = k; e < L; e += 32) {
    float4 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (ok[u]) v[u] = __ldcs(in + src[u] + e);
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (ok[u]) __stcs(out + dst[u] + e, v[u]);
  }
}
"""
# one thread a brick: 1-D bulk copies global -> shared (an mbarrier counts
# the bytes), then one bulk copy a brick's out row shared -> global
BULK_TRANSPOSE = r"""
__global__ void __launch_bounds__(32) tile_transpose_bulk_kernel(
    const float* __restrict__ in, float* __restrict__ out, int CB, int NU,
    int S) {
  extern __shared__ __align__(128) float brick[];  // [j][c][S]
  __shared__ __align__(8) unsigned long long bar;
  if (threadIdx.x) return;
  const int bricks_nu = (NU + 7) / 8;
  const int bc = blockIdx.x / bricks_nu, bn = blockIdx.x - bc * bricks_nu;
  const int cb0 = bc * 8, nu0 = bn * 8;
  const int ncb = min(8, CB - cb0), nnu = min(8, NU - nu0);
  const unsigned run_bytes = 4u * S;
  const unsigned mb = (unsigned)__cvta_generic_to_shared(&bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(mb) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(mb), "r"(ncb * nnu * run_bytes) : "memory");
  for (int c = 0; c < ncb; ++c)
    for (int j = 0; j < nnu; ++j) {
      const unsigned dst =
          (unsigned)__cvta_generic_to_shared(brick + (j * 8 + c) * S);
      const float* src = in + ((size_t)(cb0 + c) * NU + nu0 + j) * S;
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];"
          ::"r"(dst), "l"(src), "r"(run_bytes), "r"(mb) : "memory");
    }
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(mb) : "memory");
  for (int j = 0; j < nnu; ++j) {
    const unsigned src =
        (unsigned)__cvta_generic_to_shared(brick + j * 8 * S);
    float* dst = out + ((size_t)(nu0 + j) * CB + cb0) * S;
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                 ::"l"(dst), "r"(src), "r"(ncb * run_bytes) : "memory");
  }
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
"""
# the first port's bin sums: a warp a tile, shared atomicAdd per element
FIRST_ONEHOT = r"""
__global__ void __launch_bounds__(256) onehot_bins_first_kernel(
    const int32_t* __restrict__ bins, const float* __restrict__ val,
    float* __restrict__ out, int tiles) {
  __shared__ float hist[8][kLanes];
  const int warp = threadIdx.x >> 5, k = threadIdx.x & 31;
  const int tile = blockIdx.x * 8 + warp;
  if (tile >= tiles) return;
  float* hw = hist[warp];
  for (int j = k; j < kLanes; j += 32) hw[j] = 0.f;
  __syncwarp();
  const size_t base = (size_t)tile * 8 * kLanes;
  for (int i = k; i < 8 * kLanes; i += 32) {
    const int b = bins[base + i];
    if (b >= 0 && b < kLanes) atomicAdd(hw + b, val[base + i]);
  }
  __syncwarp();
  for (int i = k; i < 8 * kLanes; i += 32)
    out[base + i] = hw[i & (kLanes - 1)];
}
"""
# every step's lanes matched and summed by the shuffle tree, no bids
TREE_ONLY = {"constexpr int kBidRounds = 2;": "constexpr int kBidRounds = 0;"}
# the lanes of one bin matched by a ballot on each of its 8 bits, at a cost
# that does not grow with the distinct bins as __match_any_sync's does
MATCH8 = r"""
__device__ __forceinline__ unsigned match8(int key) {
  unsigned peers = kFull;
#pragma unroll
  for (int bit = 0; bit < 8; ++bit) {
    const bool on = (key >> bit) & 1;
    const unsigned set = __ballot_sync(kFull, on);
    peers &= on ? set : ~set;
  }
  return peers;
}

"""
SUM_PEERS = "// The sum of v over the lanes of `peers`"
BALLOTS = {SUM_PEERS: MATCH8 + SUM_PEERS,
           "unsigned peers = __match_any_sync(kFull, todo ? key : kLanes);":
               "unsigned peers = match8(todo ? key : kLanes);"}
WARPS4 = {"constexpr int kTileWarps = 8;": "constexpr int kTileWarps = 4;"}
# native global reductions (RED.ADD.F32) into row 0 of each tile's out,
# zeroed first, then a kernel copies row 0 to rows 1-7
RED_ONEHOT = r"""
__global__ void __launch_bounds__(256) onehot_red_kernel(
    const int32_t* __restrict__ bins, const float* __restrict__ val,
    float* __restrict__ out) {
  const size_t tile = (size_t)blockIdx.x * 8 * kLanes;
  const int4 b = reinterpret_cast<const int4*>(bins + tile)[threadIdx.x];
  const float4 v = reinterpret_cast<const float4*>(val + tile)[threadIdx.x];
  float* row0 = out + tile;
  if ((unsigned)b.x < (unsigned)kLanes) atomicAdd(row0 + b.x, v.x);
  if ((unsigned)b.y < (unsigned)kLanes) atomicAdd(row0 + b.y, v.y);
  if ((unsigned)b.z < (unsigned)kLanes) atomicAdd(row0 + b.z, v.z);
  if ((unsigned)b.w < (unsigned)kLanes) atomicAdd(row0 + b.w, v.w);
}

__global__ void __launch_bounds__(256) onehot_rows_kernel(
    float* __restrict__ out) {
  const size_t tile = (size_t)blockIdx.x * 8 * kLanes;
  const float4* r0 = reinterpret_cast<const float4*>(out + tile);
  float4* o = reinterpret_cast<float4*>(out + tile + kLanes);
  if (threadIdx.x < 7 * 32) o[threadIdx.x] = r0[threadIdx.x & 31];
}
"""

GATHER_LAUNCH = ("  const cudaStream_t st = (cudaStream_t)stream;\n"
                 "  switch (kind) {")
SUBLANE_DISPATCH = "  if ((long long)a * kSliceLanes * (long long)sizeof(V)"
# the gathers' launchers, in the file's namespace: a kernel they launch goes
# above them
LAUNCHERS = "// out (G, 128) = val * x[idx, lane] from a table in shared memory"
# the first port's gathers: one thread an element, 64-bit index arithmetic,
# the kind a run-time switch, scalar loads
FIRST_GATHER = r"""
template <typename V, typename I>
__global__ void __launch_bounds__(256) gather_first_kernel(
    const I* __restrict__ col, const V* __restrict__ val,
    const V* __restrict__ x, const int32_t* __restrict__ blk,
    const int32_t* __restrict__ sub, const int32_t* __restrict__ sel,
    V* __restrict__ out, long long n, int w, int kind, int a, int b) {
  const int per_row = w / kLanes;
  for (long long e = blockIdx.x * 256LL + threadIdx.x; e < n;
       e += (long long)gridDim.x * 256) {
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
        const int s = ci >> 7;
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
      default:
        row = ci;
        ln = c;
    }
    const float g = hit ? to_f(x[row * kLanes + ln]) : 0.f;
    V o;
    from_f(o, to_f(val[e]) * g);
    out[e] = o;
  }
}
"""
# the first port's accumulate: one global atomicAdd an element (with the
# window start of slice_start, which the first port lacked for negative offs)
FIRST_DYNSLICE = r"""
__global__ void __launch_bounds__(256) dynslice_first_kernel(
    const int32_t* __restrict__ offs, const float* __restrict__ v,
    float* __restrict__ out, long long n, int rows) {
  for (long long e = blockIdx.x * 256LL + threadIdx.x; e < n;
       e += (long long)gridDim.x * 256) {
    const long long t = e / (8 * kLanes);
    const int i = (int)(e / kLanes) & 7, l = (int)(e % kLanes);
    const int off = slice_start(offs[t], rows);
    atomicAdd(out + (size_t)(off + i) * kLanes + l, v[e]);
  }
}
"""
DYNSLICE_LAUNCH = ("  static int allowed[kMaxDevices] = {};\n"
                   "  const cudaError_t err = allow_shared(")
# the window as a ring of 8 rows in shared memory (row r in slot r % 8): no
# register shifts, a shared load and store a row a step
SMEM_WINDOW = r"""
__global__ void __launch_bounds__(32) dynslice_smem_window_kernel(
    const int32_t* __restrict__ offs, const float* __restrict__ v,
    float* __restrict__ out, int T, int rows) {
  extern __shared__ __align__(128) float4 steps[];
  __shared__ __align__(8) unsigned long long bar[kDynBufs];
  __shared__ float4 win[8][32];
  const int k = threadIdx.x;
  const int t0 = blockIdx.x * kDynChunk, n_t = min(kDynChunk, T - t0);
  const int pieces = (n_t + kDynPiece - 1) / kDynPiece;
  auto piece_steps = [&](int p) { return min(kDynPiece, n_t - p * kDynPiece); };
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
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  int cur = -1;
  for (int p = 0; p < pieces; ++p) {
    const int ns = piece_steps(p);
    const int my_off =
        k < ns ? slice_start(__ldg(offs + t0 + p * kDynPiece + k), rows) : 0;
    bar_wait(bar + p % kDynBufs, (p / kDynBufs) & 1);
    const float4* s = steps + (p % kDynBufs) * kDynPiece * 8 * 32;
    for (int st = 0; st < ns; ++st) {
      const int off = __shfl_sync(kFull, my_off, st);
      if (off != cur) {
        if (cur >= 0 && off > cur && off - cur < 8) {
          for (; cur < off; ++cur) {
            red4(out + (size_t)cur * kLanes + 4 * k, win[cur & 7][k]);
            win[cur & 7][k] = zero;
          }
        } else {
          for (int i = 0; i < 8 && cur >= 0; ++i)
            red4(out + (size_t)(cur + i) * kLanes + 4 * k,
                 win[(cur + i) & 7][k]);
          for (int i = 0; i < 8; ++i) win[i][k] = zero;
          cur = off;
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 r = s[(st * 8 + i) * 32 + k];
        float4& w = win[(off + i) & 7][k];
        w.x += r.x;
        w.y += r.y;
        w.z += r.z;
        w.w += r.w;
      }
    }
    __syncwarp();
    if (k == 0 && p + kDynBufs < pieces) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      issue(p + kDynBufs);
    }
  }
  for (int i = 0; i < 8 && cur >= 0; ++i)
    red4(out + (size_t)(cur + i) * kLanes + 4 * k, win[(cur + i) & 7][k]);
}
"""
# rows that no step outside the chunk touches (a check over every off in
# the kernel) added with a plain load and store, the others with RED
EXCL_ROWS = r"""
__global__ void __launch_bounds__(32) dynslice_excl_kernel(
    const int32_t* __restrict__ offs, const float* __restrict__ v,
    float* __restrict__ out, int T, int rows) {
  extern __shared__ __align__(128) float4 steps[];
  __shared__ __align__(8) unsigned long long bar[kDynBufs];
  const int k = threadIdx.x;
  const int t0 = blockIdx.x * kDynChunk, n_t = min(kDynChunk, T - t0);
  const int pieces = (n_t + kDynPiece - 1) / kDynPiece;
  auto piece_steps = [&](int p) { return min(kDynPiece, n_t - p * kDynPiece); };
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
  auto clamped = [&](int t) { return slice_start(__ldg(offs + t), rows); };
  // bit r - lo of `mine`: row r in [lo, lo + 64) is this chunk's alone
  int lo = 0x7fffffff, hi = -1;
  for (int t = t0 + k; t < t0 + n_t; t += 32) {
    lo = min(lo, clamped(t));
    hi = max(hi, clamped(t));
  }
  lo = __reduce_min_sync(kFull, lo);
  hi = __reduce_max_sync(kFull, hi);
  unsigned long long mine = hi + 8 - lo <= 64 ? ~0ull : 0ull;
  for (int t = k; mine && t < T; t += 32) {
    if (t >= t0 && t < t0 + n_t) continue;
    const int o = clamped(t);
    const int a0 = max(o, lo) - lo, a1 = min(o + 8, lo + 64) - lo;
    if (a0 < a1) mine &= ~(((1ull << (a1 - a0)) - 1) << a0);
  }
  mine = (unsigned long long)__reduce_and_sync(kFull, (unsigned)mine) |
         (unsigned long long)__reduce_and_sync(kFull,
                                               (unsigned)(mine >> 32)) << 32;
  auto add_row = [&](int row, float4 a) {
    float* q = out + (size_t)row * kLanes + 4 * k;
    const int d = row - lo;
    if (d >= 0 && d < 64 && (mine >> d) & 1) {
      float4 o = *reinterpret_cast<float4*>(q);
      o.x += a.x, o.y += a.y, o.z += a.z, o.w += a.w;
      *reinterpret_cast<float4*>(q) = o;
    } else {
      red4(q, a);
    }
  };
  float4 acc[8];
  int cur = -1;
  for (int p = 0; p < pieces; ++p) {
    const int ns = piece_steps(p);
    const int my_off = k < ns ? clamped(t0 + p * kDynPiece + k) : 0;
    bar_wait(bar + p % kDynBufs, (p / kDynBufs) & 1);
    const float4* s = steps + (p % kDynBufs) * kDynPiece * 8 * 32;
    for (int st = 0; st < ns; ++st) {
      const int off = __shfl_sync(kFull, my_off, st);
      float4 r[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) r[i] = s[(st * 8 + i) * 32 + k];
      if (off != cur) {
        if (cur >= 0 && off > cur && off - cur < 8) {
          for (; cur < off; ++cur) {
            add_row(cur, acc[0]);
#pragma unroll
            for (int i = 0; i < 7; ++i) acc[i] = acc[i + 1];
            acc[7] = make_float4(0.f, 0.f, 0.f, 0.f);
          }
        } else {
          for (int i = 0; i < 8 && cur >= 0; ++i) add_row(cur + i, acc[i]);
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
          cur = off;
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[i].x += r[i].x;
        acc[i].y += r[i].y;
        acc[i].z += r[i].z;
        acc[i].w += r[i].w;
      }
    }
    __syncwarp();
    if (k == 0 && p + kDynBufs < pieces) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      issue(p + kDynBufs);
    }
  }
  for (int i = 0; i < 8 && cur >= 0; ++i) add_row(cur + i, acc[i]);
}
"""


def _dynslice_kernel(name: str) -> dict:
    """Substitutions that make the accumulate's C entry launch ``name``."""
    return {"allow_shared((const void*)dynslice_accum_kernel,":
                f"allow_shared((const void*){name},",
            "  dynslice_accum_kernel<<<": f"  {name}<<<"}


def _chunk(c: int) -> dict:
    return {"constexpr int kDynChunk = 16;": f"constexpr int kDynChunk = {c};"}


def _before(cond: str, launch: str) -> dict:
    """A substitution in the transpose's C entry: where ``cond`` holds, it
    makes the launch ``launch`` and returns before the built kernel's."""
    return {TRANSPOSE_LAUNCH: f"  if ({cond}) {{\n    {launch}\n    return "
                              f"(int)cudaGetLastError();\n  }}\n"
                              + TRANSPOSE_LAUNCH}


def _entry(kernel: str, launch: dict) -> dict:
    """Substitutions that add ``kernel`` above the C entries and then
    ``launch``'s."""
    return {ENTRIES: kernel + "\n" + ENTRIES} | launch


VARIANTS = {   # name → (kernel family, substitutions)
    "as built": (None, {}),
    "transpose first port": ("transpose", _entry(FIRST_TRANSPOSE, _before(
        "1", "tile_transpose_first_kernel<<<grid_of((long long)CB * NU * S), "
        "kThreads, 0, (cudaStream_t)stream>>>((const float*)in, (float*)out, "
        "CB, NU, S);"))),
    "transpose warp a run, no brick": ("transpose", _entry(
        FLAT_TRANSPOSE, _before(
            "vec", "tile_transpose_flat_kernel<<<(int)(((long long)CB * NU + "
            "63) / 64), kThreads, 0, (cudaStream_t)stream>>>((const float4*)"
            "in, (float4*)out, CB, NU, S / 4);"))),
    "transpose bulk copies": ("transpose", _entry(BULK_TRANSPOSE, _before(
        "vec && S <= 192", "tile_transpose_bulk_kernel<<<(CB + 7) / 8 * "
        "((NU + 7) / 8), 32, 256 * S, (cudaStream_t)stream>>>((const float*)"
        "in, (float*)out, CB, NU, S);"))),
    "transpose brick 8 x 8 at every S": ("transpose", {
        "  const int bnu = kBrick << (5 - run_lanes_log2(vec ? S / 4 : S));":
            "  const int bnu = kBrick;"}),
    "transpose 64-bit offsets": ("transpose", {
        "CB * NU * S < (1ull << 32))": "CB * NU * S < 0ull)"}),
    "transpose streaming stores": ("transpose", {
        "out[dst[u] + e] = v[u];": "__stcs(out + dst[u] + e, v[u]);"}),
    "transpose plain loads": ("transpose", {
        "v[u] = __ldcs(in + src[u] + e);": "v[u] = in[src[u] + e];"}),
    "transpose scalar path": ("transpose", {
        "const int vec = S % 4 == 0 && aligned16(in) && aligned16(out);":
            "const int vec = 0;"}),
    "onehot first port": ("onehot", _entry(FIRST_ONEHOT, {
        ONEHOT_LAUNCH: "  onehot_bins_first_kernel<<<(G / 8 + 7) / 8, 256, 0, "
                       "(cudaStream_t)stream>>>((const int32_t*)bins, "
                       "(const float*)val, (float*)out, G / 8);"})),
    "onehot shuffle tree only": ("onehot", TREE_ONLY),
    "onehot shuffle tree only, ballots": ("onehot", TREE_ONLY | BALLOTS),
    "onehot ballots": ("onehot", BALLOTS),
    "onehot bids only": ("onehot", {
        "constexpr int kBidRounds = 2;": "constexpr int kBidRounds = 1024;",
        "constexpr int kBidLeft = 4;": "constexpr int kBidLeft = 32;"}),
    "onehot bids: 3 rounds, 8 left": ("onehot", {
        "constexpr int kBidRounds = 2;": "constexpr int kBidRounds = 3;",
        "constexpr int kBidLeft = 4;": "constexpr int kBidLeft = 8;"}),
    "onehot bids: 6 rounds, 16 left": ("onehot", {
        "constexpr int kBidRounds = 2;": "constexpr int kBidRounds = 6;",
        "constexpr int kBidLeft = 4;": "constexpr int kBidLeft = 16;"}),
    "onehot streaming stores": ("onehot", {
        "o[i] = sums[i & (kLanes / 4 - 1)];":
            "__stcs(o + i, sums[i & (kLanes / 4 - 1)]);"}),
    "onehot shared atomicAdd": ("onehot", {
        "    add_step(hw, tw, key, v[j], round);":
            "    if (key < kLanes) atomicAdd(hw + key, v[j]);"}),
    "onehot global RED": ("onehot", _entry(RED_ONEHOT, {
        ONEHOT_LAUNCH: "  cudaMemset2DAsync(out, 8 * kLanes * 4, 0, "
                       "kLanes * 4, G / 8, (cudaStream_t)stream);\n"
                       "  onehot_red_kernel<<<G / 8, 256, 0, (cudaStream_t)"
                       "stream>>>((const int32_t*)bins, (const float*)val, "
                       "(float*)out);\n"
                       "  onehot_rows_kernel<<<G / 8, 256, 0, (cudaStream_t)"
                       "stream>>>((float*)out);"})),
    "onehot 4 warps a tile": ("onehot", WARPS4),
    "gather first port": (("gather", "sublane"), {
        LAUNCHERS: FIRST_GATHER + "\n" + LAUNCHERS,
        GATHER_LAUNCH: "  gather_first_kernel<V, I><<<grid_of(n), kThreads, "
                       "0, (cudaStream_t)stream>>>((const I*)col, (const V*)"
                       "val, (const V*)x, (const int32_t*)blk, (const "
                       "int32_t*)sub, (const int32_t*)sel, (V*)out, n, w, "
                       "kind, a, b);\n  return (int)cudaGetLastError();\n"
                       + GATHER_LAUNCH}),
    "gather scalar path": ("gather", {
        "  const bool vec = aligned16(col)":
            "  const bool vec = false && aligned16(col)"}),
    "gather streaming loads and stores": ("gather", {
        "raw[q] = reinterpret_cast<const int4*>(p)[q];":
            "raw[q] = __ldcs(reinterpret_cast<const int4*>(p) + q);",
        "reinterpret_cast<int4*>(p)[q] = raw[q];":
            "__stcs(reinterpret_cast<int4*>(p) + q, raw[q]);"}),
    "sublane slices of 8 lanes": ("sublane", {
        "constexpr int kSliceLanes = 32;": "constexpr int kSliceLanes = 8;"}),
    "sublane slices of 16 lanes": ("sublane", {
        "constexpr int kSliceLanes = 32;": "constexpr int kSliceLanes = 16;"}),
    "sublane whole table to 128 rows": ("sublane", {
        SUBLANE_DISPATCH: "  if (a <= 128)\n    return launch_table<V, I, "
                          "kLanes>((const I*)col, (const V*)val, (const V*)x, "
                          "(V*)out, n / kLanes, a, st);\n"
                          + SUBLANE_DISPATCH}),
    "sublane tables to 8 rows from device memory": ("sublane", {
        SUBLANE_DISPATCH: "  if (a <= 8)\n    return launch_kind<V, I, "
                          "kSublane>(col, val, x, blk, sub, sel, out, n, w, "
                          "a, b, st);\n" + SUBLANE_DISPATCH}),
    "sublane from device memory": ("sublane", {
        "constexpr int kMaxSharedBytes = 232448;":
            "constexpr int kMaxSharedBytes = 0;"}),
    "sublane 2 blocks a SM": ("sublane", {
        "constexpr int kTableBlocksPerSM = 1;":
            "constexpr int kTableBlocksPerSM = 2;"}),
    "sublane 8 rows in flight": ("sublane", {
        "constexpr int kRowsInFlight = 4;":
            "constexpr int kRowsInFlight = 8;"}),
    "dynslice first port": ("dynslice", _entry(FIRST_DYNSLICE, {
        DYNSLICE_LAUNCH: "  if (1) {\n    dynslice_first_kernel<<<grid_of("
                         "(long long)T * 8 * kLanes), kThreads, 0, "
                         "(cudaStream_t)stream>>>((const int32_t*)offs, "
                         "(const float*)v, (float*)out, (long long)T * 8 * "
                         "kLanes, rows);\n    return (int)cudaGetLastError();"
                         "\n  }\n" + DYNSLICE_LAUNCH})),
    "dynslice C 8": ("dynslice", _chunk(8)),
    "dynslice C 32": ("dynslice", _chunk(32)),
    "dynslice pieces of 8 steps": ("dynslice", {
        "constexpr int kDynPiece = 4;": "constexpr int kDynPiece = 8;"}),
    "dynslice C 64": ("dynslice", _chunk(64)),
    "dynslice C 256": ("dynslice", _chunk(256)),
    "dynslice scalar RED": ("dynslice", {
        "  atomicAdd(reinterpret_cast<float4*>(p), v);":
            "  atomicAdd(p, v.x);\n  atomicAdd(p + 1, v.y);\n"
            "  atomicAdd(p + 2, v.z);\n  atomicAdd(p + 3, v.w);"}),
    "dynslice window in shared memory": ("dynslice", _entry(
        SMEM_WINDOW, _dynslice_kernel("dynslice_smem_window_kernel"))),
    "dynslice exclusive rows without atomics": ("dynslice", _entry(
        EXCL_ROWS, _dynslice_kernel("dynslice_excl_kernel"))),
    "dynslice exclusive rows, C 256": ("dynslice", _entry(
        EXCL_ROWS, _dynslice_kernel("dynslice_excl_kernel")) | _chunk(256)),
}
KERNELS = ("tile_transpose_kernelIj", "tile_transpose_kernelIm",
           "tile_transpose_first_kernel",
           "tile_transpose_flat_kernel", "tile_transpose_bulk_kernel",
           "onehot_bins_kernel", "onehot_bins_first_kernel",
           "onehot_red_kernel", "onehot_rows_kernel", "gather_mul_kernel",
           "gather_mul_table_kernel", "gather_first_kernel", "dynslice_")
FAMILY_KERNELS = {"transpose": "tile_transpose", "onehot": "onehot_",
                  "gather": "gather_", "sublane": "gather_",
                  "dynslice": "dynslice_"}
TRANSPOSES = ((256, 256, 128), (64, 256, 128), (256, 256, 32),
              (1024, 256, 8))   # the probe's, xla_transpose s128, s32, s8


DYN_ROWS = 1024   # the probe's y


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def cases(dev) -> list:
    """(label, family, call, plain call, library call or None, bound µs,
    exact, the trace events timed) of every timed case."""
    rng = np.random.default_rng(8)
    out = []
    for cb, nu, s in TRANSPOSES:
        a = torch.from_numpy(rng.standard_normal((cb, nu * s)).astype(
            np.float32)).to(dev)
        out.append((f"transpose {cb}x{nu}x{s}", "transpose",
                    lambda a=a, nu=nu, s=s: probes.tile_transpose(a, nu, s),
                    lambda a=a, nu=nu, s=s: probes.tile_transpose_ref(a, nu,
                                                                       s),
                    lambda a=a, cb=cb, nu=nu, s=s: a.view(cb, nu, s).transpose(
                        0, 1).contiguous(),
                    2 * a.numel() * 4 / HBM_BPS * 1e6, True, ""))
    _, (binv, val), _ = onehot_bins_case(device=dev)
    tiles = val.shape[0] // 8
    for label, b in [("onehot G 8192", binv)] + [
            (f"onehot G 8192 bins < {n}", torch.from_numpy(rng.integers(
                0, n, binv.shape).astype(np.int32)).to(dev)) for n in (16, 4)]:
        idx = b.view(tiles, -1).long()
        acc = torch.zeros(tiles, 128, device=dev)
        out.append((label, "onehot",
                     lambda b=b: probes.onehot_bins(b, val),
                     lambda b=b: probes.onehot_bins_ref(b, val),
                     lambda idx=idx, acc=acc: acc.scatter_add_(
                         1, idx, val.view(tiles, -1)),
                     3 * val.numel() * 4 / HBM_BPS * 1e6, False, ""))
    for name, (case, kw) in KERNEL_CASES.items():
        fn, args, fkw = case(**kw, device=dev)
        if fn not in probes.GATHERS:
            continue
        ref = getattr(probes, fn.__name__ + "_ref")
        nbytes = _nbytes(*args, ref(*args, **fkw))
        out.append((name, "sublane" if fn is probes.sublane_gather
                    else "gather",
                    lambda fn=fn, args=args, fkw=fkw: fn(*args, **fkw),
                    lambda ref=ref, args=args, fkw=fkw: ref(*args, **fkw),
                    None, nbytes / HBM_BPS * 1e6, True, ""))
    v = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (8 * 4096, 128)).astype(np.float32)).to(dev)
    y = torch.zeros(DYN_ROWS, 128, device=dev)
    _, (probe_offs, _), _ = dynslice_accum_case(device="cpu")
    odd = {"T 4096 sorted (the probe's)": probe_offs.numpy()}
    for label, o in (odd | dynslice_odd_offs()).items():
        offs = torch.from_numpy(o).to(dev)
        vt = v[:8 * len(o)]
        dst = (probes.dynslice_starts(offs, DYN_ROWS)[:, None]
               + torch.arange(8, device=dev)).reshape(-1)
        out.append((f"dynslice {label}", "dynslice",
                    lambda offs=offs, vt=vt: probes.dynslice_accum(offs, vt),
                    lambda offs=offs, vt=vt: probes.dynslice_accum_ref(offs,
                                                                       vt),
                    lambda dst=dst, vt=vt: y.index_add_(0, dst, vt),
                    _nbytes(offs, vt, y) / HBM_BPS * 1e6, False,
                    "dynslice"))
    return out


def _applies(family, fam) -> bool:
    """Whether a variant of ``family`` (None: every family; a name or a
    tuple of names) runs the cases of family ``fam``."""
    return family is None or fam in (
        family if isinstance(family, tuple) else (family,))


def kernel_facts(lib, match: str) -> dict:
    """{kernel: (registers, static shared bytes, ATOMS.CAST, RED, ATOM)} for
    the kernels of ``lib`` whose mangled names hold ``match``, each named
    as cu++filt demangles it, its parameters left out."""
    facts, current = {}, None
    for line in lib.ptxas_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            current = m.group(1) if match in m.group(1) else None
        elif current and "registers" in line:
            smem = re.search(r"(\d+) bytes smem", line)
            facts[current] = [int(re.search(r"(\d+) registers",
                                            line).group(1)),
                              int(smem.group(1)) if smem else 0, 0, 0, 0]
            current = None
    for line in lib.sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            current = m.group(1) if m.group(1) in facts else None
            continue
        op = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                       line)
        if current and op:
            name = op.group(1)
            if name.startswith("ATOMS.CAST"):
                facts[current][2] += 1
            elif name.startswith("RED"):
                facts[current][3] += 1
            elif name.startswith("ATOMG") or name.startswith("ATOM."):
                facts[current][4] += 1
    names = list(facts)
    filt = os.path.join(os.path.dirname(_build.nvcc()), "cu++filt")
    if names and os.path.exists(filt):
        shown = subprocess.run([filt, *names], capture_output=True,
                               text=True).stdout.splitlines()
        if len(shown) == len(names):
            names = [re.sub(r"^void |\(int\)|<unnamed>::|\(anonymous "
                            r"namespace\)::", "", n).split("(")[0]
                     for n in shown]
    return dict(zip(names, map(tuple, facts.values())))


def _busy_us(fn, match="") -> float:
    sec = busy_seconds(fn, match, log=lambda m: print(m, flush=True))
    return float("nan") if sec is None else sec * 1e6


def _build_one(item):
    name, (_, subs) = item
    try:
        return name, build_variant(name, subs, sources=("probes.cu",),
                                   kernels=KERNELS)
    except _build.KernelError as e:
        return name, e


def main(argv=None) -> int:
    """Runs "as built" and the variants named in ``argv`` (all without)."""
    names = (sys.argv[1:] if argv is None else argv) or list(VARIANTS)
    unknown = set(names) - set(VARIANTS)
    if unknown:
        raise SystemExit(f"no such variants: {sorted(unknown)}")
    if not torch.cuda.is_available():
        raise SystemExit("probes_ab needs a CUDA device")
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    wanted = [(n, v) for n, v in VARIANTS.items()
              if n == "as built" or n in names]
    with ThreadPoolExecutor(8) as pool:
        built = list(pool.map(_build_one, wanted))
    builds, shown = {}, {}
    for name, res in built:
        if isinstance(res, Exception):
            if name == "as built":
                raise res
            print(f"build {name!r} failed, left out:\n{res}", flush=True)
            continue
        lib, _, _ = res
        builds[name] = lib
        family = VARIANTS[name][0]
        for match in dict.fromkeys(m for fam, m in FAMILY_KERNELS.items()
                                   if _applies(family, fam)):
            for kern, facts in kernel_facts(lib, match).items():
                if name != "as built" and shown.get(kern) == facts:
                    continue   # as built printed it
                shown.setdefault(kern, facts)
                regs, smem, cas, red, atom = facts
                print(f"build {name!r} {kern}: {regs} registers, {smem} B "
                      f"static shared, ATOMS.CAST {cas}, RED {red}, ATOM "
                      f"{atom}", flush=True)
    todo = cases(dev)
    wants = {label: ref() for label, _, _, ref, *_ in todo}
    times = {}
    saved = _build._lib
    try:
        for order in (list(builds), list(builds)[::-1]):
            for name in order:
                _build._lib = builds[name]
                family = VARIANTS[name][0]
                for label, fam, call, _, _, _, exact, match in todo:
                    if not _applies(family, fam):
                        continue
                    got, want = call(), wants[label]
                    torch.cuda.synchronize()
                    err = float((got.float() - want.float()).abs().max())
                    if err > (0 if exact else TOL * float(want.abs().max())):
                        raise SystemExit(f"{name} {label}: off the plain "
                                         f"version by {err}")
                    times.setdefault((name, label), []).append(
                        _busy_us(call, match))
    finally:
        _build._lib = saved
    print("busy µs, pass 1 / pass 2, by case", flush=True)
    for label, fam, _, _, lib, bound, _, _ in todo:
        library = f"{_busy_us(lib):.2f}" if lib is not None else "none"
        print(f"{label}: bound {bound:.2f}, PyTorch call {library}")
        for name in builds:
            if (name, label) in times:
                print(f"  {name}: " + " / ".join(
                    f"{t:.2f}" for t in times[(name, label)]), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
