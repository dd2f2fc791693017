"""A/B of the two probe kernels redesigned for the card: ``tile_transpose``
and ``onehot_bins`` (``csrc/probes.cu``).

    python -m singlespmv_tpu_torch.harness.probes_ab [variant ...]
                                          # needs a GPU and nvcc

Builds ``csrc/probes.cu`` as it is and the variants of ``VARIANTS``, each a
copy of ``csrc/`` with text substitutions, with the flags of
``ops/_build.py`` into temporary directories (``panel_ab.build_variant``).
The first port's two kernels (one thread an out element with 64-bit
divisions; a warp a tile with shared atomics) live here, not in ``csrc/``,
and come back as variants.  Then it times each kernel family on its cases,
loading each build in turn in place of the port's library, over two passes
(the variants in order, then reversed): the transpose at the probe's
256 × 256 × 128 and at the three ``xla_transpose`` shapes of the
reference's suite, the bin sums at the probe's G 8,192 with its uniform
bins and with bins in [0, 16) and [0, 4).  A time is the device busy µs of
one wrapper call, every device event of it (kernels and memsets), from a
complete torch.profiler trace (``driver.busy_seconds``).  Beside them: the
PyTorch call that computes the same function (``.transpose(0, 1)
.contiguous()``, ``scatter_add_`` into a zeroed (tiles, 128) grid) and the
bound (each input read once, the output written once, at 3.35 TB/s).
Every variant computes the same function and is held to the plain version
(the transpose exactly, the bin sums within 1e-5·max|out|).  It prints the
card's name and power limit, each build's registers per kernel (ptxas) and
the count of shared-memory compare-and-swap instructions (``ATOMS.CAST``,
cuobjdump) in each kernel.
"""
from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch

from ..ops import _build, probes
from .driver import busy_seconds
from .microbench import onehot_bins_case
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
}
KERNELS = ("tile_transpose_kernelIj", "tile_transpose_kernelIm",
           "tile_transpose_first_kernel",
           "tile_transpose_flat_kernel", "tile_transpose_bulk_kernel",
           "onehot_bins_kernel", "onehot_bins_first_kernel",
           "onehot_red_kernel", "onehot_rows_kernel")
TRANSPOSES = ((256, 256, 128), (64, 256, 128), (256, 256, 32),
              (1024, 256, 8))   # the probe's, xla_transpose s128, s32, s8


def cases(dev) -> list:
    """(label, family, call, plain call, library call, bound µs, exact) of
    every timed case."""
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
                    2 * a.numel() * 4 / HBM_BPS * 1e6, True))
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
                     3 * val.numel() * 4 / HBM_BPS * 1e6, False))
    return out


def _busy_us(fn) -> float:
    sec = busy_seconds(fn, log=lambda m: print(m, flush=True))
    return float("nan") if sec is None else sec * 1e6


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
    builds = {}
    for name, (_, subs) in VARIANTS.items():
        if name != "as built" and name not in names:
            continue
        try:
            lib, regs, cas = build_variant(name, subs, sources=("probes.cu",),
                                           kernels=KERNELS)
        except _build.KernelError as e:
            if name == "as built":
                raise
            print(f"build {name!r} failed, left out:\n{e}", flush=True)
            continue
        builds[name] = lib
        print(f"build {name!r}: registers {regs}, ATOMS.CAST "
              f"{ {k: v for k, v in cas.items() if v or k in regs} }",
              flush=True)
    todo = cases(dev)
    wants = {label: ref() for label, _, _, ref, *_ in todo}
    times = {}
    saved = _build._lib
    try:
        for order in (list(builds), list(builds)[::-1]):
            for name in order:
                _build._lib = builds[name]
                family = VARIANTS[name][0]
                for label, fam, call, _, _, _, exact in todo:
                    if family not in (None, fam):
                        continue
                    got, want = call(), wants[label]
                    torch.cuda.synchronize()
                    err = float((got - want).abs().max())
                    if err > (0 if exact else TOL * float(want.abs().max())):
                        raise SystemExit(f"{name} {label}: off the plain "
                                         f"version by {err}")
                    times.setdefault((name, label), []).append(_busy_us(call))
    finally:
        _build._lib = saved
    for label, fam, _, _, lib, bound, _ in todo:
        times[("PyTorch call", label)] = [_busy_us(lib)]
        times[("bound", label)] = [bound]
    labels = [label for label, *_ in todo]
    print("busy µs, pass 1 / pass 2".ljust(34)
          + "".join(f"{lb:>26}" for lb in labels))
    for name in list(builds) + ["PyTorch call", "bound"]:
        print(name.ljust(34) + "".join(
            f"{' / '.join(f'{t:.2f}' for t in times[(name, lb)]):>26}"
            if (name, lb) in times else f"{'':>26}" for lb in labels),
            flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
