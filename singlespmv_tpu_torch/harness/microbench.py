"""Primitive microbenchmarks on the card: ``singlespmv_tpu/harness/
microbench.py``'s probe suite for PyTorch on one GPU.

Each probe times one data motion (stream, device-memory read, lane and
sublane gathers, palette gathers, one-hot routing, dynamic-slice accumulate,
segmented scan, transpose) with the reference's methodology: a chained loop
that feeds each output back as the next input, timed as the best of 3
marginal differences t(n) − t(n/2).  The ten probes that the reference wrote
as Pallas kernels run the port's CUDA kernels (``ops/probes.py``); the four
it left to XLA (``probe_stream``, ``probe_hbm_read``,
``probe_xla_transpose``, ``probe_onehot_mxu``) are plain torch ops.  Inputs
are the reference's, from the same numpy generators; ``<kernel>_case``
builds the kernel call that a probe times, (wrapper, args, kwargs), and
``KERNEL_CASES`` names every such call the probes make, for the checks of
the kernels against their plain versions.

On the card a chain runs on the device's clock, as the reference's
``jit(fori_loop)`` runs it: ``chained`` captures its calls in CUDA graphs
and replays them (the driver's ``make_chained_runner`` does the same for
spmv calls), so a probe's time per iteration is its body's device time,
with no launch path in it; ``chip_smoke.py`` reads each kernel's own busy
time beside it.  On the CPU a chain is a host loop of eager calls
(``loop_chain``).

    python -m singlespmv_tpu_torch.harness.microbench [--out micro.tsv]
        [--target-s S] [probe ...]

``PROBES`` holds the reference's 35 names and arguments.  The probes need a
GPU and raise without one, unless ``device="cpu"`` asks for the kernels'
plain versions.  A probe that fails raises: there is no fallback.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..ops import probes
from .driver import (CHAIN, WARMUP_CALLS, CaptureError, best_marginal_seconds,
                     device_of)

LANES = 128
TARGET_S = 0.25      # the reference's loop length before the trials
F32 = torch.float32


def _tiny(device):
    """The tiny scalar a body may fold into its carry."""
    return torch.tensor(np.finfo(np.float32).tiny, dtype=torch.float32,
                        device=device)


def loop_chain(body):
    """run_n(carry, n, *consts): ``body`` n times as a host loop of eager
    calls, each output the next carry: the chain on the CPU."""
    def run_n(carry, n, *consts):
        tiny = _tiny(carry.device)
        for _ in range(n):
            carry = body(carry, tiny, *consts)
        return carry

    return run_n


def _capture(body, buf, tiny, consts, k):
    """A CUDA graph of ``k`` chained calls of ``body`` from the carry in
    ``buf``, the last output copied back into ``buf``."""
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            c = buf
            for _ in range(k):
                c = body(c, tiny, *consts)
            buf.copy_(c)
    except Exception as e:
        raise CaptureError(
            f"{getattr(body, '__name__', 'body')}: the CUDA graph capture "
            f"of {k} chained calls failed: {type(e).__name__}: {e}") from e
    return graph


def chained(body):
    """run_n(carry, n, *consts): ``body`` n times, each output the next
    carry, with a tiny scalar the body may fold in: the port's counterpart
    of the reference's ``jit(fori_loop)``
    (``singlespmv_tpu/harness/microbench.py:25-40``).

    On a CUDA device, as ``driver.make_chained_runner`` runs spmv calls:
    at the first call for a carry's shape and type and a set of consts,
    ``body`` runs ``WARMUP_CALLS`` times eagerly on a side stream, then one
    ``torch.cuda.CUDAGraph`` captures ``CHAIN`` (64) calls, each output the
    next call's carry, and another one call; both start from one carry
    buffer and copy their last output back into it.  ``run_n`` copies
    ``carry`` into the buffer, replays the first graph n // 64 times and
    the second n % 64 times, and returns a copy of the buffer: the carry of
    n chained calls.  An iteration's time is the body's device time and
    one copy of the carry every 64 calls.  A capture that fails raises
    ``CaptureError``: nothing falls back to eager calls.  The wrappers'
    launch counters rise by the warm-up and the captured calls, never by a
    replay.  On the CPU, ``loop_chain``."""
    graphs = {}

    def captured(carry, consts):
        key = (tuple(carry.shape), carry.dtype, carry.device) + tuple(
            (c.data_ptr(), tuple(c.shape), c.dtype) for c in consts)
        if key not in graphs:
            dev = carry.device
            buf, tiny = carry.clone(), _tiny(dev)
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                c = buf.clone()
                for _ in range(WARMUP_CALLS):
                    c = body(c, tiny, *consts)
            torch.cuda.current_stream(dev).wait_stream(side)
            torch.cuda.synchronize(dev)
            # the graphs read buf and tiny where they lay at the capture:
            # both are kept with them (the caller keeps the consts)
            graphs[key] = (buf, tiny,
                           _capture(body, buf, tiny, consts, CHAIN),
                           _capture(body, buf, tiny, consts, 1))
        return graphs[key]

    def run_n(carry, n, *consts):
        if carry.device.type != "cuda":
            return loop_chain(body)(carry, n, *consts)
        buf, _, top, one = captured(carry, consts)
        buf.copy_(carry)
        q, r = divmod(int(n), CHAIN)
        for graph, times in ((top, q), (one, r)):
            for _ in range(times):
                graph.replay()
        return buf.clone()

    return run_n


def _on(dev, a, dtype):
    """A numpy array as a tensor of ``dtype`` on ``dev``."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev).to(dtype)


def _time_kernel(case, at, target_s, fold=None):
    """Times the kernel call ``case`` = (wrapper, args, kwargs) chained
    through its argument ``at``: each output (or ``fold(c, tiny, out)``)
    is the next call's args[at]."""
    fn, args, kw = case
    consts = args[:at] + args[at + 1:]

    def body(c, tiny, *consts):
        out = fn(*consts[:at], c, *consts[at:], **kw)
        return out if fold is None else fold(c, tiny, out)

    return best_marginal_seconds(chained(body), args[at], consts,
                                 target_s=target_s)


# ------------------------------------------------- the kernels' inputs ------
# Each builds the reference probe's inputs (its arguments, dtype a torch
# dtype) on ``device`` and returns the kernel call it times.

def lane_gather_case(w=128, G=8192, dtype=F32, table_rows=1, device="cuda"):
    dev = device_of(device)
    rng = np.random.default_rng(1)
    h = G * LANES // w
    idt = torch.int16 if dtype == torch.bfloat16 else torch.int32
    col = _on(dev, rng.integers(0, LANES, (h, w)), idt)
    val = _on(dev, rng.standard_normal((h, w)), dtype)
    x = _on(dev, rng.standard_normal((max(table_rows, 8 * w // LANES),
                                      LANES)), dtype)
    return probes.lane_gather, (col, val, x), {"table_rows": table_rows}


def gather1024_case(G=8192, dtype=F32, levels=8, w=LANES, device="cuda"):
    dev = device_of(device)
    rng = np.random.default_rng(2)
    h = G * LANES // w
    col = _on(dev, rng.integers(0, levels * LANES, (h, w)), torch.int32)
    val = _on(dev, rng.standard_normal((h, w)), dtype)
    x = _on(dev, rng.standard_normal((8, LANES)), dtype)
    return probes.gather1024, (col, val, x), {"levels": levels}


def palette_gather_case(w=1024, G=8192, CBX=8192, dtype=F32, per=1,
                        device="cuda"):
    dev = device_of(device)
    rng = np.random.default_rng(11)
    h = G * LANES // w
    nb = 8 * w // LANES // per
    col = _on(dev, rng.integers(0, LANES, (h, w)), torch.int32)
    val = _on(dev, rng.standard_normal((h, w)), dtype)
    x = _on(dev, rng.standard_normal((CBX, LANES)), dtype)
    blk = _on(dev, rng.integers(0, CBX, (h // 8 * nb,)), torch.int32)
    return probes.palette_gather, (blk, col, val, x), {"per": per}


def pal2step_case(w=1024, G=8192, CBX=8192, dtype=F32, K=1, device="cuda"):
    dev = device_of(device)
    rng = np.random.default_rng(13)
    h = G * LANES // w
    g = 8 * w // LANES
    col = _on(dev, rng.integers(0, LANES, (h, w)), torch.int32)
    val = _on(dev, rng.standard_normal((h, w)), dtype)
    x = _on(dev, rng.standard_normal((CBX, LANES)), dtype)
    blk = _on(dev, rng.integers(0, CBX - 8, (h // 8 * g,)), torch.int32)
    sub = _on(dev, rng.integers(0, 8, (K, h, w)), torch.int32)
    sel = _on(dev, rng.integers(0, K, (h, w)), torch.int32)
    return probes.pal2step, (blk, col, val, sub, sel, x), {}


def onehot_bins_case(G=8192, dtype=F32, device="cuda"):
    dev = device_of(device)
    rng = np.random.default_rng(12)
    binv = _on(dev, rng.integers(0, LANES, (G, LANES)), torch.int32)
    val = _on(dev, rng.standard_normal((G, LANES)), dtype)
    return probes.onehot_bins, (binv, val), {}


def sublane_gather_case(G=8192, rows=1024, dtype=F32, device="cuda"):
    dev = device_of(device)
    rng = np.random.default_rng(3)
    idx = _on(dev, rng.integers(0, rows, (G, LANES)), torch.int32)
    val = _on(dev, rng.standard_normal((G, LANES)), dtype)
    x = _on(dev, rng.standard_normal((rows, LANES)), dtype)
    return probes.sublane_gather, (idx, val, x), {}


def dynslice_accum_case(T=4096, dtype=F32, device="cuda"):
    dev = device_of(device)
    rng = np.random.default_rng(6)
    offs = _on(dev, np.sort(rng.integers(0, 1016, T)), torch.int32)
    v = _on(dev, rng.standard_normal((T * 8, LANES)), dtype)
    return probes.dynslice_accum, (offs, v), {}


def dynslice_odd_offs(T=4096, seed=9) -> dict:
    """label → offs (int32 numpy) of inputs the accumulate's probe never
    draws, for the checks of its kernel: the probe's T sorted offs
    permuted, every off equal, offs over [−64, 1,100) (a negative off
    counts from y's end; both clamps act), and T 1 and 3.  y has the
    probe's 1,024 rows."""
    rng = np.random.default_rng(seed)
    probe = np.sort(np.random.default_rng(6).integers(0, 1016, T))
    out = {f"T {T} permuted": rng.permutation(probe),
           f"T {T} every off equal": np.full(T, 500),
           f"T {T} over [-64, 1100)": rng.integers(-64, 1100, T),
           "T 1": rng.integers(-64, 1100, 1),
           "T 3": rng.integers(-64, 1100, 3)}
    return {k: v.astype(np.int32) for k, v in out.items()}


def seg_scan_case(G=8192, dtype=F32, device="cuda"):
    dev = device_of(device)
    rng = np.random.default_rng(7)
    heads = _on(dev, rng.integers(0, 2, (G, LANES)), torch.int32)
    val = _on(dev, rng.standard_normal((G, LANES)), dtype)
    return probes.seg_scan, (heads, val), {}


def seg_scan_roll_case(G=8192, dtype=F32, steps=7, device="cuda"):
    dev = device_of(device)
    rng = np.random.default_rng(7)
    heads = _on(dev, rng.integers(0, 2, (G, LANES)), torch.int8)
    val = _on(dev, rng.standard_normal((G, LANES)), dtype)
    return probes.seg_scan_roll, (heads, val), {"steps": steps}


def tile_transpose_case(CB=256, NU=256, S=128, dtype=F32, device="cuda"):
    dev = device_of(device)
    a = _on(dev, np.random.default_rng(8).standard_normal((CB, NU * S)),
            dtype)
    return probes.tile_transpose, (a,), {"nu": NU, "s": S}


# --------------------------------------------------------------- probes ------
# Each takes the reference's arguments (dtype a torch dtype) plus
# ``device`` and ``target_s``, and returns (elements, seconds).

def stream_body(c, tiny):
    """``probe_stream``'s body: c · 1.0001 + 0.5."""
    return c * 1.0001 + 0.5


def probe_stream(G=8192, dtype=F32, *, device="cuda", target_s=TARGET_S):
    """Elementwise rate over a (G, 128) carry (plain torch)."""
    a = _on(device_of(device),
            np.random.default_rng(0).standard_normal((G, LANES)), dtype)
    return G * LANES, best_marginal_seconds(chained(stream_body), a,
                                            target_s=target_s)


def hbm_read_body(c, tiny, a):
    """``probe_hbm_read``'s body: reduce max(a, c[0, 0]) into the carry."""
    s = torch.sum(torch.maximum(a, c[0, 0]))
    return c + s * tiny


def probe_hbm_read(G=1048576, dtype=F32, *, device="cuda",
                   target_s=TARGET_S):
    """Device-memory read rate: reduce a (G, 128) constant (512 MB at the
    default) per iteration (plain torch).  The rate counts G·128 elements,
    one pass over the constant, as the reference's does; eager, the body
    makes three (``maximum`` reads the constant and writes a temporary of
    its size, which ``sum`` reads back), so the bytes moved are about 3 ×
    4·G·128 an iteration."""
    dev = device_of(device)
    a = _on(dev, np.random.default_rng(0).standard_normal((G, LANES)),
            dtype)
    c0 = torch.zeros(8, LANES, dtype=dtype, device=dev)
    return G * LANES, best_marginal_seconds(chained(hbm_read_body), c0,
                                            (a,), target_s=target_s)


def probe_lane_gather(w=128, G=8192, dtype=F32, table_rows=1, *,
                      device="cuda", target_s=TARGET_S):
    """Lane gather per (8, w) tile from a broadcast x row (table_rows=1) or
    row for row from a (g, 128) table (table_rows=0)."""
    case = lane_gather_case(w, G, dtype, table_rows, device)
    return G * LANES, _time_kernel(case, 1, target_s)


def probe_gather1024(G=8192, dtype=F32, levels=8, w=LANES, *, device="cuda",
                     target_s=TARGET_S):
    """Two-level gather from an (8, 128) x block, ``levels`` ways."""
    case = gather1024_case(G, dtype, levels, w, device)
    return G * LANES, _time_kernel(case, 1, target_s)


def probe_palette_gather(w=1024, G=8192, CBX=8192, dtype=F32, per=1, *,
                         device="cuda", target_s=TARGET_S):
    """Per-lane-row palettes from a (CBX, 128) x."""
    case = palette_gather_case(w, G, CBX, dtype, per, device)
    return G * LANES, _time_kernel(case, 2, target_s)


def probe_pal2step(w=1024, G=8192, CBX=8192, dtype=F32, K=1, *,
                   device="cuda", target_s=TARGET_S):
    """pal's two-step gather (8-row window, K sublane picks, lane gather).
    Not in ``PROBES``, as in the reference."""
    case = pal2step_case(w, G, CBX, dtype, K, device)
    return G * LANES, _time_kernel(case, 2, target_s)


def probe_onehot_inkernel(G=8192, dtype=F32, *, device="cuda",
                          target_s=TARGET_S):
    """Per-(8, 128)-tile bin sums, the in-kernel one-hot route."""
    return G * LANES, _time_kernel(onehot_bins_case(G, dtype, device), 1,
                                   target_s)


def probe_sublane_gather(G=8192, rows=1024, dtype=F32, *, device="cuda",
                         target_s=TARGET_S):
    """Gather along rows from a (rows, 128) table."""
    case = sublane_gather_case(G, rows, dtype, device)
    return G * LANES, _time_kernel(case, 1, target_s)


def xla_transpose_body(CB, NU, S):
    """``probe_xla_transpose``'s body: the (CB, NU, S) → (NU, CB, S)
    relayout of a flat carry."""
    def body(c, tiny):
        return c.reshape(CB, NU, S).transpose(0, 1).reshape(-1)

    return body


def probe_xla_transpose(CB=256, NU=256, S=32, dtype=F32, *, device="cuda",
                        target_s=TARGET_S):
    """The bkt cb-major → unit-major relayout as a plain torch transpose."""
    a = _on(device_of(device),
            np.random.default_rng(4).standard_normal((CB * NU * S,)), dtype)
    return CB * NU * S, best_marginal_seconds(
        chained(xla_transpose_body(CB, NU, S)), a, target_s=target_s)


def onehot_mxu_body(c, tiny, oh):
    """``probe_onehot_mxu``'s body: (8, 128) @ (128, 128) one-hot routing
    products per tile, accumulated in float32."""
    G = c.shape[0]
    r = torch.bmm(c.reshape(G // 8, 8, LANES).float(), oh.float())
    return r.to(c.dtype).reshape(G, LANES)


def probe_onehot_mxu(G=2048, dtype=F32, *, device="cuda", target_s=TARGET_S):
    """Products routed to 128 bins through a precomputed one-hot, as
    batched matmuls (plain torch)."""
    dev = device_of(device)
    rng = np.random.default_rng(5)
    a = _on(dev, rng.standard_normal((G, LANES)), dtype)
    onehot = np.zeros((G // 8, LANES, LANES), dtype=np.float32)
    cols = rng.integers(0, LANES, (G // 8, LANES))
    for t in range(G // 8):
        onehot[t, np.arange(LANES), cols[t]] = 1.0
    oh = _on(dev, onehot, dtype)
    return G * LANES, best_marginal_seconds(chained(onehot_mxu_body), a,
                                            (oh,), target_s=target_s)


def probe_dynslice_accum(T=4096, dtype=F32, *, device="cuda",
                         target_s=TARGET_S):
    """(8, 128) windows of v added into a (1024, 128) y at sorted row
    offsets; the carry survives with y's first entry folded in."""
    case = dynslice_accum_case(T, dtype, device)
    return T * 8 * LANES, _time_kernel(
        case, 1, target_s, lambda c, tiny, y: c + y[0, 0] * tiny)


def probe_seg_scan(G=8192, dtype=F32, *, device="cuda", target_s=TARGET_S):
    """Segmented Hillis–Steele lane scan, 7 steps."""
    return G * LANES, _time_kernel(seg_scan_case(G, dtype, device), 1,
                                   target_s)


def probe_seg_scan_roll(G=8192, dtype=F32, steps=7, *, device="cuda",
                        target_s=TARGET_S):
    """The same scan over int8 heads, ``steps`` steps."""
    case = seg_scan_roll_case(G, dtype, steps, device)
    return G * LANES, _time_kernel(case, 1, target_s)


def probe_pallas_tile_transpose(CB=256, NU=256, S=128, dtype=F32, *,
                                device="cuda", target_s=TARGET_S):
    """The bkt relayout as a kernel, (CB, NU·S) → (NU, CB·S)."""
    case = tile_transpose_case(CB, NU, S, dtype, device)
    return CB * NU * S, _time_kernel(
        case, 0, target_s, lambda c, tiny, out: out.reshape(c.shape))


# name → (probe, its arguments): the reference's 35 probes
PROBES = {
    "vpu_stream_f32": (probe_stream, {}),
    "hbm_read_f32": (probe_hbm_read, {}),
    "lane_gather_w128": (probe_lane_gather, {"w": 128}),
    "lane_gather_w512": (probe_lane_gather, {"w": 512}),
    "lane_gather_w1024": (probe_lane_gather, {"w": 1024}),
    "lane_gather_table8_w128": (probe_lane_gather,
                                {"w": 128, "table_rows": 0}),
    "gather1024_8way": (probe_gather1024, {"levels": 8}),
    "gather512_4way": (probe_gather1024, {"levels": 4}),
    "gather256_2way": (probe_gather1024, {"levels": 2}),
    "sublane_gather_1024": (probe_sublane_gather, {"rows": 1024}),
    "sublane_gather_64": (probe_sublane_gather, {"rows": 64}),
    "sublane_gather_8": (probe_sublane_gather, {"rows": 8}),
    "xla_transpose_s32": (probe_xla_transpose, {"S": 32}),
    "xla_transpose_s8": (probe_xla_transpose,
                         {"CB": 1024, "NU": 256, "S": 8}),
    "xla_transpose_s128": (probe_xla_transpose,
                           {"CB": 64, "NU": 256, "S": 128}),
    "pallas_tile_transpose": (probe_pallas_tile_transpose, {}),
    "seg_scan_roll_7": (probe_seg_scan_roll, {"steps": 7}),
    "seg_scan_roll_4": (probe_seg_scan_roll, {"steps": 4}),
    "seg_scan_roll_2": (probe_seg_scan_roll, {"steps": 2}),
    "seg_scan_big_block": (probe_seg_scan, {"G": 8192}),
    "onehot_mxu_route": (probe_onehot_mxu, {}),
    "onehot_inkernel_route": (probe_onehot_inkernel, {}),
    "lane_gather_w1024_tab0": (probe_lane_gather,
                               {"w": 1024, "table_rows": 0}),
    "palette_w1024": (probe_palette_gather, {"w": 1024}),
    "palette_w512": (probe_palette_gather, {"w": 512}),
    "palette_w1024_per8": (probe_palette_gather, {"w": 1024, "per": 8}),
    "palette_w1024_cbx32k": (probe_palette_gather,
                             {"w": 1024, "CBX": 32768}),
    "gather8way_w1024": (probe_gather1024, {"levels": 8, "w": 1024}),
    "gather4way_w1024": (probe_gather1024, {"levels": 4, "w": 1024}),
    "gather2way_w1024": (probe_gather1024, {"levels": 2, "w": 1024}),
    "gather16way_w1024": (probe_gather1024, {"levels": 16, "w": 1024}),
    "gather8way_w4096": (probe_gather1024, {"levels": 8, "w": 4096}),
    "dynslice_accum": (probe_dynslice_accum, {}),
    "seg_scan_128": (probe_seg_scan, {}),
    "lane_gather_w512_bf16": (probe_lane_gather,
                              {"w": 512, "dtype": torch.bfloat16}),
}

# each probe that times a kernel → the builder of that kernel's call
CASE_OF = {
    probe_lane_gather: lane_gather_case,
    probe_gather1024: gather1024_case,
    probe_palette_gather: palette_gather_case,
    probe_pal2step: pal2step_case,
    probe_onehot_inkernel: onehot_bins_case,
    probe_sublane_gather: sublane_gather_case,
    probe_dynslice_accum: dynslice_accum_case,
    probe_seg_scan: seg_scan_case,
    probe_seg_scan_roll: seg_scan_roll_case,
    probe_pallas_tile_transpose: tile_transpose_case,
}
# name → (builder, its arguments): the kernel call of every probe of
# ``PROBES`` that times a kernel, then ``probe_pal2step`` at its defaults,
# which ``PROBES`` leaves out
KERNEL_CASES = {name: (CASE_OF[fn], kw) for name, (fn, kw) in PROBES.items()
                if fn in CASE_OF}
KERNEL_CASES["pal2step_w1024_k1"] = (pal2step_case, {})


def run(names=None, out=None, *, target_s=TARGET_S, device="cuda",
        log=lambda m: print(m, file=sys.stderr)):
    """Runs the probes of ``PROBES`` named in ``names`` (all by default);
    returns [(name, elements, seconds, G elem/s)] and writes them as TSV to
    ``out`` with the reference's columns."""
    dev = device_of(device)
    rows = []
    for name, (fn, kw) in PROBES.items():
        if names and name not in names:
            continue
        elems, sec = fn(**kw, device=dev, target_s=target_s)
        rate = elems / sec / 1e9
        rows.append((name, elems, sec, rate))
        log(f"{name:28s} {rate:10.2f} G elem/s   ({sec * 1e6:9.1f} us)")
    if out:
        with open(out, "w") as f:
            f.write("probe\telements\tseconds\tGelem_per_s\n")
            for r in rows:
                f.write(f"{r[0]}\t{r[1]}\t{r[2]:.3e}\t{r[3]:.3f}\n")
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--target-s", type=float, default=TARGET_S)
    ap.add_argument("probes", nargs="*", default=None)
    a = ap.parse_args(argv)
    return run(a.probes or None, a.out, target_s=a.target_s)


if __name__ == "__main__":
    main()
