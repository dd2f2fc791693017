"""XCH — the two-pass exchange engine of ``singlespmv_tpu/formats/xch.py``
(v4, block-routed), for hyper-sparse and scattered giants.

Layout (unchanged from the reference): pass 1 streams nonzeros sorted by
(chunk, col) — a chunk is ``k_slots`` consecutive nonzeros of the row-major
stream — and writes one product per slot into an (n_chunks, p1, 128) grid.
Pass 2 re-gathers the products in (chunk, band, src) order, a band being
``kblk`` 128-row blocks; within each 128-slot stream row the slots are
row-contiguous, so runs reduce to their totals and route, through ``kblk``
planes of end-lanes and the per-row block offset ``sig``, to out groups of
``gb`` 128-row blocks.  High-fill diagonals are peeled into static-slice
bands (``dia_vals``), and rows of degree ≥ ``LONG_DEG`` may split into a
nested ``Xch4State`` (``long``) scatter-added at ``long_rows``.

Host half (``estimate``, ``convert``): the reference's live v4 planner and
layout builder in numpy, carried over unchanged in behaviour, so that one COO
yields the same arrays in both packages.  It prices plans with the port's
own copy of the reference's constants (``core/chipconst.py``) and the
reference's v5e fits.
``X_TABLE_CAP``, ``M2_CAP``, ``CHUNK_ROWS`` and ``PASS1_CALL_ROWS`` size TPU
memories; they stay until the port sheds them (ROADMAP A.7b).

The v3 σ-plane engine (``XchState``) is reached as in the reference,
through an explicit plan: ``convert(coo, cfg, plan=estimate_v3(coo, cfg) |
{"route_v": 3})`` runs the reference's ``_convert_v3`` in numpy (the same
arrays for one COO and plan; its own v5e fits ``ROUTE_*_S``, ``EST_CAL``,
``G_GRP``).  Pass 1 is v4's; pass 2 re-gathers the products in (bucket,
src) order, a bucket being ``planes`` · 128 rows, and routes the run totals
through ``span`` · ``planes`` σ planes of end lanes (``idx2``) to the out
rows of compact buckets.  Its spmv is the reference's two phases, which
``phases`` also returns: ``_mul_phase`` (the x table, one ``xch_mul`` a
pass-1 call into one product grid) and ``_route_phase`` (one ``xch_route``
a pass-2 call, then ``place_buckets``: the calls' out rows, zero rows for
trailing buckets that begin no step, the span-2 overlap-add and the
buckets placed at ``bucket_ids``, in torch on the device, no host read).
``spmm`` loops the spmv over the columns, as the reference's ``vmap``.  It
runs float32 and bfloat16 (the grid bfloat16, float32 sums into a float32
out, y rounded once); at float64 its spmv and spmm raise ``TypeError`` as
the reference's do on its chip, while ``convert`` and ``to_coo`` take every
type.  CPU tests: ``tests/test_torch_xch_v3.py``; on the card, phase "xch
v3" of ``chip_smoke.py`` and ``tests/test_torch_cuda_xch.py``.

``convert`` and ``state_from_reference`` also derive, with ``route_rows``,
the streams the card's spmv needs from the reference's arrays: from the
routing arrays (``gids2``, ``off2``, ``sig2``, ``idx2``, ``vis_gids``)
``base2``, the y position of each pass-2 step's out row 0, ``dest2``, each
run's y position relative to it at the run's end slot, and ``merge2``, the
span over which the route sums a block's rows first where their run ends
pile onto few y rows; and from the exchange (``cs2``, ``win2``, ``sub2``,
``lane2`` of pass 2, ``win1``, ``sub1``, ``lane1``, ``val1`` of pass 1)
``val2`` and ``col2``, the value and the x position of the pass-1 slot whose
product pass 2 reads at each of its slots: the products' stream in pass 2's
order.  The reference's arrays stay the source of truth: the SpMM panels,
``phases``, ``to_coo`` and the calibration read them.

Device half (``spmv``): one ``xch_fused_rows`` per pass-2 call, each
gathering x at ``col2``, multiplying by ``val2`` in registers and adding its
run totals straight into one zeroed y (``ops/xch.py``): no x table and no
product grid.  Then it adds the nested long-row state's y at ``long_rows``
and the peeled bands as shifted slices of x.  ``phases`` splits the
reference's two passes into Mul (the x table and one ``xch_mul`` per pass-1
call, each writing its rows of one product grid) and Sum (one
``xch_route4_rows`` per pass-2 call on that grid) for the driver's
profiling, where the state has no long-row state.  ``spmm`` runs
``xch_mul_panel`` and ``xch_route4_panel`` on the interleaved panel (each
row's B values contiguous, the out rows in Y's own layout) and places the
visited out groups into Y, under the reference's gates.

Values are float32, float64 or bfloat16.  At bfloat16 ``val1``, the x
table, the product grid and ``dia_vals`` are ``torch.bfloat16``; pass 2
and the peeled bands sum in float32 into a float32 y, which ``spmv`` rounds
once (the grid is bfloat16, as the reference's: half the traffic between
the passes, each product rounded once).  The layout at float64 is the float32 layout, as in the
reference; the state holds ``val1`` and ``dia_vals`` as float64 where the
reference splits them into (hi, lo) float32 planes, and both kernels run at
native fp64.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..core import chipconst as _cc
from ..core import hostmem as hm
from ..core.dtypes import (acc, acc_dtype, from_numpy, to_host, value_size,
                           value_tensor)
from ..core.types import COOMatrix, cdiv

from ..ops.slab import PANEL_TYPES
from ..ops.xch import MERGE_SMEM, xch_fused_rows, xch_mul, xch_mul_panel, \
    xch_route, xch_route4_panel, xch_route4_rows
from .base import TensorState, check_dtype, column_loop
from .slab import _t, _walk

STATE_REV = 2   # bump with a change of the layout (formats/cache.py)
LANES = 128
X_TABLE_CAP = 96 << 20      # VMEM-resident x table bound (v5e, as slab)
P1_CAP_ROWS = 12288         # chunk product block ≤ 6 MB VMEM (12288·128·4B)
M_MAX = 120                 # int8 sub index headroom
M2_CAP = 40                 # route-window cap: the select's VMEM working set
CHUNK_ROWS = 160_000        # pass-2 stream rows per kernel call (TPU SMEM)
PASS1_CALL_ROWS = 160_000   # pass-1 stream rows per kernel call, cut at a
#                             multiple of t1 (the reference's literal)

# the reference's measured-rate cost model (fitted on a TPU v5e)
MUL_FIXED_S = 0.15e-6
BASE_SLOT_S = 0.013e-9
SEL_ENTRY_S = 0.0157e-9                 # one-hot select entry cost (m > 1)
SEL_SLOT_S = 0.002e-9                   # per window member per slot
HBM_BPS = _cc.get("hbm_bps")
# the reference's v3 route rates and its closed-form calibration, TPU v5e
# fits that price only estimate_v3's and _convert_v3's choices, as the
# reference's do (ROADMAP A.7b)
G_GRP = 16                  # compact buckets per TPU out block
ROUTE_FIXED_S = 0.45e-6
BLOCK_SWITCH_S = 4e-6       # per out/source block change (pipeline flush)
ROUTE_BASE_S = 0.078e-9                 # run-total + write, per slot
ROUTE_SEL_S = 0.003e-9                  # pass-2 select, per member
ROUTE_DMA_S = 0.0025e-9                 # per out plane (incl. pruned)
ROUTE_CMP_S = 0.0055e-9                 # per ACTIVE plane (gather+mask+sum)
EST_CAL = 0.62              # closed-form → measured calibration
V3_PASS1_ROWS = 160_000     # v3's pass-1 rows per call, cut at a multiple
#                             of t1 (the reference's literal, apart from
#                             PASS1_CALL_ROWS)


@dataclasses.dataclass(frozen=True)
class Xch4State(TensorState):
    """The reference's ``Xch4State`` with torch tensors; at float64 its
    df64 lo planes (``val1_lo``, ``dia_lo``) are folded into ``val1`` and
    ``dia_vals``."""
    n_row: int
    n_col: int
    nnz: int
    m1: int                  # pass-1 x window col-blocks
    m2: int                  # pass-2 product window blocks (of 128 slots)
    t1: int                  # pass-1 stream rows per grid step
    t2: int                  # pass-2 stream rows per grid step
    kblk: int                # 128-row blocks per band: idx planes
    p_oh: int                # out blocks a step can reach
    gb: int                  # 128-row blocks per out group
    n_chunks: int
    p1: int                  # product stream rows per chunk
    cb_pad: int              # x-table col-blocks
    n_slots1: int
    n_slots2: int
    chunk_ngrp: tuple        # out groups per pass-2 call
    long_n: int              # number of long rows split out (0 = none)
    # pass 1 (per-call tuples)
    win1: tuple              # (H1_c,) int32 — x window base col-block
    lane1: tuple             # (H1_c, 128) int8
    sub1: tuple              # (H1_c, 128) int8
    val1: tuple              # (H1_c, 128) float32 or float64
    # pass 2 (per-call tuples)
    gids2: tuple             # (S_c,) int32 — call-local out group per step
    off2: tuple              # (S_c,) int32 — step base block − gid·gb
    cs2: tuple               # (S_c,) int32 — source chunk per step
    win2: tuple              # (H_c,) int32 — chunk-local product row base
    lane2: tuple             # (H_c, 128) int8
    sub2: tuple              # (H_c, 128) int8
    hm2: tuple               # (H_c, 128) int8 — run head lane − 1
    sig2: tuple              # (H_c, 128) int8 — band base block − step base
    #                          block, lane-replicated
    idx2: tuple              # (kblk, H_c, 128) int8 — end lanes, −1 masked
    vis_gids: torch.Tensor   # (n_vis,) int32 — visited out groups, ascending
    long: Optional["Xch4State"] = None   # nested state on the long rows
    long_rows: Optional[torch.Tensor] = None  # (long_n,) int32 row ids
    dia_vals: Optional[torch.Tensor] = None   # (len(dia_offs), n_row)
    dia_offs: tuple = ()     # peeled high-fill diagonal offsets
    # the spmv route's stream, derived by route_rows (per-call tuples)
    base2: tuple = ()        # (S_c,) int32 — y position of out row 0
    dest2: tuple = ()        # (H_c, 128) int16 — run-end y position −
    #                          base2, −1 off run ends
    merge2: int = 0          # the route's merge span (0: none)
    val2: tuple = ()         # (H_c, 128) of val1's type — value of the
    #                          pass-1 slot pass 2 reads there (0: padding)
    col2: tuple = ()         # (H_c, 128) int32 — its x position (0: padding)


@dataclasses.dataclass(frozen=True)
class XchState(TensorState):
    """The reference's v3 σ-plane ``XchState`` with torch tensors: pass 1
    as in ``Xch4State``; pass 2 re-gathers the products in (bucket, src)
    order, a bucket being ``planes`` · 128 consecutive rows, and routes the
    run totals through ``span`` · ``planes`` σ planes of end lanes to the
    out rows of compact (nonempty) buckets, ``G_GRP`` to a TPU out block."""
    n_row: int
    n_col: int
    nnz: int
    m1: int                 # pass-1 x window col-blocks
    m2: int                 # pass-2 product window blocks (of 128 slots)
    t1: int                 # pass-1 stream rows per grid step
    t2: int                 # pass-2 stream rows per grid step
    planes: int             # σ planes = bucket scope / 128 (8, 16 or 32)
    span: int               # buckets per out slot (2: a step may straddle
    #                         one bucket boundary, the host overlap-adds)
    n_chunks: int
    p1: int                 # product stream rows per chunk
    cb_pad: int             # x-table col-blocks
    n_buckets: int          # compact (nonempty) buckets
    n_slots1: int
    n_slots2: int
    chunk_nb: tuple         # bucket G-groups per pass-2 call
    # pass 1 (per-call tuples)
    win1: tuple             # (H1_c,) int32 — x window base col-block
    lane1: tuple            # (H1_c, 128) int8
    sub1: tuple             # (H1_c, 128) int8
    val1: tuple             # (H1_c, 128) of the value type
    # pass 2 (per-call tuples)
    uids2: tuple            # (S_c,) int32 — call-local compact bucket/step
    cs2: tuple              # (S_c,) int32 — source chunk per step
    win2: tuple             # (H2_c,) int32 — chunk-local product row base
    lane2: tuple            # (H2_c, 128) int8
    sub2: tuple             # (H2_c, 128) int8
    hm2: tuple              # (H2_c, 128) int8 — run head lane − 1
    idx2: tuple             # (span·planes, H2_c, 128) int8 — σ-plane end
    #                         lanes, −1 masked
    bucket_ids: torch.Tensor  # (n_buckets,) int32 — original bucket ids
    gids2: Optional[tuple] = None   # (S_c,) int32 — call-local G-group/step
    sg0_2: Optional[tuple] = None   # (S_c,) int32 — first active σ plane
    sg1_2: Optional[tuple] = None   # (S_c,) int32 — last active σ plane
    #                                 (inclusive; −1: the step routes none)


# ---------------------------------------------------------------- planning ---

def _span_quantiles(sorted_keys, group_starts,
                    qs=(0.3, 0.5, 0.7, 0.85, 0.95)):
    """Candidate window sizes (in 128-blocks) from span quantiles of 128
    consecutive same-group keys — the walk's cut rate at m = q-span is ~1-q.
    Mixed structures (dense rows + scatter) have strongly bimodal spans, so
    the grid must be dense enough to land near the cost optimum."""
    if len(sorted_keys) <= 128:
        return [1]
    lag = 127
    # subsample positions on giants: the span distribution converges fast
    step = max(len(sorted_keys) >> 22, 1)
    pos = np.arange(0, len(sorted_keys) - lag, step)
    a = sorted_keys[pos + lag] - sorted_keys[pos]
    # ignore spans that cross a group boundary (the walk cuts there anyway)
    gi = np.searchsorted(group_starts, pos, side="right")
    same = gi == np.searchsorted(group_starts, pos + lag, side="right")
    a = a[same]
    if a.size == 0:
        return [1]
    out = []
    for q in qs:
        s = int(np.quantile(a, q))
        out.append(int(np.clip((s >> 7) + 2, 1, M_MAX)))
    return sorted(set(out))


def _sample_groups(keys, starts, stride):
    """Every ``stride``-th group's key range, with rebuilt boundaries —
    a structure-preserving subproblem for candidate evaluation."""
    if stride <= 1 or len(starts) <= stride + 1:
        return keys, starts
    segs = [(starts[g], starts[g + 1])
            for g in range(0, len(starts) - 1, stride)]
    keys_s = np.concatenate([keys[a:b] for a, b in segs])
    lens = np.asarray([b - a for a, b in segs], np.int64)
    starts_s = np.concatenate([[0], np.cumsum(lens)])
    return keys_s, starts_s


def _sample_group_runs(keys, starts, stride, run=16):
    """RUNS of ``run`` consecutive groups, one run per ``stride·run``
    groups.  Unlike the strided sampler, adjacent sampled groups keep
    their true chunk/band deltas — a strided sample makes the band drift
    look ``stride``× faster and the step-assembly pad model then flees to
    tiny t2 (r5: circuit5M planned t2=32 where 128 measures faster).
    Returns (keys_s, starts_s, run_index_lists) where the third maps
    sampled groups to their original index."""
    n_grp = len(starts) - 1
    if stride <= 1 or n_grp <= stride * run + 1:
        return keys, starts, np.arange(n_grp)
    gsel = []
    for g0 in range(0, n_grp, stride * run):
        gsel.extend(range(g0, min(g0 + run, n_grp)))
    gsel = np.asarray(gsel, np.int64)
    segs = [(starts[g], starts[g + 1]) for g in gsel]
    keys_s = np.concatenate([keys[a:b] for a, b in segs])
    lens = np.asarray([b - a for a, b in segs], np.int64)
    starts_s = np.concatenate([[0], np.cumsum(lens)])
    return keys_s, starts_s, gsel


SAMPLE_WALK_NNZ = 8_000_000   # candidate walks run on a 1/8 group sample
#                               past this; only the winner walks in full


def _align8(m, cap=M_MAX):
    """Window sizes must be f32-sublane-aligned: pl.ds(win, m) with m not a
    multiple of 8 takes Mosaic's unaligned-slice path, measured ~3x slower
    per slot (r4 probe: mul m=5 0.142 vs m=8 0.041 ns/slot; route m=17
    0.62 vs m=16 0.26).  m=1 slices hit a fast special case."""
    if m <= 1:
        return 1
    return min(((m + 7) // 8) * 8, (cap // 8) * 8 if cap >= 8 else 1)


def _best_walk(keys, starts, t_cands, fixed_s, per_slot_s, pad_h,
               m_override=None, m_cap=M_MAX, extra_cands=()):
    """Walk at candidate window sizes, pick the (m, t) minimizing the
    measured step-cost model: steps·fixed + padded_slots·per_slot_s(m).
    On giants the candidates are evaluated on a group sample; the winner
    gets the one full walk."""
    if m_override:
        cands = [min(m_override, m_cap)]
    else:
        cands = [min(m, m_cap)
                 for m in _span_quantiles(keys, starts[1:-1])]
        cands += [min(max(int(m), 1), m_cap) for m in extra_cands]
    cands = sorted(set(_align8(m, m_cap) for m in cands))
    stride = 8 if (len(keys) > SAMPLE_WALK_NNZ and len(cands) > 1) else 1
    keys_e, starts_e = _sample_groups(keys, starts, stride)
    best = None
    for m in cands:
        sizes, bases, grows = _walk(keys_e, starts_e, m)
        for t in t_cands:
            h = pad_h(grows, t) * stride
            sec = (h / t) * fixed_s + h * LANES * per_slot_s(m)
            if best is None or sec < best[0]:
                best = (sec, m, t, sizes, bases, grows)
    m, t = best[1], best[2]
    if stride > 1:
        sizes, bases, grows = _walk(keys, starts, m)
        return m, t, sizes, bases, grows
    return m, t, best[3], best[4], best[5]


# ------------------------------------------------------------- v3 convert ---

def estimate_v3(coo: COOMatrix, cfg: Config) -> dict:
    """The reference's closed-form v3 plan (no sorts): scope, K, predicted
    m1/m2 and cost, from the uniform-mix bound m1·m2 ≈ n_row·n_col/(scope·
    nnz).  ``convert`` builds it under ``plan=estimate_v3(coo, cfg) |
    {"route_v": 3}``."""
    n_r, n_c, nnz = max(coo.n_row, 1), max(coo.n_col, 1), max(coo.nnz, 1)
    if coo.nnz == 0:
        return {"feasible": False, "est_s": 0.0}
    vsz = value_size(cfg.dtype)
    if cdiv(n_c, LANES) * LANES * vsz > X_TABLE_CAP:
        return {"feasible": False, "est_s": float("inf")}
    best = None
    for planes in (8, 16, 32):
        scope = planes * LANES
        q = n_r * n_c / (scope * nnz)
        # the route select costs ~2x the mul select per member, so m1 ≈ 2·m2
        m2_bal = max(np.sqrt(q / 2.0), 1.0)
        k_slots = int(np.clip(m2_bal * scope * nnz / n_r,
                              16 * LANES, P1_CAP_ROWS * LANES))
        m1 = int(np.clip(cdiv(n_c, k_slots), 1, M_MAX))
        m2 = int(np.clip(round(k_slots * n_r / (scope * nnz) + 0.5), 1,
                         M2_CAP))
        t1, t2 = 128, 32
        # padding: about t2/2 pad rows a (bucket, chunk) group, and ~10% of
        # the walks'
        n_grp = max(n_r / scope, 1.0) + nnz / k_slots
        slots2 = 1.1 * nnz + n_grp * (t2 / 2) * LANES
        slots1 = 1.05 * nnz
        per1 = (BASE_SLOT_S + (SEL_ENTRY_S if m1 > 1 else 0.0)
                + m1 * SEL_SLOT_S)
        deg = nnz / n_r
        n_chunks_e = max(nnz / k_slots, 1.0)
        avg_run = max(deg / min(n_chunks_e, max(deg, 1.0)), 1.0)
        act = min(planes, t2 / avg_run + 1.0)   # active σ planes per step
        per2 = (ROUTE_BASE_S + m2 * ROUTE_SEL_S
                + 2 * planes * ROUTE_DMA_S + act * ROUTE_CMP_S
                + 3.0 / HBM_BPS)
        switches = n_r / scope / G_GRP + 2.0 * nnz / k_slots
        sec = (slots1 / LANES / t1 * MUL_FIXED_S
               + slots2 / LANES / t2 * ROUTE_FIXED_S
               + switches * BLOCK_SWITCH_S
               + slots1 * max(per1, (vsz + 2 + 4) / HBM_BPS)
               + slots2 * per2)
        cand = {"feasible": True, "est_s": sec, "planes": planes,
                "k_slots": k_slots, "m1": m1, "m2": m2, "t1": t1, "t2": t2,
                "slots": int(slots1 + slots2)}
        if best is None or sec < best["est_s"]:
            best = cand
    best["est_s"] *= EST_CAL
    return best


def _pad_span(grows, t, span, chunk_map, bmap):
    """Group stream-row counts padded so that a t-row step never crosses a
    chunk or a bucket G-group boundary and touches at most ``span``
    consecutive compact buckets (the out slot covers the pair, the host
    overlap-adds)."""
    pads = np.zeros(len(grows), np.int64)
    cur = 0
    straddle_step = -1
    for g, r in enumerate(grows):
        if g > 0 and cur % t != 0:
            if (chunk_map[g] != chunk_map[g - 1] or span == 1
                    or bmap[g] // G_GRP != bmap[g - 1] // G_GRP):
                pads[g - 1] += t - (cur % t)
                cur += t - (cur % t)
                straddle_step = -1
            else:
                s = cur // t
                if s == straddle_step:      # a 3rd bucket in one step
                    pads[g - 1] += t - (cur % t)
                    cur += t - (cur % t)
                else:
                    straddle_step = s
        cur += int(r)
    if cur % t:
        pads[-1] += t - (cur % t)
    return grows + pads


def _convert_v3(coo: COOMatrix, cfg: Config, plan: dict = None) -> XchState:
    """The reference's v3 layout builder (its ``formats/xch.py:386``), in
    numpy and unchanged in behaviour: one COO and one plan give the same
    arrays in both packages.  Keeps the plan's overrides ``planes``,
    ``k_slots``, ``m1_fix``, ``m2_fix``, ``t1_fix``, ``t2_fix`` and
    ``span_fix``."""
    dtype = cfg.np_dtype
    if coo.nnz == 0 or coo.n_row == 0:
        return _empty_state(coo, cfg)
    p = plan or estimate_v3(coo, cfg)
    if not p["feasible"]:
        raise ValueError("xch: infeasible (x table exceeds VMEM cap)")
    planes, t1, t2 = p["planes"], p["t1"], p["t2"]
    scope = planes * LANES
    nnz = coo.nnz

    rows0 = hm.astype(coo.row, np.int64)
    cols0 = hm.astype(coo.col, np.int64)
    vals0 = hm.astype(coo.val, dtype)

    # ---- pass-1 layout: (chunk, col)-sorted, sliding x windows ----
    k_slots = int(min(p["k_slots"], nnz))
    n_chunks = cdiv(nnz, k_slots)
    g1 = hm.arange(nnz) // k_slots            # input is row-major sorted
    o1 = hm.argsort_keys(g1 * np.int64(coo.n_col) + cols0)
    cols_s = cols0[o1]
    chunk_starts = np.concatenate(
        [np.searchsorted(g1[o1], np.arange(n_chunks)), [nnz]])

    def _pad1(grows, t):
        return len(grows) * int(cdiv(int(grows.max(initial=1)), t) * t)

    m1, t1, sizes1, bases1, crows1 = _best_walk(
        cols_s, chunk_starts, (32, 64, 128) if not p.get("t1_fix") else
        (p["t1_fix"],), MUL_FIXED_S,
        lambda m: (BASE_SLOT_S + (SEL_ENTRY_S if m > 1 else 0.0)
                   + m * SEL_SLOT_S), _pad1,
        m_override=p.get("m1_fix"),
        extra_cands=(round(coo.n_col / k_slots) + 1,))

    p1 = int(cdiv(int(crows1.max(initial=1)), t1) * t1)
    h1 = n_chunks * p1
    # walk rows (chunk-major) -> final stream rows at chunk offsets
    wstart1 = np.concatenate([[0], np.cumsum(crows1)[:-1]])
    cidx = np.repeat(hm.arange(n_chunks), crows1)
    final1 = cidx * p1 + (hm.arange(len(sizes1)) - wstart1[cidx])

    win1 = hm.zeros(h1, np.int32)
    win1[final1] = bases1.astype(np.int32)
    lane1 = hm.zeros((h1, LANES), np.int8)
    sub1 = hm.zeros((h1, LANES), np.int8)
    val1 = hm.zeros((h1, LANES), dtype)
    sr1 = final1[np.repeat(hm.arange(len(sizes1)), sizes1)]
    li1 = hm.arange(nnz) - np.repeat(wslot_starts(sizes1), sizes1)
    lane1[sr1, li1] = (cols_s & (LANES - 1)).astype(np.int8)
    sub1[sr1, li1] = ((cols_s >> 7) - win1[sr1]).astype(np.int8)
    val1[sr1, li1] = vals0[o1]

    # per-nnz product position (in pass-1 order)
    src = sr1 * np.int64(LANES) + li1

    # ---- pass-2 layout: (bucket, src)-sorted, sliding product windows ----
    bshift = int(np.log2(scope))
    buckets = (rows0[o1] >> bshift)
    o2 = hm.argsort_keys(buckets * np.int64(h1) * LANES + src)
    src_s = src[o2]
    buck_s = buckets[o2]
    rows_s = rows0[o1][o2]
    chunk_of = src_s // (np.int64(p1) * LANES)
    grp = buck_s * np.int64(n_chunks + 1) + chunk_of
    gb = np.flatnonzero(np.concatenate([[True], grp[1:] != grp[:-1]]))
    grp_starts = np.append(gb, nnz)
    grp_bucket0 = buck_s[gb]
    grp_chunk0 = chunk_of[gb].astype(np.int64)

    ub0, bidx0 = np.unique(grp_bucket0, return_inverse=True)

    span_cands = (1, 2) if not p.get("span_fix") else (p["span_fix"],)
    t2_cands = (32, 64) if not p.get("t2_fix") else (p["t2_fix"],)

    # walk per m candidate (span/t-independent), then pick (m, t, span) by
    # the fitted step-cost model; candidates evaluated on a group sample
    # past SAMPLE_WALK_NNZ, winner walked in full
    scope_deg = scope * nnz / max(coo.n_row, 1)
    if p.get("m2_fix"):
        m_cands = [p["m2_fix"]]
    else:
        m_cands = _span_quantiles(src_s, grp_starts[1:-1])
        m_cands.append(round(k_slots / max(scope_deg, 1.0)) + 1)
    m_cands = sorted(set(_align8(min(max(m, 1), M2_CAP, p1))
                         for m in m_cands))
    stride = 8 if (nnz > SAMPLE_WALK_NNZ and len(m_cands) > 1) else 1
    src_e, grp_starts_e = _sample_groups(src_s, grp_starts, stride)
    chunk_e = grp_chunk0[::stride] if stride > 1 else grp_chunk0
    bidx_e = bidx0[::stride] if stride > 1 else bidx0

    # expected run length (adjacent same-row slots in (bucket, src) order
    # merge into one run after the per-stream-row row sort)
    row_brk = int(np.count_nonzero(rows_s[1:] != rows_s[:-1])) + 1
    avg_run = nnz / max(row_brk, 1)
    best = None
    for m_c in m_cands:
        wk = _walk(src_e, grp_starts_e, m_c)
        for t_c in t2_cands:
            for sp_c in span_cands:
                h_c = int(_pad_span(wk[2], t_c, sp_c, chunk_e,
                                    bidx_e).sum()) * stride
                act = min(sp_c * planes, t_c / max(avg_run, 1.0) + 1.0)
                per = (ROUTE_BASE_S + m_c * ROUTE_SEL_S
                       + sp_c * planes * ROUTE_DMA_S + act * ROUTE_CMP_S
                       + 3.0 / HBM_BPS)
                sec = (h_c / t_c) * ROUTE_FIXED_S + h_c * LANES * per
                if best is None or sec < best[0]:
                    best = (sec, m_c, t_c, sp_c, wk)
    _, m2, t2, span, wk = best
    if stride > 1:
        wk = _walk(src_s, grp_starts, m2)
    sizes2, bases2, grows2 = wk

    grows_pad = _pad_span(grows2, t2, span, grp_chunk0, bidx0)
    h2 = int(grows_pad.sum())
    gstart = np.concatenate([[0], np.cumsum(grows_pad)[:-1]])
    wstart2 = np.concatenate([[0], np.cumsum(grows2)[:-1]])
    gidx = np.repeat(hm.arange(len(grows2)), grows2)
    final2 = gstart[gidx] + (hm.arange(len(sizes2)) - wstart2[gidx])

    # chunk-local window base, clamped so [win, win+m2) stays in the block;
    # padded rows inherit their group's chunk (any valid base: 0)
    base_loc = bases2 - grp_chunk0[gidx] * p1
    base_loc = np.minimum(np.maximum(base_loc, 0), p1 - m2)
    win2 = hm.zeros(h2, np.int32)
    win2[final2] = base_loc.astype(np.int32)

    # per-slot stream row, then re-sort slots by (stream row, y row, src) so
    # each y row is one contiguous run per stream row
    sr2_0 = final2[np.repeat(hm.arange(len(sizes2)), sizes2)]
    o3 = hm.argsort_keys(sr2_0 * np.int64(coo.n_row + 1) + rows_s)
    src_f, rows_f, sr2 = src_s[o3], rows_s[o3], sr2_0[o3]
    new_row = np.concatenate([[True], sr2[1:] != sr2[:-1]])
    rstart = np.flatnonzero(new_row)
    li2 = hm.arange(nnz) - rstart[np.cumsum(new_row) - 1]

    lane2 = hm.zeros((h2, LANES), np.int8)
    sub2 = hm.zeros((h2, LANES), np.int8)
    hm2 = hm.zeros((h2, LANES), np.int8)
    src_row = src_f >> 7
    chunk_f = src_row // np.int64(p1)
    hm.scatter2d(lane2, sr2, li2, (src_f & (LANES - 1)).astype(np.int8))
    hm.scatter2d(sub2, sr2, li2,
                 (src_row - chunk_f * p1 - win2[sr2]).astype(np.int8))

    new_run = hm.zeros(nnz, np.bool_)
    new_run[0] = True
    new_run[1:] = (rows_f[1:] != rows_f[:-1]) | (sr2[1:] != sr2[:-1])
    qpos = sr2 * LANES + li2
    head_q = np.maximum.accumulate(np.where(new_run, qpos, -1))
    hm.scatter2d(hm2, sr2, li2, (head_q - sr2 * LANES - 1).astype(np.int8))

    end = hm.zeros(nnz, np.bool_)
    end[:-1] = new_run[1:]
    end[-1] = True
    r_run, sr_run, e_lane = rows_f[end], sr2[end], li2[end]

    # per-step first group / compact bucket / bucket G-group
    n_steps = h2 // t2
    grp_of_frow = np.repeat(hm.arange(len(grows_pad)),
                            grows_pad.astype(np.int64))
    g_step = grp_of_frow[::t2]
    n_buckets = len(ub0)
    uids = bidx0[g_step].astype(np.int32)         # compact, non-decreasing
    gids = uids // G_GRP                          # out-block G-group
    chunk_step = grp_chunk0[g_step].astype(np.int32)

    # σ: span-local — off = run's compact bucket − step's first bucket
    grp_run = grp_of_frow[sr_run]                 # group per run end
    off_run = bidx0[grp_run] - uids[sr_run // t2].astype(np.int64)
    assert off_run.min(initial=0) >= 0 and \
        off_run.max(initial=0) < span, \
        "xch: a grid step spans more buckets than the out block covers"
    sigma = ((r_run & np.int64(scope - 1)) >> 7) + planes * off_run
    l_run = r_run & np.int64(LANES - 1)
    idx2 = hm.full((span * planes, h2, LANES), -1, np.int8)
    idx2[sigma, sr_run, l_run] = e_lane.astype(np.int8)

    # per-step active σ range (the kernel's plane-group pruning); run ends
    # are stream-row-sorted so reduceat segments are contiguous
    sg0 = hm.zeros(n_steps, np.int32)
    sg1 = hm.full(n_steps, -1, np.int32)
    if len(sr_run):
        s_of = (sr_run // t2).astype(np.int64)
        bnd = np.flatnonzero(np.concatenate([[True], s_of[1:] != s_of[:-1]]))
        sg0[s_of[bnd]] = np.minimum.reduceat(sigma, bnd).astype(np.int32)
        sg1[s_of[bnd]] = np.maximum.reduceat(sigma, bnd).astype(np.int32)

    # ---- pass-2 kernel calls, cut at G-group changes ----
    ngb_tot = int(gids[-1]) + 1 if n_steps else 0
    cz = _chunk_steps(gids, n_steps, ngb_tot,
                      max_steps=max(CHUNK_ROWS // t2, 1))
    u_t, g_t, c_t, w_t, la_t, su_t, hm_t, ix_t, s0_t, s1_t = \
        [], [], [], [], [], [], [], [], [], []
    for s0, s1, g0, _ngb in cz:
        r0, r1 = s0 * t2, s1 * t2
        u_t.append(_t((uids[s0:s1] - g0 * G_GRP).astype(np.int32)))
        g_t.append(_t((gids[s0:s1] - g0).astype(np.int32)))
        c_t.append(_t(chunk_step[s0:s1]))
        w_t.append(_t(win2[r0:r1]))
        la_t.append(_t(lane2[r0:r1]))
        su_t.append(_t(sub2[r0:r1]))
        hm_t.append(_t(hm2[r0:r1]))
        ix_t.append(_t(idx2[:, r0:r1]))
        s0_t.append(_t(sg0[s0:s1]))
        s1_t.append(_t(sg1[s0:s1]))

    # ---- pass-1 calls: a plain range split ----
    max_rows1 = (V3_PASS1_ROWS // t1) * t1
    w1_t, la1_t, su1_t, va1_t = [], [], [], []
    for r0 in range(0, h1, max_rows1):
        r1 = min(r0 + max_rows1, h1)
        w1_t.append(_t(win1[r0:r1]))
        la1_t.append(_t(lane1[r0:r1]))
        su1_t.append(_t(sub1[r0:r1]))
        va1_t.append(value_tensor(val1[r0:r1], cfg.dtype))

    cb_tot = cdiv(max(coo.n_col, 1), LANES)
    return XchState(
        n_row=coo.n_row, n_col=coo.n_col, nnz=nnz, m1=m1, m2=m2, t1=t1,
        t2=t2, planes=planes, span=span, n_chunks=n_chunks, p1=p1,
        cb_pad=cb_tot + m1, n_buckets=n_buckets,
        n_slots1=h1 * LANES, n_slots2=h2 * LANES,
        chunk_nb=tuple(c[3] for c in cz),
        win1=tuple(w1_t), lane1=tuple(la1_t), sub1=tuple(su1_t),
        val1=tuple(va1_t),
        uids2=tuple(u_t), cs2=tuple(c_t), win2=tuple(w_t),
        lane2=tuple(la_t), sub2=tuple(su_t), hm2=tuple(hm_t),
        idx2=tuple(ix_t), bucket_ids=_t(ub0.astype(np.int32)),
        gids2=tuple(g_t), sg0_2=tuple(s0_t), sg1_2=tuple(s1_t))


def _empty_state(coo, cfg) -> XchState:
    """The reference's empty v3 state."""
    z8 = lambda *s: _t(hm.zeros(s, np.int8))  # noqa: E731
    z32 = lambda: _t(hm.zeros(0, np.int32))  # noqa: E731
    return XchState(
        n_row=coo.n_row, n_col=coo.n_col, nnz=0, m1=1, m2=1, t1=8, t2=8,
        planes=8, span=1, n_chunks=1, p1=8, cb_pad=1, n_buckets=0,
        n_slots1=0, n_slots2=0, chunk_nb=(0,),
        win1=(z32(),), lane1=(z8(0, LANES),), sub1=(z8(0, LANES),),
        val1=(value_tensor(hm.zeros((0, LANES), cfg.np_dtype), cfg.dtype),),
        uids2=(z32(),), gids2=(z32(),), sg0_2=(z32(),), sg1_2=(z32(),),
        cs2=(z32(),), win2=(z32(),),
        lane2=(z8(0, LANES),), sub2=(z8(0, LANES),), hm2=(z8(0, LANES),),
        idx2=(_t(hm.full((8, 0, LANES), -1, np.int8)),),
        bucket_ids=z32())


# ------------------------------------------------------------- v4 convert ---

# the reference's v4 route-kernel rates, fitted on a TPU v5e
# (scripts/probe_xch_v4.py + the clean grid at T=128/kblk=4/p_oh=16:
#  m 1→0.0656, 8→0.0965, 16→0.1274 ns/slot → 0.0044/member;
#  kblk 1→0.0766, 4→0.0971, 16→0.1667 → 0.006/plane;
#  T 32→0.1978, 128→0.0964, 256→0.0822 → 0.27 µs/step fixed;
#  p_oh 8→0.0924, 48→0.1003 → 0.0002/row):
R4_BASE_S = 0.022e-9        # run totals + write + window entry + streams
R4_SEL_S = 0.0044e-9        # per window member (select + pick share)
R4_KBLK_S = 0.006e-9        # per idx plane (pick + one-hot matmul + stream)
R4_POH_S = 0.0002e-9        # per one-hot output row
R4_FIXED_S = 0.27e-6        # per grid step
X4_GB = 1024                # out-group blocks (512 KB f32 out block)
LONG_DEG = 96               # long-row split threshold (deg ≥ this)
LONG_MIN_SHARE = 0.06       # split only when long rows hold ≥ this nnz share
PEEL_FILL = 0.08            # peel a diagonal offset at ≥ this fill
PEEL_MIN_SHARE = 0.04       # peel only when the band holds ≥ this nnz share
PEEL_MAX_OFFS = 32          # diagonal planes cap (k·n_row values in HBM)


def _r4_route_slot_s(m, kblk, p_oh):
    return (R4_BASE_S + m * R4_SEL_S + kblk * R4_KBLK_S + p_oh * R4_POH_S
            + 7.0 / HBM_BPS)


def _r4_mul_slot_s(m):
    return (BASE_SLOT_S + (SEL_ENTRY_S if m > 1 else 0.0) + m * SEL_SLOT_S
            + 10.0 / HBM_BPS)


def _peel_bands(rows0, cols0, n_row, n_col, nnz):
    """High-fill diagonal offsets (the circuit-class structure lever):
    a band at fill f costs 2·n_row streamed values to apply with static
    slices but saves f·n_row exchange slots at ~0.2 ns each — profitable
    from f ≈ 0.05.  Returns (offsets ascending, per-nnz mask) or (None,
    None)."""
    d = cols0 - rows0
    dmin, dmax = int(d.min()), int(d.max())
    if dmax - dmin > 4 * (n_row + n_col):
        return None, None
    cnt = np.bincount(d - dmin)
    # fill relative to the offset's maximum possible length
    lens = np.minimum(n_row + np.minimum(np.arange(dmin, dmax + 1), 0),
                      n_col - np.maximum(np.arange(dmin, dmax + 1), 0))
    lens = np.maximum(lens, 1)
    fill = cnt / lens
    cand = np.flatnonzero(fill >= PEEL_FILL)
    if len(cand) == 0:
        return None, None
    if len(cand) > PEEL_MAX_OFFS:
        cand = cand[np.argsort(cnt[cand])[::-1][:PEEL_MAX_OFFS]]
        cand.sort()
    if cnt[cand].sum() < PEEL_MIN_SHARE * nnz:
        return None, None
    keep = np.zeros(dmax - dmin + 1, np.bool_)
    keep[cand] = True
    return (cand + dmin).astype(np.int64), keep[d - dmin]


def _split_long_rows(rows0, cols0, vals0, n_row, deg_thresh):
    """Partition nnz by row degree; returns (mask_long, long_row_ids)."""
    deg = np.bincount(rows0, minlength=n_row)
    long_ids = np.flatnonzero(deg >= deg_thresh)
    if len(long_ids) == 0:
        return None, None
    is_long = np.zeros(n_row, np.bool_)
    is_long[long_ids] = True
    return is_long[rows0], long_ids.astype(np.int64)


def _pass1_layout(cols0_s, vals0_s, nnz, n_col, k_slots, p, dtype):
    """(chunk, col)-sorted pass-1 layout.  Returns the per-nnz product
    position ``src`` (in the (n_chunks, p1, 128) grid), the layout arrays,
    and o1 (the sort order applied to the caller's arrays)."""
    n_chunks = cdiv(nnz, k_slots)
    g1 = hm.arange(nnz) // k_slots
    o1 = hm.argsort_keys(g1 * np.int64(n_col) + cols0_s)
    cols_s = cols0_s[o1]
    chunk_starts = np.concatenate(
        [np.searchsorted(g1[o1], np.arange(n_chunks)), [nnz]])

    def _pad1(grows, t):
        return len(grows) * int(cdiv(int(grows.max(initial=1)), t) * t)

    m1, t1, sizes1, bases1, crows1 = _best_walk(
        cols_s, chunk_starts, (64, 128) if not p.get("t1_fix") else
        (p["t1_fix"],), MUL_FIXED_S, _r4_mul_slot_s, _pad1,
        m_override=p.get("m1_fix"),
        extra_cands=(round(n_col / k_slots) + 1,))

    # p1-outlier refinement (r5): all chunks pad to the max chunk's stream
    # rows, so one high-spread chunk inflates every chunk's product block
    # (ASIC r4: pass-1 pad 1.59×).  Split chunks whose walk exceeds the
    # 80th-percentile row count (proportionally by slots) and redo the one
    # global sort + walk — host cost ~1 extra radix pass.
    if len(crows1) >= 4 and not p.get("no_refine"):
        tgt = int(np.quantile(crows1, 0.8) * 1.25) + 1
        if int(crows1.max()) > tgt:
            parts = np.maximum(cdiv_np(crows1, tgt), 1)
            bounds = [0]
            for c in range(n_chunks):
                a, b = int(chunk_starts[c]), int(chunk_starts[c + 1])
                for s in range(1, int(parts[c])):
                    bounds.append(a + (b - a) * s // int(parts[c]))
                bounds.append(b)
            bounds = np.asarray(sorted(set(bounds)), np.int64)
            n_chunks = len(bounds) - 1
            g1 = np.repeat(hm.arange(n_chunks), np.diff(bounds))
            o1 = hm.argsort_keys(g1 * np.int64(n_col) + cols0_s)
            cols_s = cols0_s[o1]
            chunk_starts = np.concatenate(
                [np.searchsorted(g1[o1], np.arange(n_chunks)), [nnz]])
            m1, t1, sizes1, bases1, crows1 = _best_walk(
                cols_s, chunk_starts, (t1,), MUL_FIXED_S, _r4_mul_slot_s,
                _pad1, m_override=m1)

    p1 = int(cdiv(int(crows1.max(initial=1)), t1) * t1)
    h1 = n_chunks * p1
    wstart1 = np.concatenate([[0], np.cumsum(crows1)[:-1]])
    cidx = np.repeat(hm.arange(n_chunks), crows1)
    final1 = cidx * p1 + (hm.arange(len(sizes1)) - wstart1[cidx])

    win1 = hm.zeros(h1, np.int32)
    win1[final1] = bases1.astype(np.int32)
    lane1 = hm.zeros((h1, LANES), np.int8)
    sub1 = hm.zeros((h1, LANES), np.int8)
    val1 = hm.zeros((h1, LANES), dtype)
    sr1 = final1[np.repeat(hm.arange(len(sizes1)), sizes1)]
    li1 = hm.arange(nnz) - np.repeat(wslot_starts(sizes1), sizes1)
    hm.scatter2d(lane1, sr1, li1, (cols_s & (LANES - 1)).astype(np.int8))
    hm.scatter2d(sub1, sr1, li1, ((cols_s >> 7) - win1[sr1]).astype(np.int8))
    hm.scatter2d(val1, sr1, li1, vals0_s[o1].astype(val1.dtype))
    src = sr1 * np.int64(LANES) + li1
    chunk1 = g1[o1]
    return dict(o1=o1, src=src, chunk1=chunk1, n_chunks=n_chunks, p1=p1,
                h1=h1, m1=m1, t1=t1, win1=win1, lane1=lane1, sub1=sub1,
                val1=val1)


def _assemble_steps(grp_chunk, grp_band_blk, grows, t2, kblk, p_oh, gb):
    """Assign walk groups' stream rows to t2-row grid steps.

    Cuts (pad to the next step boundary) happen only at group transitions
    where (a) the source chunk changes, (b) the group's band falls in a new
    out group, or (c) the band's block no longer fits the step's p_oh
    window.  Returns (pads_per_group, step base blocks, step gids, step
    chunks) — the step arrays are emitted per assembled step."""
    n_grp = len(grows)
    pads = np.zeros(n_grp, np.int64)
    base_l, gid_l, cs_l = [], [], []
    cur = 0                    # rows in current (partial) step
    s_base = s_gid = s_cs = -1

    def _emit_steps(k):
        for _ in range(k):
            base_l.append(s_base)
            gid_l.append(s_gid)
            cs_l.append(s_cs)

    for g in range(n_grp):
        bb = int(grp_band_blk[g])
        gid = bb // gb
        cut = False
        if cur % t2 != 0:
            if grp_chunk[g] != s_cs or gid != s_gid or \
                    bb + kblk - s_base > p_oh:
                cut = True
        if cut:
            pads[g - 1] += t2 - (cur % t2)
            cur += t2 - (cur % t2)
            _emit_steps(1)
            cur = 0
        if cur == 0:
            s_cs = int(grp_chunk[g])
            s_gid = gid
            s_base = min(bb, gid * gb + gb - p_oh)
        r = int(grows[g])
        # full steps closed inside this group keep its attributes; a step
        # OPENED mid-group starts at this group's band
        while cur + r >= t2:
            take = t2 - cur
            r -= take
            cur = 0
            _emit_steps(1)
            if r > 0:
                s_cs = int(grp_chunk[g])
                s_gid = gid
                s_base = min(bb, gid * gb + gb - p_oh)
        cur += r
    if cur % t2:
        pads[-1] += t2 - (cur % t2)
        _emit_steps(1)
    elif cur:
        _emit_steps(1)
    return (pads, np.asarray(base_l, np.int64), np.asarray(gid_l, np.int64),
            np.asarray(cs_l, np.int64))


def _convert_v4(coo: COOMatrix, cfg: Config, p: dict) -> Xch4State:
    dtype = cfg.np_dtype
    if coo.nnz == 0 or coo.n_row == 0:
        return _empty_state4(coo, cfg)
    nnz_all = coo.nnz
    rows0 = hm.astype(coo.row, np.int64)
    cols0 = hm.astype(coo.col, np.int64)
    vals0 = hm.astype(coo.val, dtype)

    # ---- band peel (high-fill diagonals → static-slice streams) ----
    dia_offs: tuple = ()
    dia_vals_dev = None
    if not p.get("no_peel"):
        offs, mask_d = _peel_bands(rows0, cols0, coo.n_row, coo.n_col,
                                   nnz_all)
        if offs is not None:
            nr = max(coo.n_row, 1)
            oidx = np.searchsorted(offs, (cols0 - rows0)[mask_d])
            # weighted bincount: duplicate triplets must SUM (the COO
            # contract), not overwrite
            planes = np.bincount(
                oidx * np.int64(nr) + rows0[mask_d],
                weights=vals0[mask_d].astype(np.float64),
                minlength=len(offs) * nr).reshape(len(offs), nr)
            planes = planes.astype(dtype)
            dia_offs = tuple(int(o) for o in offs)
            dia_vals_dev = value_tensor(planes, cfg.dtype)
            keep = ~mask_d
            rows0, cols0, vals0 = rows0[keep], cols0[keep], vals0[keep]
            if len(rows0) == 0:
                st = _empty_state4(coo, cfg)
                return dataclasses.replace(st, nnz=nnz_all,
                                           dia_offs=dia_offs,
                                           dia_vals=dia_vals_dev)

    # ---- long-row split (structure fast-track) ----
    long_state = long_rows_dev = None
    long_n = 0
    if not p.get("no_long"):
        deg_t = p.get("long_deg", LONG_DEG)
        mask, long_ids = _split_long_rows(rows0, cols0, vals0, coo.n_row,
                                          deg_t)
        if mask is not None and \
                mask.sum() >= LONG_MIN_SHARE * nnz_all and len(long_ids):
            long_n = len(long_ids)
            remap = np.full(coo.n_row, -1, np.int64)
            remap[long_ids] = np.arange(long_n)
            sub = COOMatrix(n_row=long_n, n_col=coo.n_col,
                            row=remap[rows0[mask]], col=cols0[mask],
                            val=vals0[mask])
            sp = dict(p)
            sp["no_long"] = True
            for k in ("k_slots", "m1_fix", "m2_fix", "bs_fix", "t1_fix",
                      "t2_fix"):
                sp.pop(k, None)
            sp.update(estimate_v4(sub, cfg, no_long=True))
            long_state = _convert_v4(sub, cfg, sp)
            long_rows_dev = _t(long_ids.astype(np.int32))
            keep = ~mask
            rows0, cols0, vals0 = rows0[keep], cols0[keep], vals0[keep]
            if len(rows0) == 0:
                st = _empty_state4(coo, cfg)
                return dataclasses.replace(
                    st, nnz=nnz_all, long_n=long_n, long=long_state,
                    long_rows=long_rows_dev, dia_offs=dia_offs,
                    dia_vals=dia_vals_dev)
    nnz = len(rows0)

    # ---- pass 1 ----
    k_slots = int(min(p.get("k_slots", nnz), max(nnz, 1)))
    l1 = _pass1_layout(cols0, vals0, nnz, coo.n_col, k_slots, p, dtype)
    n_chunks, p1, h1, m1, t1 = (l1["n_chunks"], l1["p1"], l1["h1"],
                                l1["m1"], l1["t1"])
    src, chunk1 = l1["src"], l1["chunk1"]
    rows1 = rows0[l1["o1"]]

    # ---- pass 2: (chunk, band, src) sort + joint plan search ----
    # t2 trades the 0.27 µs/step fixed cost against p_oh-exhaustion pads
    # (a step covers ≈ t2/deg row blocks; low-deg matrices cut early unless
    # p_oh grows).  kblk sets the band sort granularity: coarser bands
    # halve the per-stream-row src span (m2 ∝ 1/kblk analytically), so
    # after planning at the seed kblk the model extrapolates the others and
    # re-sorts only when a ≥10% win is predicted.
    deg_r = max(nnz / max(coo.n_row, 1), 0.25)
    gb0 = int(p.get("gb", X4_GB))
    t2_cands = (32, 64, 128, 256) if not p.get("t2_fix") else (p["t2_fix"],)

    # plan-time slot sample: sorting the full stream per kblk candidate is
    # the convert's sort bill at giant scale; an src-RUN sample (contiguous
    # 8192-slot windows, 1/8 kept) preserves intra-group spacing so walks
    # measure true spans, and only the winning plan sorts in full
    plan_mask = None
    if nnz > SAMPLE_WALK_NNZ and not (p.get("kblk_fix") and p.get("m2_fix")
                                      and p.get("t2_fix")):
        plan_mask = (src >> 13) % 8 == 0

    def _plan_at(kblk, sampled=False):
        bs = 7 + int(np.log2(kblk))
        gb = max(gb0 - gb0 % kblk, kblk)
        if sampled and plan_mask is not None:
            src_p = src[plan_mask]
            rows_p = rows1[plan_mask]
            chunk_p = chunk1[plan_mask]
        else:
            sampled = False
            src_p, rows_p, chunk_p = src, rows1, chunk1
        band = rows_p >> bs
        n_band = int(band.max(initial=0)) + 2
        grp_key = chunk_p * np.int64(n_band) + band
        o2 = hm.argsort_keys(grp_key * np.int64(h1 * LANES + 1) + src_p)
        src_s = src_p[o2]
        gk_s = grp_key[o2]
        gbnd = np.flatnonzero(np.concatenate([[True],
                                              gk_s[1:] != gk_s[:-1]]))
        grp_starts = np.append(gbnd, nnz)
        grp_chunk = (gk_s[gbnd] // n_band).astype(np.int64)
        grp_band_blk = ((gk_s[gbnd] % n_band) << (bs - 7)).astype(np.int64)

        if p.get("p_oh_fix"):
            poh_of = lambda t_c: (int(p["p_oh_fix"]),)
        else:
            def poh_of(t_c):
                fit = _align8(int(np.clip(t_c / deg_r + kblk, 8, 64)))
                return tuple(sorted({fit, min(fit + 16, 64), 16}))

        if p.get("m2_fix"):
            m_cands = [_align8(p["m2_fix"], M2_CAP)]
        else:
            m_cands = _span_quantiles(src_s, grp_starts[1:-1])
            m_cands = sorted(set(_align8(min(max(m, 1), M2_CAP, p1))
                                 for m in m_cands))
        stride = 8 if (nnz > SAMPLE_WALK_NNZ and
                       (len(m_cands) > 1 or len(t2_cands) > 1)) else 1
        src_e, grp_starts_e, gsel = _sample_group_runs(src_s, grp_starts,
                                                       stride)
        chunk_e = grp_chunk[gsel]
        band_e = grp_band_blk[gsel]
        n_grp_all = len(grp_starts) - 1
        if len(gsel) == n_grp_all:
            stride = 1
        scale = n_grp_all / max(len(gsel), 1)
        best = None
        for m_c in m_cands:
            wk = _walk(src_e, grp_starts_e, m_c)
            for t_c in t2_cands:
                for poh_c in poh_of(t_c):
                    if poh_c < kblk or poh_c > gb:
                        continue
                    pads_e, _, _, _ = _assemble_steps(
                        chunk_e, band_e, wk[2], t_c, kblk, poh_c, gb)
                    h_c = int((wk[2].sum() + pads_e.sum()) * scale)
                    sec = ((h_c / t_c) * R4_FIXED_S
                           + h_c * LANES * _r4_route_slot_s(m_c, kblk,
                                                            poh_c))
                    if best is None or sec < best[0]:
                        best = (sec, m_c, t_c, poh_c, wk, stride)
        sec, m2, t2, p_oh, wk, stride = best
        return dict(sec=sec, m2=m2, t2=t2, p_oh=p_oh, wk=wk, stride=stride,
                    scale=scale,
                    kblk=kblk, gb=gb, o2=o2, src_s=src_s,
                    grp_starts=grp_starts, grp_chunk=grp_chunk,
                    grp_band_blk=grp_band_blk, h_est=None)

    kblk0 = int(p.get("kblk", 8))
    pl = _plan_at(kblk0)
    if not p.get("kblk_fix"):
        h0 = int(pl["wk"][2].sum() * pl["scale"])
        pred = []
        for k2 in sorted({max(kblk0 // 2, 1), kblk0 * 2,
                          min(kblk0 * 4, 32)} - {kblk0}):
            m2p = _align8(max(round(pl["m2"] * kblk0 / k2), 1), M2_CAP)
            secp = ((h0 / pl["t2"]) * R4_FIXED_S
                    + h0 * LANES * _r4_route_slot_s(m2p, k2, pl["p_oh"]))
            pred.append((secp, k2))
        pred.sort()
        if pred and pred[0][0] < 0.9 * pl["sec"]:
            pl2 = _plan_at(pred[0][1])
            if pl2["sec"] < pl["sec"]:
                pl = pl2

    kblk, gb, m2, t2, p_oh = (pl["kblk"], pl["gb"], pl["m2"], pl["t2"],
                              pl["p_oh"])
    o2, src_s = pl["o2"], pl["src_s"]
    grp_starts, grp_chunk, grp_band_blk = (pl["grp_starts"], pl["grp_chunk"],
                                           pl["grp_band_blk"])
    rows_s = rows1[o2]
    wk = pl["wk"]
    if pl["stride"] > 1:
        wk = _walk(src_s, grp_starts, m2)
    sizes2, bases2, grows2 = wk

    # an out group must fit one pallas call (SMEM prefetch cap): shrink gb
    # until the densest group's PADDED step count fits the call budget.
    # gb_fix (distributed stacking: every shard must agree on gb) skips the
    # shrink — an oversized group then raises in _chunk_steps.
    cap_steps = max(CHUNK_ROWS // t2, 1)
    gb_min = max(2 * kblk, 8)
    while True:
        p_oh_eff = max(min(p_oh, gb // 8 * 8), 8)
        pads, st_base, st_gid, st_cs = _assemble_steps(
            grp_chunk, grp_band_blk, grows2, t2, kblk, p_oh_eff, gb)
        per_grp = np.bincount(st_gid) if len(st_gid) else np.zeros(1, int)
        if per_grp.max(initial=0) <= cap_steps or gb <= gb_min \
                or p.get("gb_fix"):
            break
        gb = max((gb // 2) // kblk * kblk, gb_min)
    p_oh = p_oh_eff
    grows_pad = grows2 + pads
    h2 = int(grows_pad.sum())
    n_steps = h2 // t2
    assert n_steps == len(st_base), (n_steps, len(st_base))

    gstart = np.concatenate([[0], np.cumsum(grows_pad)[:-1]])
    wstart2 = np.concatenate([[0], np.cumsum(grows2)[:-1]])
    gidx = np.repeat(hm.arange(len(grows2)), grows2)
    final2 = gstart[gidx] + (hm.arange(len(sizes2)) - wstart2[gidx])

    # windows: chunk-local product-row base, clamped into the block
    base_loc = bases2 - grp_chunk[gidx] * p1
    base_loc = np.minimum(np.maximum(base_loc, 0), max(p1 - m2, 0))
    win2 = hm.zeros(h2, np.int32)
    win2[final2] = base_loc.astype(np.int32)

    # sig: per stream row, band base block − step base block
    sig_row = hm.zeros(h2, np.int8)
    sig_val = grp_band_blk[gidx] - st_base[final2 // t2]
    assert sig_val.min(initial=0) >= 0 and \
        sig_val.max(initial=0) <= p_oh - kblk, \
        "xch4: stream row band outside its step's p_oh window"
    sig_row[final2] = sig_val.astype(np.int8)

    # within-stream-row sort by (row, src): run contiguity
    sr2_0 = final2[np.repeat(hm.arange(len(sizes2)), sizes2)]
    o3 = hm.argsort_keys(sr2_0 * np.int64(coo.n_row + 1) + rows_s)
    src_f, rows_f, sr2 = src_s[o3], rows_s[o3], sr2_0[o3]
    new_row = np.concatenate([[True], sr2[1:] != sr2[:-1]])
    rstart = np.flatnonzero(new_row)
    li2 = hm.arange(nnz) - rstart[np.cumsum(new_row) - 1]

    lane2 = hm.zeros((h2, LANES), np.int8)
    sub2 = hm.zeros((h2, LANES), np.int8)
    hm2 = hm.zeros((h2, LANES), np.int8)
    src_row = src_f >> 7
    chunk_f = st_cs[sr2 // t2]
    hm.scatter2d(lane2, sr2, li2, (src_f & (LANES - 1)).astype(np.int8))
    hm.scatter2d(sub2, sr2, li2,
                 (src_row - chunk_f * p1 - win2[sr2]).astype(np.int8))

    new_run = hm.zeros(nnz, np.bool_)
    new_run[0] = True
    new_run[1:] = (rows_f[1:] != rows_f[:-1]) | (sr2[1:] != sr2[:-1])
    qpos = sr2 * LANES + li2
    head_q = np.maximum.accumulate(np.where(new_run, qpos, -1))
    hm.scatter2d(hm2, sr2, li2, (head_q - sr2 * LANES - 1).astype(np.int8))

    end = hm.zeros(nnz, np.bool_)
    end[:-1] = new_run[1:]
    end[-1] = True
    r_run, sr_run, e_lane = rows_f[end], sr2[end], li2[end]

    # idx planes: j = run's block − its stream row's band base block
    j_run = (r_run >> 7) - (st_base[sr_run // t2]
                            + sig_row[sr_run].astype(np.int64))
    assert j_run.min(initial=0) >= 0 and j_run.max(initial=0) < kblk, \
        "xch4: run outside its stream row's kblk band"
    l_run = r_run & np.int64(LANES - 1)
    idx2 = hm.full((kblk, h2, LANES), -1, np.int8)
    hm.scatter2d(idx2.reshape(kblk * h2, LANES),
                 j_run * np.int64(h2) + sr_run, l_run,
                 e_lane.astype(np.int8))

    # ---- SMEM-sized kernel calls (cut at out-group changes) ----
    u_gids, gid_inv = np.unique(st_gid, return_inverse=True)
    gid_compact = gid_inv.astype(np.int64)      # compact visited groups
    cz = _chunk_steps(gid_compact, n_steps, len(u_gids),
                      max_steps=max(CHUNK_ROWS // t2, 1))
    g_t, o_t, c_t, w_t, la_t, su_t, hm_t, sg_t, ix_t = \
        [], [], [], [], [], [], [], [], []
    for s0, s1, g0, _ng in cz:
        r0, r1 = s0 * t2, s1 * t2
        g_t.append(_t((gid_compact[s0:s1] - g0).astype(np.int32)))
        o_t.append(_t(
            (st_base[s0:s1] - st_gid[s0:s1] * gb).astype(np.int32)))
        c_t.append(_t(st_cs[s0:s1].astype(np.int32)))
        w_t.append(_t(win2[r0:r1]))
        la_t.append(_t(lane2[r0:r1]))
        su_t.append(_t(sub2[r0:r1]))
        hm_t.append(_t(hm2[r0:r1]))
        sg_t.append(_t(
            np.broadcast_to(sig_row[r0:r1, None], (r1 - r0, LANES)).copy()))
        ix_t.append(_t(idx2[:, r0:r1]))

    # ---- pass-1 call chunks ----
    cz1 = []
    max_rows1 = (PASS1_CALL_ROWS // t1) * t1
    for r0 in range(0, h1, max_rows1):
        cz1.append((r0, min(r0 + max_rows1, h1)))
    w1_t, la1_t, su1_t, va1_t = [], [], [], []
    for r0, r1 in cz1:
        w1_t.append(_t(l1["win1"][r0:r1]))
        la1_t.append(_t(l1["lane1"][r0:r1]))
        su1_t.append(_t(l1["sub1"][r0:r1]))
        va1_t.append(value_tensor(l1["val1"][r0:r1], cfg.dtype))

    cb_tot = cdiv(max(coo.n_col, 1), LANES)
    return with_routes(Xch4State(
        n_row=coo.n_row, n_col=coo.n_col, nnz=nnz_all, m1=m1, m2=m2, t1=t1,
        t2=t2, kblk=kblk, p_oh=p_oh, gb=gb, n_chunks=n_chunks, p1=p1,
        cb_pad=cb_tot + m1, n_slots1=h1 * LANES, n_slots2=h2 * LANES,
        chunk_ngrp=tuple(c[3] for c in cz), long_n=long_n,
        dia_offs=dia_offs,
        win1=tuple(w1_t), lane1=tuple(la1_t), sub1=tuple(su1_t),
        val1=tuple(va1_t),
        gids2=tuple(g_t), off2=tuple(o_t), cs2=tuple(c_t),
        win2=tuple(w_t), lane2=tuple(la_t), sub2=tuple(su_t),
        hm2=tuple(hm_t), sig2=tuple(sg_t), idx2=tuple(ix_t),
        vis_gids=_t(u_gids.astype(np.int32)),
        long=long_state, long_rows=long_rows_dev, dia_vals=dia_vals_dev))


def _empty_state4(coo, cfg):
    dtype = cfg.np_dtype
    z8 = lambda *s: _t(hm.zeros(s, np.int8))
    return with_routes(Xch4State(
        n_row=coo.n_row, n_col=coo.n_col, nnz=0, m1=1, m2=1, t1=8, t2=8,
        kblk=1, p_oh=8, gb=8, n_chunks=1, p1=8, cb_pad=1,
        n_slots1=0, n_slots2=0, chunk_ngrp=(0,), long_n=0,
        win1=(_t(hm.zeros(0, np.int32)),),
        lane1=(z8(0, LANES),), sub1=(z8(0, LANES),),
        val1=(value_tensor(hm.zeros((0, LANES), dtype), cfg.dtype),),
        gids2=(_t(hm.zeros(0, np.int32)),),
        off2=(_t(hm.zeros(0, np.int32)),),
        cs2=(_t(hm.zeros(0, np.int32)),),
        win2=(_t(hm.zeros(0, np.int32)),),
        lane2=(z8(0, LANES),), sub2=(z8(0, LANES),), hm2=(z8(0, LANES),),
        sig2=(z8(0, LANES),),
        idx2=(_t(hm.full((1, 0, LANES), -1, np.int8)),),
        vis_gids=_t(hm.zeros(0, np.int32))))


def estimate_v4(coo: COOMatrix, cfg: Config, no_long: bool = False) -> dict:
    """Closed-form v4 plan: k_slots/kblk/p_oh/gb from the uniform-mix bound,
    long-row split decided from the degree profile."""
    n_r, n_c, nnz = max(coo.n_row, 1), max(coo.n_col, 1), max(coo.nnz, 1)
    if coo.nnz == 0:
        return {"feasible": False, "est_s": 0.0, "route_v": 4}
    if cdiv(n_c, LANES) * LANES * value_size(cfg.dtype) > X_TABLE_CAP:
        return {"feasible": False, "est_s": float("inf"), "route_v": 4}
    # band peel: count the high-fill diagonal mass (cheap bincount) and
    # cost the exchange on the residual only
    peel_nnz, n_offs = 0, 0
    dia_sec = 0.0
    if not no_long and coo.nnz:
        offs_e, mask_e = _peel_bands(hm.astype(coo.row, np.int64),
                                     hm.astype(coo.col, np.int64),
                                     n_r, n_c, nnz)
        if offs_e is not None:
            peel_nnz = int(mask_e.sum())
            n_offs = len(offs_e)
            dia_sec = n_offs * n_r * 8.0 / HBM_BPS
    nnz = max(nnz - peel_nnz, 1)
    deg = nnz / n_r
    # 3-factor balance on K = n_c·n_r/(128·nnz) with the fitted weights.
    # The chunk floor (≥ 384 product rows) keeps the p1-alignment and
    # chunk-cut pads sane — tiny chunks measured pad 1.64× (r5); the
    # residual K/m1_eff is then re-split between m2 and kblk.
    K = max(n_c * n_r / (LANES * nnz), 1.0)
    w1, w2, w3 = SEL_SLOT_S, R4_SEL_S, R4_KBLK_S
    c = (K * w1 * w2 * w3) ** (1.0 / 3.0)
    m1_t = float(np.clip(c / w1, 1.0, M_MAX))
    # pass-1 window m1 = n_c/k_slots blocks (col spread of 128 consecutive
    # (chunk, col)-sorted slots)
    k_slots = int(np.clip(n_c / m1_t, min(nnz, 384 * LANES),
                          P1_CAP_ROWS * LANES))
    k_slots = max(min(k_slots, nnz), 16 * LANES)
    m1_eff = max(n_c / k_slots, 1.0)
    m1 = _align8(int(round(m1_eff)))
    K2 = max(K / m1_eff, 1.0)
    m2_t = float(np.clip(np.sqrt(K2 * w3 / w2), 1.0, M2_CAP))
    kblk = int(2 ** np.clip(round(np.log2(max(K2 / m2_t, 1.0))), 0, 5))
    m2 = _align8(int(round(m2_t)), M2_CAP)
    t2 = 64
    p_oh = int(np.clip(_align8(int(t2 / max(deg, 1.0)) + kblk), 8, 64))
    # call-chunk SMEM cap: stream rows per out group ≈ gb·deg must stay
    # under CHUNK_ROWS (a group cannot split across pallas calls)
    gb = min(X4_GB, max(int(0.7 * CHUNK_ROWS / max(deg, 1.0)) // max(kblk, 1)
                        * max(kblk, 1), 8 * kblk))
    slots1 = 1.12 * nnz
    n_grp_est = nnz / k_slots + n_r / (kblk * LANES)
    slots2 = 1.05 * nnz + n_grp_est * (t2 / 4) * LANES \
        + (n_r / (kblk * LANES)) * 64
    sec = (dia_sec
           + slots1 * _r4_mul_slot_s(m1) + slots1 / LANES / 128 * MUL_FIXED_S
           + slots2 * _r4_route_slot_s(m2, kblk, p_oh)
           + slots2 / LANES / t2 * R4_FIXED_S)
    out = {"feasible": True, "est_s": float(sec), "route_v": 4,
           "k_slots": k_slots, "kblk": kblk,
           "p_oh": p_oh, "gb": gb, "slots": int(slots1 + slots2),
           "m1_hint": m1, "m2_hint": m2}
    # long-row fast-track: K for the compacted long submatrix is tiny
    if not no_long and n_r >= 4096:
        degs = np.bincount(hm.astype(coo.row, np.int64), minlength=n_r)
        # nnz here is already peel-reduced; cap the long mass accordingly
        # (r5 bug: the raw full-matrix long mass made rest_nnz NEGATIVE on
        # dense-row matrices — RM07R's xch estimate read −2.7 ms and auto
        # flipped away from the measured-faster hyb)
        long_nnz = min(int(degs[degs >= LONG_DEG].sum()), nnz - 1)
        if long_nnz >= LONG_MIN_SHARE * nnz:
            n_long = int((degs >= LONG_DEG).sum())
            sub_sec = long_nnz * (_r4_mul_slot_s(1)
                                  + _r4_route_slot_s(8, 2, 8))
            # residual cost: same closed form on the remaining degree mass
            rest_nnz = max(nnz - long_nnz, 1)
            Kr = max(n_c * n_r / (LANES * max(rest_nnz, 1)), 1.0)
            cr = (Kr * w1 * w2 * w3) ** (1.0 / 3.0)
            rest_sec = rest_nnz * 1.15 * (
                _r4_mul_slot_s(_align8(int(cr / w1)))
                + _r4_route_slot_s(_align8(int(np.clip(cr / w2, 1, M2_CAP)),
                                           M2_CAP),
                                   int(np.clip(cr / w3, 1, 32)), p_oh))
            scatter_sec = n_long * 7e-9
            if sub_sec + rest_sec + scatter_sec < sec:
                out["long_deg"] = LONG_DEG
                out["est_s"] = float(sub_sec + rest_sec + scatter_sec)
    out["est_s"] *= 1.15          # closed-form → measured headroom
    return out

def wslot_starts(sizes):
    return np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)


def cdiv_np(a, b):
    return -(-a // b)


def _chunk_steps(uids, n_steps, n_buckets, max_steps=None):
    """Split pass-2 steps into chunks of ≤``max_steps`` (SMEM row cap / t2),
    cutting at new-bucket steps.  Returns [(s0, s1, first_bucket,
    n_buckets_in_chunk)]; the last chunk covers through ``n_buckets`` (with
    span, a trailing bucket may never be a step's first — its block stays
    unwritten; the caller zero-pads the missing trailing buckets)."""
    if n_steps == 0:
        return []
    cap = max_steps if max_steps else n_steps
    if n_steps <= cap:
        return [(0, n_steps, 0, n_buckets)]
    new_b = np.flatnonzero(np.concatenate([[True], uids[1:] != uids[:-1]]))
    cuts = [0]
    while cuts[-1] + cap < n_steps:
        k = np.searchsorted(new_b, cuts[-1] + cap, side="right") - 1
        s = int(new_b[k])
        if s <= cuts[-1]:
            raise ValueError("xch: a single bucket exceeds the step cap")
        cuts.append(s)
    cuts.append(n_steps)
    out = []
    for i in range(len(cuts) - 1):
        s0, s1 = cuts[i], cuts[i + 1]
        u0 = int(uids[s0])
        u_next = int(uids[s1]) if s1 < n_steps else n_buckets
        out.append((s0, s1, u0, u_next - u0))
    return out


def estimate(coo: COOMatrix, cfg: Config) -> dict:
    """The reference's v4 plan; the v3 σ-plane engine is reached through
    ``plan=estimate_v3(coo, cfg) | {"route_v": 3}``."""
    return estimate_v4(coo, cfg)


def convert(coo: COOMatrix, cfg: Config, plan: dict = None):
    """Build the layout on the host, v4 (``Xch4State``) or, where the plan
    says ``route_v`` 3, v3 (``XchState``); tensors come back on the CPU."""
    check_dtype("xch", cfg.dtype)
    if coo.nnz == 0 or coo.n_row == 0:
        return _empty_state4(coo, cfg)
    p = plan or estimate(coo, cfg)
    if not p.get("feasible", True):
        raise ValueError("xch: infeasible (x table exceeds VMEM cap)")
    if p.get("route_v", 4) == 3:
        return _convert_v3(coo, cfg, p)
    return _convert_v4(coo, cfg, p)


ROUTE_FIELDS = ("base2", "dest2", "merge2", "val2", "col2")
DEST_NONE = -1
MERGE_HITS = 4.0     # run ends a y row a block, from which a block merges


def _rows_per_block(t2: int) -> int:
    """The merge kernel's rows a block: the largest power of two up to 32
    that divides t2 (``csrc/stream_row.cuh:rows_per_block``)."""
    r = 32
    while t2 % r:
        r //= 2
    return r


def route_rows(state) -> dict:
    """{base2, dest2, merge2, val2, col2}: the run-end destination stream of
    the spmv route, from the reference's arrays of ``state`` (``gids2``,
    ``off2``, ``sig2``, ``idx2``, ``vis_gids``, ``chunk_ngrp``, ``gb``,
    ``p_oh``, ``kblk``, ``t2``, ``n_row``, ``val1``; CPU tensors or numpy
    arrays), and the products' stream in pass 2's order (``stream_rows``).
    Per pass-2 call, ``base2`` is one int32 a step, the y position of the
    step's out row 0, (vis_gids[g0 + gids] · gb + off) · 128, and ``dest2``
    an (H, 128) int16 that holds, at the slot e that ends a run, the run's
    position relative to its step's base, (sig + j) · 128 + l where
    idx2[j, r, l] == e, and −1 on every other slot.

    The reference's placement is kept exactly: a position only where
    0 ≤ sig + j < p_oh (what the TPU's one-hot keeps), none of a step whose
    call-local base gids · gb + off is negative, none past n_grp · gb rows
    of its call or past n_row in y.  Raises ValueError on an end lane named
    twice across a row's planes, and on a position that leaves its step's
    out group (off + sig + j outside [0, gb)), which the reference's
    off + p_oh ≤ gb rules out; so a relative position fits int16
    (p_oh · 128 ≤ 8192).

    ``merge2`` is what the route kernel can observe of the stream: where a
    block's rows end on average at least ``MERGE_HITS`` runs on each y row
    of their kblk · 128 (the nested long-row states: many stream rows end
    runs of the same few rows) and eight (p_oh · 128) spans of the value
    type fit in the merge kernel's shared memory, the span p_oh · 128,
    which has a block sum its rows' run totals there before adding into y;
    else 0, a reduction into y a run end."""
    vis = np.asarray(state.vis_gids).astype(np.int64)
    gb, p_oh, t2 = state.gb, state.p_oh, state.t2
    bases, dests, g0, n_ends = [], [], 0, 0
    for gids, off, sig, idx, ng in zip(state.gids2, state.off2, state.sig2,
                                       state.idx2, state.chunk_ngrp):
        gids = np.asarray(gids).astype(np.int64)
        off = np.asarray(off).astype(np.int64)
        sig = np.asarray(sig)[:, 0].astype(np.int64)   # lane-replicated
        idx = np.asarray(idx)
        live = (gids >= 0) & (gids < ng) & (gids * gb + off >= 0)
        vrow = vis[g0 + np.where(live, gids, 0)] * gb + off if ng else off
        base = np.where(live, vrow, 0) * LANES
        if base.max(initial=0) >= 2 ** 31 - p_oh * LANES:
            raise ValueError("xch: a y position past int32")
        dest = np.full((idx.shape[1], LANES), DEST_NONE, np.int16)
        n_kept = 0
        for j in range(idx.shape[0]):
            rr, ll = np.nonzero(idx[j] >= 0)
            blk = sig[rr] + j
            keep = (blk >= 0) & (blk < p_oh)
            rr, ll, blk = rr[keep], ll[keep], blk[keep]
            t = rr // t2
            in_grp = off[t] + blk
            if ((in_grp < 0) | (in_grp >= gb)).any():
                raise ValueError("xch: a run's out row leaves its step's "
                                 "out group (off + sig + j outside [0, gb))")
            rel = blk * LANES + ll
            placed = live[t] & (base[t] + rel < state.n_row)
            dest[rr, idx[j][rr, ll]] = np.where(placed, rel, -2)
            n_kept += len(rr)
        if np.count_nonzero(dest != DEST_NONE) != n_kept:
            raise ValueError("xch: an end lane is named twice in a stream "
                             "row's idx planes")
        dest[dest == -2] = DEST_NONE
        bases.append(_t(base.astype(np.int32)))
        dests.append(_t(dest))
        g0 += ng
        n_ends += n_kept
    span = p_oh * LANES
    blocks = sum(d.shape[0] for d in dests) / _rows_per_block(t2)
    hits = n_ends / max(blocks, 1) / (state.kblk * LANES)
    vsz = acc_dtype(state.val1[0].dtype).itemsize    # the spans' sums
    merge = hits >= MERGE_HITS and 8 * span * vsz <= MERGE_SMEM
    return dict(base2=tuple(bases), dest2=tuple(dests),
                merge2=span if merge else 0, **stream_rows(state))


def _cat(parts, axis=0):
    """The per-call host arrays (CPU tensors or numpy arrays) of a field,
    concatenated into one numpy array."""
    return np.concatenate([np.asarray(a) for a in parts], axis=axis)


def _host_cat(parts, axis=0):
    """The per-call tensors of a field, on any device, concatenated into
    one numpy array (bfloat16 as float32)."""
    return np.concatenate([to_host(a) for a in parts], axis=axis)


def _values(parts, lo=None) -> torch.Tensor:
    """The per-call values ``val1``, flat, as one CPU tensor of their type
    (numpy arrays too, the reference's bfloat16 among them); with ``lo``,
    the reference's df64 lo planes, hi + lo in float64, as
    ``state_from_reference`` folds them."""
    if lo is not None:
        return torch.from_numpy(np.concatenate([
            np.asarray(h, np.float64).reshape(-1)
            + np.asarray(l_, np.float64).reshape(-1)
            for h, l_ in zip(parts, lo)]))
    return torch.cat([(a if isinstance(a, torch.Tensor)
                       else from_numpy(np.asarray(a))).reshape(-1)
                      for a in parts])


def stream_rows(state) -> dict:
    """{val2, col2}: per pass-2 call, the value and the x position of the
    pass-1 slot whose product pass 2's route reads at each of its slots,
    padding slots included, so that val2 · x[col2] is the product there,
    product for product.

    Each nonzero has one pass-1 slot and one pass-2 slot; pass 2 reads, at
    slot (r, l) of step t, the product of pass-1 slot
    P = (cs2[t] · p1 + win2[r] + sub2[r, l]) · 128 + lane2[r, l] (sub2
    unread at m2 1), which pass 1 made from val1[P] and x position
    (win1[P / 128] + sub1[P]) · 128 + lane1[P] (sub1 unread at m1 1).  A
    position at or past n_col lies in the x table's zero padding: its slot
    gets col2 0 and val2 0, and a nonzero val1 there raises ValueError (its
    product would drop a value).  Raises ValueError on a P outside the
    product grid.  int64 index arithmetic, one call at a time.  A
    reference df64 state's values are its hi + lo planes (``val1_lo``)."""
    t2, p1, m1, m2 = state.t2, state.p1, state.m1, state.m2
    n_col = state.n_col
    val1 = _values(state.val1, getattr(state, "val1_lo", None))
    if not state.n_slots1:
        rows = [np.asarray(la).shape[0] for la in state.lane2]
        return dict(val2=tuple(val1.new_zeros(h, LANES) for h in rows),
                    col2=tuple(torch.zeros(h, LANES, dtype=torch.int32)
                               for h in rows))
    win1 = _cat(state.win1).astype(np.int64)
    lane1 = _cat(state.lane1).reshape(-1)
    sub1 = _cat(state.sub1).reshape(-1) if m1 > 1 else None
    n1 = val1.numel()
    vals, cols = [], []
    for cs, win, lane, sub in zip(state.cs2, state.win2, state.lane2,
                                  state.sub2):
        lane = np.asarray(lane).astype(np.int64)
        h = lane.shape[0]
        row = (np.asarray(cs).astype(np.int64)[np.arange(h) // t2] * p1
               + np.asarray(win).astype(np.int64))              # (h,)
        P = row[:, None] * LANES + lane
        if m2 > 1:
            P += np.asarray(sub).astype(np.int64) * LANES
        if h and (P.min() < 0 or P.max() >= n1):
            raise ValueError("xch: a pass-2 slot reads outside the product "
                             "grid")
        P = P.reshape(-1)
        col = (win1[P >> 7] * LANES + lane1[P]).astype(np.int64)
        if sub1 is not None:
            col += sub1[P].astype(np.int64) * LANES
        val = val1[torch.from_numpy(P)]
        pad = col >= n_col
        if pad.any():
            pad_t = torch.from_numpy(pad)
            if bool((val[pad_t] != 0).any()):
                raise ValueError("xch: a nonzero value reads x past n_col "
                                 "(the x table's zero padding)")
            val[pad_t] = 0
            col[pad] = 0
        vals.append(val.reshape(h, LANES))
        cols.append(_t(col.astype(np.int32).reshape(h, LANES)))
    return dict(val2=tuple(vals), col2=tuple(cols))


def adds_per_row(state) -> np.ndarray:
    """(n_row,) int64: the run totals ``spmv`` adds into each y row, one a
    run end of pass 2's ``dest2`` streams, and the nested long-row state's
    at its rows.  On the card their order of addition is free
    (``core/oracle.py:reorder_bound``).  The peeled bands add in a fixed
    order after them, one more term on each row they touch: y = fl(s + d)
    rounds once more, by an amount that moves with s.  A v3 state's are
    its σ-plane run ends (``_v3_run_ends``)."""
    if isinstance(state, XchState):
        rows = _v3_run_ends(state)[0]
        return np.bincount(rows[rows < state.n_row], minlength=state.n_row)
    k = np.zeros(state.n_row, np.int64)
    if state.dia_vals is not None:
        k += (to_host(state.dia_vals) != 0).any(axis=0)
    if state.n_slots1:
        for b, d in zip(state.base2, state.dest2):
            d, b = to_host(d).astype(np.int64), to_host(b).astype(np.int64)
            r, lane = np.nonzero(d >= 0)
            pos = b[r // state.t2] + d[r, lane]
            k += np.bincount(pos[pos < state.n_row], minlength=state.n_row)
    if state.long is not None:
        k[to_host(state.long_rows).astype(np.int64)] += \
            adds_per_row(state.long)
    return k


def with_routes(state: Xch4State) -> Xch4State:
    """``state`` with its ``base2``, ``dest2``, ``merge2``, ``val2`` and
    ``col2`` from ``route_rows``."""
    return dataclasses.replace(state, **route_rows(state))


_ARRAY_FIELDS = ("win1", "lane1", "sub1", "val1", "gids2", "off2", "cs2",
                 "win2", "lane2", "sub2", "hm2", "sig2", "idx2", "vis_gids",
                 "long_rows", "dia_vals")


def state_from_reference(arrays: dict):
    """The port's state from the fields of a reference ``Xch4State``, or
    of a reference v3 ``XchState`` (the fields hold ``bucket_ids``): an
    ``XchState`` with the reference's own arrays.

    ``arrays`` maps field names to numpy arrays (per-call tuples stay
    tuples) and scalars, as ``dataclasses.asdict`` of a reference state
    moved to the host gives them; ``long`` is such a dict in turn.  A df64
    state's (hi, lo) float32 planes fold into float64: ``val1 = val1 +
    val1_lo`` and ``dia_vals = dia_vals + dia_lo``."""
    if "bucket_ids" in arrays:
        kw = {}
        for f in dataclasses.fields(XchState):
            v = arrays.get(f.name)
            if isinstance(v, (tuple, list)) and v and hasattr(v[0], "shape"):
                v = tuple(from_numpy(np.array(a)) for a in v)
            elif hasattr(v, "shape"):
                v = from_numpy(np.array(v))
            kw[f.name] = v
        state = XchState(**kw)
        for v in state.val1:
            check_dtype("xch", v.dtype)
        return state
    arrays = dict(arrays)
    if arrays.get("val1_lo") is not None:
        arrays["val1"] = tuple(
            np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
            for hi, lo in zip(arrays["val1"], arrays["val1_lo"]))
    if arrays.get("dia_lo") is not None:
        arrays["dia_vals"] = (np.asarray(arrays["dia_vals"], np.float64)
                              + np.asarray(arrays["dia_lo"], np.float64))
    kw = {}
    for f in dataclasses.fields(Xch4State):
        if f.name in ROUTE_FIELDS:     # derived below, not the reference's
            continue
        v = arrays.get(f.name)
        if f.name == "long" and v is not None:
            v = state_from_reference(v)
        elif f.name in _ARRAY_FIELDS and v is not None:
            v = tuple(from_numpy(np.array(a)) for a in v) \
                if isinstance(v, (tuple, list)) \
                else from_numpy(np.array(v))
        kw[f.name] = v
    state = Xch4State(**kw)
    for v in state.val1:
        check_dtype("xch", v.dtype)
    return with_routes(state)


# -------------------------------------------------------------------- spmv ---

def x_table(state: Xch4State, x: torch.Tensor) -> torch.Tensor:
    """Pass 1's (cb_pad, 128) x table: x zero-padded to whole windows.  For
    a panel X (n_col, B), the interleaved (cb_pad, 128, B) panel: X
    zero-padded, each x row's B values contiguous as in X."""
    xp = torch.zeros((state.cb_pad * LANES,) + x.shape[1:], dtype=x.dtype,
                     device=x.device)
    xp[: state.n_col] = x
    return xp.view((state.cb_pad, LANES) + x.shape[1:])


def products(state: Xch4State, xp: torch.Tensor) -> torch.Tensor:
    """Pass 1: one ``xch_mul`` per call, each writing its rows of one
    (n_chunks, p1, 128) product grid."""
    rows = sum(w.shape[0] for w in state.win1)
    if rows != state.n_chunks * state.p1:
        raise ValueError(f"xch: {rows} pass-1 rows do not fill "
                         f"{state.n_chunks} chunks of {state.p1}")
    prod = torch.empty(rows, LANES, dtype=xp.dtype, device=xp.device)
    r0 = 0
    for w, la, su, va in zip(state.win1, state.lane1, state.sub1, state.val1):
        r1 = r0 + w.shape[0]
        xch_mul(w, la, su, va, xp, state.m1, state.t1, out=prod[r0:r1])
        r0 = r1
    return prod.view(state.n_chunks, state.p1, LANES)


def _check_x(state: Xch4State, x: torch.Tensor):
    if x.dtype != state.val1[0].dtype:
        raise TypeError(f"xch: x is {x.dtype}, the state holds "
                        f"{state.val1[0].dtype} values")


def _mul_phase4(state: Xch4State, x: torch.Tensor) -> torch.Tensor:
    """Phase Mul: the x table and pass 1, the (n_chunks, p1, 128) product
    grid."""
    _check_x(state, x)
    return products(state, x_table(state, x))


def _route_phase4(state: Xch4State, prod3: torch.Tensor) -> torch.Tensor:
    """Phase Sum: pass 2, each ``xch_route4_rows`` call adding its run
    totals into one zeroed y of n_row, of the accumulator type (float32
    for a bfloat16 grid)."""
    y = torch.zeros(state.n_row, dtype=acc_dtype(prod3.dtype),
                    device=prod3.device)
    for b, c, w, la, su, h2, d in zip(
            state.base2, state.cs2, state.win2, state.lane2, state.sub2,
            state.hm2, state.dest2):
        xch_route4_rows(b, c, w, la, su, h2, d, prod3, y, state.m2,
                        state.t2, state.merge2)
    return y


def phases(state):
    """Mul/Sum split for the driver's MulPerf/SumPerf report keys (the
    reference's ``formats/xch.py:2171-2178``): the reference's two passes,
    pass 1 writing the product grid and pass 2 routing it, where the v4
    ``spmv`` runs both in one fused launch a pass-2 call.  None where a
    nested long-row state holds rows (the Sum phase would need x) or pass 1
    has no slot.  As in the reference, the phases leave out the peeled
    bands (``_dia_part``): on a state with a peel, Sum's time leaves out
    the peel's (ROADMAP C.10).  A v3 state's are its spmv's own two
    phases."""
    if isinstance(state, XchState):
        return {"Mul": _mul_phase, "Sum": _route_phase}
    if state.long is not None or state.n_slots1 == 0:
        return None
    return {"Mul": _mul_phase4, "Sum": _route_phase4}


def _check_v3(state: XchState, x: torch.Tensor):
    _check_x(state, x)
    if x.dtype == torch.float64:
        raise TypeError("xch: the v3 σ-plane engine runs float32 and "
                        "bfloat16 values, as the reference's kernels did on "
                        "its chip; float64 runs the v4 engine (the default "
                        "plan)")


def _mul_phase(state: XchState, x: torch.Tensor) -> torch.Tensor:
    """v3 phase Mul: the zero-padded (cb_pad, 128) x table, then one
    ``xch_mul`` a pass-1 call, each writing its rows of one
    (n_chunks, p1, 128) product grid of x's type."""
    _check_v3(state, x)
    return products(state, x_table(state, x))


def _route_phase(state: XchState, prod3: torch.Tensor) -> torch.Tensor:
    """v3 phase Sum: one ``xch_route`` a pass-2 call, each returning the
    σ planes of its G-groups of compact buckets (float32, the accumulator
    of either type), then the reference's assembly (``place_buckets``).
    No value is read back to the host."""
    op = state.span * state.planes          # out planes a bucket slot
    sg0s = state.sg0_2 or tuple(torch.zeros_like(u) for u in state.uids2)
    sg1s = state.sg1_2 or tuple(torch.full_like(u, op - 1)
                                for u in state.uids2)
    outs = [xch_route(u, g, c, s0, s1, w, la, su, h2, ix, prod3, ngb,
                      state.m2, op, state.t2, G_GRP)
            for u, g, c, s0, s1, w, la, su, h2, ix, ngb in zip(
                state.uids2, state.gids2, state.cs2, sg0s, sg1s,
                state.win2, state.lane2, state.sub2, state.hm2,
                state.idx2, state.chunk_nb)]
    return place_buckets(state, outs[0] if len(outs) == 1
                         else torch.cat(outs, 0))


def place_buckets(state: XchState, out: torch.Tensor) -> torch.Tensor:
    """y from the v3 route's out rows (the calls' (ngb·G_GRP·span·planes,
    128) outs in order), as the reference assembles it: zero rows for
    trailing buckets that begin no step, at span 2 the overlap-add (slot
    b's high half is compact bucket b + 1's), each compact bucket's
    ``planes`` · 128 rows placed at its bucket id, cut to n_row."""
    scope = state.planes * LANES
    nbk = out.shape[0] // (state.span * state.planes)  # G-padded slots
    out3 = out.view(nbk, state.span, scope)
    if nbk < state.n_buckets:               # trailing never-first buckets
        out3 = torch.cat([out3, out3.new_zeros(
            state.n_buckets - nbk, state.span, scope)], 0)
    out3 = out3[: state.n_buckets]
    yb = out3[:, 0]
    if state.span == 2:
        yb = yb.clone()
        yb[1:] += out3[:-1, 1]
    y2 = out3.new_zeros(cdiv(max(state.n_row, 1), scope), scope)
    y2.index_copy_(0, state.bucket_ids.long(), yb)
    return y2.view(-1)[: state.n_row]


def _spmv_v3(state: XchState, x: torch.Tensor) -> torch.Tensor:
    _check_v3(state, x)
    if state.nnz == 0 or state.n_buckets == 0:
        return torch.zeros(state.n_row, dtype=acc_dtype(x.dtype),
                           device=x.device)
    return _route_phase(state, _mul_phase(state, x))


def _fused_part(state: Xch4State, x: torch.Tensor) -> torch.Tensor:
    """The exchange's y: one ``xch_fused_rows`` a pass-2 call."""
    y = torch.zeros(state.n_row, dtype=acc_dtype(x.dtype), device=x.device)
    if state.n_slots1:
        for b, v, c, h2, d in zip(state.base2, state.val2, state.col2,
                                  state.hm2, state.dest2):
            xch_fused_rows(b, v, c, h2, d, x, y, state.t2, state.merge2)
    return y


def _pair_part(state: Xch4State, x: torch.Tensor) -> torch.Tensor:
    """The exchange's y as the pair makes it: Mul, then Sum."""
    if state.n_slots1:
        return _route_phase4(state, _mul_phase4(state, x))
    return torch.zeros(state.n_row, dtype=acc_dtype(x.dtype),
                       device=x.device)


def _spmv_acc(state: Xch4State, x: torch.Tensor,
              part=_fused_part) -> torch.Tensor:
    y = part(state, x)
    if state.long is not None:
        # long_rows are distinct, so the add is a plain scatter-add
        y.index_add_(0, state.long_rows.long(),
                     _spmv_acc(state.long, x, part))
    if state.dia_vals is not None:
        y = y + _dia_part(state, x)
    return y


def spmv_acc(state, x: torch.Tensor) -> torch.Tensor:
    """y = A x in the accumulator type (float32 for bfloat16 values): a v4
    state's fused route, or a v3 state's two phases (``TypeError`` at
    float64, as the reference's)."""
    if isinstance(state, XchState):
        return _spmv_v3(state, x)
    _check_x(state, x)
    return _spmv_acc(state, x)


def pair_spmv_acc(state: Xch4State, x: torch.Tensor) -> torch.Tensor:
    """``spmv_acc`` as the pair computes it, the spmv before the fused
    route: on the state and each nested state the phases' Mul
    (``xch_mul`` writing the product grid) and Sum (``xch_route4_rows``
    routing it), then the long rows and the peeled bands.  The same
    products and run totals, added in another order: the card's checks
    hold the fused spmv to it within each row's reorder bound."""
    _check_x(state, x)
    return _spmv_acc(state, x, _pair_part)


def spmv(state, x: torch.Tensor) -> torch.Tensor:
    """y = A x, rounded once to x's type."""
    return spmv_acc(state, x).to(x.dtype)


def _dia_part(state: Xch4State, x: torch.Tensor) -> torch.Tensor:
    """Peeled bands: one static shifted slice of x per offset.  x may be a
    panel (n_col, B): each column sums the same products in the same
    order."""
    n = state.n_row
    offs = state.dia_offs
    mmax = max(max(abs(o) for o in offs), 1)
    xp = torch.zeros((max(n, state.n_col) + 2 * mmax,) + x.shape[1:],
                     dtype=x.dtype, device=x.device)
    xp[mmax: mmax + state.n_col] = x
    out = torch.zeros((n,) + x.shape[1:], dtype=acc_dtype(x.dtype),
                      device=x.device)
    vals = acc(state.dia_vals).view(state.dia_vals.shape
                                    + (1,) * (x.dim() - 1))
    xp = acc(xp)
    for k, d in enumerate(offs):
        out.addcmul_(vals[k], xp[mmax + d: mmax + d + n])
    return out


PANEL_B_MAX = 16           # the reference's panel gate (its xch.py:2188)


def spmm_acc(state, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X, X (n_col, B), in the accumulator type (float32 for
    bfloat16 values): for a v3 state the column loop of ``spmv_acc``, as
    the reference's ``vmap``; for a v4 state the reference's panel path (its
    ``formats/xch.py:2182``).  With 2 ≤ B ≤ ``PANEL_B_MAX``, pass-1 slots,
    a float32 or bfloat16 panel (``PANEL_TYPES``, the TPU's) and B x tables
    within ``X_TABLE_CAP`` (at X's own 4 or 2 bytes a value), the panel
    kernels read the index streams once for all B columns; otherwise the
    column loop of ``spmv_acc``.  The gates are the reference's, the TPU's
    x-table cap included (ROADMAP A.7b sheds it)."""
    if X.dtype != state.val1[0].dtype:
        raise TypeError(f"xch: X is {X.dtype}, the state holds "
                        f"{state.val1[0].dtype} values")
    n_cols = X.shape[1]
    if isinstance(state, XchState):    # the reference's vmap of spmv
        return column_loop(spmv_acc, state, X)
    if (2 <= n_cols <= PANEL_B_MAX and state.n_slots1
            and X.dtype in PANEL_TYPES
            and n_cols * state.cb_pad * LANES * X.element_size()
            <= X_TABLE_CAP):
        return _spmm_panel_v4(state, X)
    return column_loop(spmv_acc, state, X)


def spmm(state, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X, X (n_col, B), rounded once to X's type: the route's
    out groups, the nested long-row state's Y and the peeled bands are
    added in the accumulator type first, as ``spmv`` adds them."""
    return spmm_acc(state, X).to(X.dtype)


def _spmm_panel_v4(state: Xch4State, X: torch.Tensor) -> torch.Tensor:
    """Both passes over the panel, the visited out groups placed into Y,
    then the nested long-row state's ``spmm_acc`` at ``long_rows`` and the
    peeled bands, all in the accumulator type."""
    n, n_cols = state.n_row, X.shape[1]
    xp = x_table(state, X)
    prods = [xch_mul_panel(w, la, su, va, xp, state.m1, state.t1)
             for w, la, su, va in zip(state.win1, state.lane1, state.sub1,
                                      state.val1)]
    prod = prods[0] if len(prods) == 1 else torch.cat(prods, 0)
    prod4 = prod.view(state.n_chunks, state.p1, LANES, n_cols)
    outs = [xch_route4_panel(g, o, c, w, la, su, h2, sg, ix, prod4, ng,
                             state.gb, state.m2, state.t2, state.p_oh)
            for g, o, c, w, la, su, h2, sg, ix, ng in zip(
                state.gids2, state.off2, state.cs2, state.win2, state.lane2,
                state.sub2, state.hm2, state.sig2, state.idx2,
                state.chunk_ngrp)]
    out = outs[0] if len(outs) == 1 else torch.cat(outs, 0)
    # out rows are Y's (row, B) layout: the groups drop into place
    n_grp_tot = cdiv(cdiv(max(n, 1), LANES), state.gb)
    yg = torch.zeros(n_grp_tot, state.gb * LANES, n_cols, dtype=out.dtype,
                     device=X.device)
    yg[state.vis_gids.long()] = out.view(-1, state.gb * LANES, n_cols)
    Y = yg.view(-1, n_cols)[:n]
    if state.long is not None:
        Y.index_add_(0, state.long_rows.long(), spmm_acc(state.long, X))
    if state.dia_vals is not None:
        Y += _dia_part(state, X)
    return Y


# ----------------------------------------------------------------- reports ---

def report_fields(state, cfg: Config) -> dict:
    if isinstance(state, XchState):
        return {"Window1Blocks": state.m1, "Window2Blocks": state.m2,
                "RoutePlanes": state.planes, "Span": state.span,
                "Chunks": state.n_chunks, "RouteV": 3,
                "PadFactor": round((state.n_slots1 + state.n_slots2)
                                   / max(2 * state.nnz, 1), 3)}
    out = {"Window1Blocks": state.m1, "Window2Blocks": state.m2,
           "KBlk": state.kblk, "POh": state.p_oh, "T2": state.t2,
           "Chunks": state.n_chunks, "RouteV": 4,
           "PadFactor": round((state.n_slots1 + state.n_slots2)
                              / max(2 * (state.nnz - _long_nnz(state)
                                         - _peel_nnz(state)), 1), 3)}
    if state.dia_offs:
        out["PeelOffs"] = len(state.dia_offs)
        out["PeelNnz"] = _peel_nnz(state)
    if state.long is not None:
        out["LongRows"] = state.long_n
        out["LongPad"] = round(
            (state.long.n_slots1 + state.long.n_slots2)
            / max(2 * state.long.nnz, 1), 3)
    return out


def _long_nnz(state: Xch4State) -> int:
    return state.long.nnz if state.long is not None else 0


def _peel_nnz(state: Xch4State) -> int:
    dv = state.dia_vals
    return int(torch.count_nonzero(dv)) if dv is not None else 0


def traffic_bytes(state, cfg: Config) -> int:
    vsz = value_size(cfg.dtype)
    if isinstance(state, XchState):
        pass1 = state.n_slots1 * (vsz + 2) + state.n_slots1 * 4
        pass2 = state.n_slots2 * (3 + state.planes) + state.n_slots1 * 4
        return (pass1 + pass2 + state.n_row * vsz
                + state.cb_pad * LANES * vsz)
    pass1 = state.n_slots1 * (vsz + 2) + state.n_slots1 * 4
    pass2 = state.n_slots2 * (4 + state.kblk) + state.n_slots1 * 4
    tot = (pass1 + pass2 + state.n_row * vsz
           + state.cb_pad * LANES * vsz
           + len(state.dia_offs) * state.n_row * 2 * vsz)
    if state.long is not None:
        tot += traffic_bytes(state.long, cfg)
    return tot


def _to_coo_v4(state: Xch4State) -> COOMatrix:
    """Host-side inverse of the v4 layout."""
    cat = lambda t, ax=0: np.concatenate(  # noqa: E731
        [to_host(a) for a in t], axis=ax)
    parts = []
    if state.dia_vals is not None:
        dv = to_host(state.dia_vals).astype(np.float64)
        for k, d in enumerate(state.dia_offs):
            rr = np.flatnonzero(dv[k] != 0)
            parts.append((rr.astype(np.int64), rr + d, dv[k][rr]))
    if state.long is not None:
        sub = _to_coo_v4(state.long)
        lr = state.long_rows.cpu().numpy().astype(np.int64)
        parts.append((lr[sub.row.astype(np.int64)], sub.col, sub.val))
    if state.n_slots1:
        lane1 = cat(state.lane1).astype(np.int64)
        sub1 = cat(state.sub1).astype(np.int64)
        val1 = cat(state.val1).astype(np.float64)
        win1 = cat(state.win1).astype(np.int64)
        cols_grid = (win1[:, None] + sub1) * LANES + lane1

        lane2 = cat(state.lane2).astype(np.int64)
        sub2 = cat(state.sub2).astype(np.int64)
        win2 = cat(state.win2).astype(np.int64)
        hm2 = cat(state.hm2).astype(np.int64)
        sig2 = cat(state.sig2).astype(np.int64)[:, 0]
        idx2 = cat(state.idx2, ax=1).astype(np.int64)
        g_base = np.cumsum([0] + list(state.chunk_ngrp[:-1]))
        gids = np.concatenate([g.cpu().numpy().astype(np.int64) + b
                               for g, b in zip(state.gids2, g_base)])
        offs = cat(state.off2).astype(np.int64)
        cs = cat(state.cs2).astype(np.int64)
        vis = state.vis_gids.cpu().numpy().astype(np.int64)
        h2 = lane2.shape[0]
        t2 = state.t2
        step_of = np.repeat(np.arange(h2 // t2), t2)
        base_blk = vis[gids[step_of]] * state.gb + offs[step_of]  # per sr

        rows = np.full((h2, LANES), -1, np.int64)
        for j in range(state.kblk):
            e = idx2[j]
            valid = e >= 0
            sr_i, l_i = np.nonzero(valid)
            end_lane = e[sr_i, l_i]
            rr = (base_blk[sr_i] + sig2[sr_i] + j) * LANES + l_i
            rows[sr_i, end_lane] = rr
        for jl in range(LANES - 2, -1, -1):
            unset = rows[:, jl] < 0
            same_run = hm2[:, jl + 1] != jl
            rows[same_run & unset, jl] = rows[same_run & unset, jl + 1]

        src_row = cs[step_of][:, None] * state.p1 + win2[:, None] + sub2
        src = src_row * LANES + lane2
        mask = rows >= 0
        src_m = src[mask]
        cols = cols_grid.reshape(-1)[src_m]
        vals = val1.reshape(-1)[src_m]
        keep = vals != 0
        parts.append((rows[mask][keep], cols[keep], vals[keep]))
    if not parts:
        return COOMatrix.from_triplets(state.n_row, state.n_col, [], [], [],
                                       sort=True)
    rows = np.concatenate([p[0] for p in parts])
    cols = np.concatenate([p[1] for p in parts])
    vals = np.concatenate([p[2] for p in parts])
    return COOMatrix.from_triplets(state.n_row, state.n_col, rows, cols,
                                   vals, sort=True)


def _v3_run_ends(state: XchState):
    """(rows, stream rows, end lanes) of a v3 state's σ-plane run ends over
    its pass-2 calls in order, plane by plane: the run whose total ends at
    lane e of stream row r goes to row bucket_ids[u + σ // planes] · scope
    + (σ % planes) · 128 + l of y, where idx2[σ, r, l] == e and u is r's
    step's compact bucket."""
    idx2 = _host_cat(state.idx2, 1).astype(np.int64)
    u_base = np.cumsum([0] + list(state.chunk_nb[:-1])) * G_GRP
    uids = np.concatenate([to_host(u).astype(np.int64) + b
                           for u, b in zip(state.uids2, u_base)])
    bucket_ids = to_host(state.bucket_ids).astype(np.int64)
    scope = state.planes * LANES
    rows, srs, ends = [], [], []
    for sigma in range(idx2.shape[0]):
        sr_i, l_i = np.nonzero(idx2[sigma] >= 0)
        cb = uids[sr_i // state.t2] + sigma // state.planes
        rows.append(bucket_ids[cb] * scope
                    + (sigma % state.planes) * LANES + l_i)
        srs.append(sr_i)
        ends.append(idx2[sigma][sr_i, l_i])
    if not rows:
        return (np.zeros(0, np.int64),) * 3
    return tuple(np.concatenate(a).astype(np.int64)
                 for a in (rows, srs, ends))


def _to_coo_v3(state: XchState) -> COOMatrix:
    """Host-side inverse of the v3 layout (the reference's
    ``formats/xch.py:2368``): σ-plane run ends, backward run propagation,
    then each pass-2 slot's (col, val) through the pass-1 grid."""
    lane1 = _host_cat(state.lane1).astype(np.int64)
    if lane1.shape[0] == 0:
        return COOMatrix.from_triplets(state.n_row, state.n_col, [], [], [],
                                       sort=True)
    sub1 = _host_cat(state.sub1).astype(np.int64)
    val1 = _host_cat(state.val1).astype(np.float64)
    win1 = _host_cat(state.win1).astype(np.int64)
    cols_grid = (win1[:, None] + sub1) * LANES + lane1    # (H1, 128)

    lane2 = _host_cat(state.lane2).astype(np.int64)
    sub2 = _host_cat(state.sub2).astype(np.int64)
    win2 = _host_cat(state.win2).astype(np.int64)
    hm2 = _host_cat(state.hm2).astype(np.int64)
    cs = _host_cat(state.cs2).astype(np.int64)
    h2 = lane2.shape[0]
    step_of = np.repeat(np.arange(h2 // state.t2), state.t2)
    rows = np.full((h2, LANES), -1, np.int64)
    rr, sr, end = _v3_run_ends(state)
    rows[sr, end] = rr
    for j in range(LANES - 2, -1, -1):
        unset = rows[:, j] < 0
        same_run = hm2[:, j + 1] != j
        rows[same_run & unset, j] = rows[same_run & unset, j + 1]

    src_row = cs[step_of][:, None] * state.p1 + win2[:, None] + sub2
    src = src_row * LANES + lane2
    mask = rows >= 0
    src_m = src[mask]
    cols = cols_grid.reshape(-1)[src_m]
    vals = val1.reshape(-1)[src_m]
    keep = vals != 0
    return COOMatrix.from_triplets(
        state.n_row, state.n_col,
        rows[mask][keep], cols[keep], vals[keep], sort=True)


def to_coo(state) -> COOMatrix:
    """Host-side inverse: recover (row, col, val) from the layout."""
    if isinstance(state, XchState):
        return _to_coo_v3(state)
    return _to_coo_v4(state)


def attainable_seconds(state, cfg: Config) -> float:
    """The reference's fitted v4 rate model at the state's own (m1, m2,
    kblk, p_oh, t) and padded slot counts, with band and y traffic at the
    state's value size.  Its rates and ``hbm_bps`` are TPU v5e constants
    (``chipconst``), which hold no H100 measurement yet (ROADMAP A.7b), so
    this prices the plan, not the card.  float64 runs natively here: the
    reference's ×7 for its df64 kernels is not applied.  0.0 for a v3
    state, as the reference's."""
    if isinstance(state, XchState):
        return 0.0
    vsz = state.val1[0].element_size()
    sec = 0.0
    if state.n_slots1:
        sec += (state.n_slots1 * _r4_mul_slot_s(state.m1)
                + state.n_slots1 / LANES / max(state.t1, 1) * MUL_FIXED_S)
        sec += (state.n_slots2 * _r4_route_slot_s(state.m2, state.kblk,
                                                  state.p_oh)
                + state.n_slots2 / LANES / max(state.t2, 1) * R4_FIXED_S)
    if state.dia_vals is not None:
        sec += len(state.dia_offs) * state.n_row * 2.0 * vsz / HBM_BPS
    if state.long is not None:
        sec += attainable_seconds(state.long, cfg)
        sec += state.long_n * 7e-9          # final scatter-add
    sec += 3 * state.n_row * vsz / HBM_BPS  # x pad + y grid assembly
    return float(sec)
