"""SLAB — the windowed stream-row format of ``singlespmv_tpu/formats/slab.py``.

Layout (unchanged from the reference): nonzeros sorted by (row scope, window,
row, col); a window is ``m`` col-blocks of 128 columns; each (scope, window)
group chops into 128-slot stream rows, and each scope's rows pad to the grid
step T.  In *unit* mode a scope is a 1024-row unit and σ-planes of int8
end-lanes route every run to its y row; in *blk* mode a scope is a group of
``kblk`` 128-row blocks and ``sig`` gives each stream row its block offset.

Host half (``estimate``, ``convert``): the reference's numpy planner and
layout builder, carried over unchanged in behaviour, so that one COO yields
the same arrays in both packages.  It prices plans with the port's own copy
of the reference's constants (``core/chipconst.py``: the v5e literals until the
planner is refit for the H100).  ``M_CANDS``, ``X_TABLE_CAP`` and
``CHUNK_ROWS``/``_chunk_cuts`` size TPU memories; they stay until the port
sheds them (ROADMAP A.7b).

``convert`` and ``state_from_reference`` also derive, with ``route_rows``,
the spmv route's stream from the reference's arrays (``uids``, ``idx``,
``sig``/``sg0``/``sg1``, ``unit_ids``), which stay (``spmm``'s panel and
``to_coo`` read them): ``ybase``, the y position of row 0 of each 128-row
block of a step's out block, ``dest``, each run's position in that block
at the run's end slot, and ``merge``, the span of the route's merge kernel
where a stream's run ends pile onto few y rows (0 elsewhere).

Device half (``spmv``): pads x and appends the hub columns, zeroes one y
and runs one ``slab_spmv_rows`` per stream chunk (``ops/slab.py``), each
adding its run totals into y, in unit and blk mode alike.  ``spmm`` runs
one ``slab_spmm`` per stream chunk in unit mode, on the interleaved panel
(each x row's B values contiguous), under the reference's gates, then
overlap-adds the halves of pair blocks and scatters by unit id; elsewhere
it loops ``spmv`` over the columns.

Values are float32, float64 or bfloat16.  At bfloat16 val and the x table
are ``torch.bfloat16`` (2 bytes a slot), the kernel sums in float32 into a
float32 y, and ``spmv`` rounds y once to bfloat16.  At float64 the planner takes the reference's float64
branch, unit mode only and priced ×``DF_COST``, so one COO gives the same
plan and arrays in both packages; the state holds ``val`` as float64 where
the reference splits it into (hi, lo) float32 planes, and the unit kernel
runs at native fp64.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..core import chipconst as _cc
from ..core import hostmem as hm
from ..core.dtypes import (acc_dtype, from_numpy, to_host, value_size,
                           value_tensor)
from ..core.types import COOMatrix, cdiv

from ..ops.slab import (MERGE_SMEM, MERGE_WARPS, PANEL_TYPES, slab_spmm,
                        slab_spmv_rows)
from .base import TensorState, check_dtype, column_loop

STATE_REV = 1   # bump with a change of the layout (formats/cache.py)
LANES = 128
UNIT_ROWS = 1024           # y rows per unit: 8 planes × 128 lanes
M_CANDS = (1, 8, 16, 32)   # window sizes (TPU sublane-aligned)
T_CANDS = (32, 64, 128, 192, 256)   # stream rows per grid step
SPAN_CANDS = (1, 2)        # unit mode: units per output block (8/16 σ-planes)
BLK_PLANES = (8, 16, 32)   # blk mode: 128-row blocks per output block
PAD_LIMIT = 16.0           # slots / nnz refusal bound
SLOT_MEM_CAP = 10 << 30    # bytes of slot arrays a state may allocate

# per-grid-step cost model of the reference planner:
# step ≈ FIXED + slots·(BASE + route + SEL·m); constants from chipconst
STEP_FIXED_S = _cc.get("step_fixed_s")
BASE_SLOT_S = _cc.get("base_slot_s")
ROUTE_SLOT_S = _cc.get("route_slot_s")   # unit mode, per σ-plane
SEL_SLOT_S = _cc.get("sel_slot_s")       # per window member
SEL_ENTRY_S = _cc.get("sel_entry_s")     # select entry cost, any m > 1
BLK_ROUTE_S = _cc.get("blk_route_s")     # blk mode, per kblk plane
BLK_FIXED_S = _cc.get("blk_fixed_s")     # blk mode, per-slot fixed route
BLK_MXU_S = 0.0003e-9      # blk mode, per span plane
DF_COST = 6.0   # the reference's df64 per-slot multiplier over float32, kept
#                 in the float64 plan's price so both packages plan alike


@dataclasses.dataclass(frozen=True)
class SlabState(TensorState):
    n_row: int
    n_col: int
    nnz: int
    m: int                 # col-blocks per window
    t_step: int            # stream rows per grid step
    planes: int            # σ-planes (unit) / block span (blk)
    mode: str              # "unit" (σ-plane route) | "blk" (block route)
    n_units: int           # compact (nonempty) units, or block slots in blk
    cb_pad: int            # x-table col-blocks (window-aligned)
    n_slots: int
    hub_off: int           # appendix col offset (0 = no hub relabeling)
    chunk_nu: tuple        # compact units covered per stream chunk
    # per-chunk tuples of tensors (one kernel launch per chunk):
    uids: tuple            # (n_steps_c,) int32 — chunk-local unit per step
    win: tuple             # (H_c,) int32 — window base per stream row
    lane: tuple            # (H_c, 128) int8
    sub: tuple             # (H_c, 128) int8
    val: tuple             # (H_c, 128) float32 or float64
    hm1: tuple             # (H_c, 128) int8 — run head lane − 1
    idx: tuple             # (planes | kblk, H_c, 128) int8 — end-lanes, −1 masked
    unit_ids: torch.Tensor   # (n_units,) int32 — original unit/block ids
    lo_mask: torch.Tensor    # (n_units, 1) — 0 where no step owns the block
    hub_cols: Optional[torch.Tensor] = None  # (n_hub,) int32 appendix sources
    sig: Optional[tuple] = None   # blk: (H_c, 128) int8 block offset per row
    sg0: Optional[tuple] = None   # unit: (n_steps_c,) int32 first active plane
    sg1: Optional[tuple] = None   # unit: (n_steps_c,) int32 last active plane
    # the spmv route's stream, derived by route_rows (per-chunk tuples)
    ybase: tuple = ()      # (n_steps_c, planes) int32 — y position of row 0
    #                        of each 128-row block of the step's out block
    dest: tuple = ()       # (H_c, 128) int16 — run-end position in the
    #                        step's out block, −1 off run ends
    merge: int = 0         # the route's merge span (0: none)


# ----------------------------------------------------------------- packing ---

def _walk(cols_s, unit_starts, m):
    """Greedy per-unit walk over col-sorted slots: cut a stream row at 128
    slots or when the next col leaves the current m-block range.  Every
    iteration advances all active units by one stream row.

    Returns (sizes, bases, urows): slots and base block per stream row
    (unit-major order), stream rows per (nonempty) unit."""
    n_units = len(unit_starts) - 1
    block_lim = m << 7
    n_total = len(cols_s)
    starts = np.asarray(unit_starts[:-1], np.int64)
    ends = np.asarray(unit_starts[1:], np.int64)
    cur = starts.copy()
    active = np.flatnonzero(cur < ends)
    ar = hm.arange(LANES)
    sizes_l, bases_l, units_l = [], [], []
    while active.size:
        i = cur[active]
        e = ends[active]
        base = cols_s[i] >> 7
        w_idx = i[:, None] + ar[None, :]
        w = cols_s[np.minimum(w_idx, n_total - 1)]
        inside = (w_idx < e[:, None]) & (w < ((base << 7) + block_lim)[:, None])
        cnt = inside.sum(axis=1)          # ≥ 1: cols_s[i] is inside its range
        sizes_l.append(cnt)
        bases_l.append(base)
        units_l.append(active)
        j = i + cnt
        cur[active] = j
        active = active[j < e]
    if not sizes_l:
        z = np.zeros(0, np.int64)
        return z, z, np.zeros(n_units, np.int64)
    units_cat = np.concatenate(units_l)
    order = hm.argsort_keys(units_cat)             # iteration-major → unit-major
    sizes = np.concatenate(sizes_l)[order]
    bases = np.concatenate(bases_l)[order]
    urows = np.bincount(units_cat, minlength=n_units).astype(np.int64)
    return sizes, bases, urows


def _pad_units(urows, t, span):
    """Pad stream-row counts for the output-block span.

    span=1 (8 σ-planes): every step stays inside one unit.  span=2 (16
    σ-planes): a step may straddle one unit boundary — pad only when a second
    boundary would fall inside the same step.  Returns per-unit padded
    counts; the total is a multiple of t."""
    if span == 1:
        return (-(-urows // t)) * t
    pads = np.zeros(len(urows), np.int64)
    cur = 0
    last_inner_step = -1
    for u, r in enumerate(urows):
        end = cur + int(r)
        if end % t != 0:
            s = end // t
            if s == last_inner_step:
                pads[u] = t - (end % t)
                end += pads[u]
            else:
                last_inner_step = s
        cur = end
    if cur % t:
        pads[-1] += t - (cur % t)
    return urows + pads


def _pad_blocks(urows, t, planes):
    """blk mode: pad stream-row counts so every grid step touches at most
    ``planes`` consecutive compact scopes.  Returns per-scope padded counts;
    the total is a multiple of t."""
    pads = np.zeros(len(urows), np.int64)
    cur = 0
    f = 0                 # first block of the step containing `cur`
    s_prev = 0
    for b, r in enumerate(urows):
        s = cur // t
        if cur % t == 0:
            f = b
        elif b > 0 and s != s_prev:
            f = b - 1     # the step started inside the previous block
        if b - f >= planes:
            pad = t - (cur % t)
            pads[b - 1] += pad
            cur += pad
            f = b
            s = cur // t
        s_prev = s
        cur += int(r)
    if cur % t:
        pads[-1] += t - (cur % t)
    return urows + pads


def _mode_cost(mode, planes, m, h, slots, t, extra_s, kblk=1):
    if mode == "unit":
        route = planes * ROUTE_SLOT_S
        bps = 7 + planes
    else:
        route = BLK_FIXED_S + kblk * (BLK_ROUTE_S + planes * BLK_MXU_S)
        bps = 8 + kblk
    dma = slots * bps / _cc.get("hbm_bps")   # stream floor
    sel = (SEL_ENTRY_S if m > 1 else 0.0) + m * SEL_SLOT_S
    compute = slots * (BASE_SLOT_S + route + sel)
    return extra_s + (h // t) * STEP_FIXED_S + max(dma, compute)


def _estimate_cols(rows0, cols0, nnz, extra_s=0.0, fixed=None,
                   mem_scale=1, unit_only=False) -> dict:
    """Pick (mode, m, T, planes) by the step-cost model; exact slot
    accounting.  One lexsort per scope; each window candidate m re-walks the
    sorted stream.

    ``fixed``: restrict to one (mode, kblk, m, t, planes) candidate.
    ``mem_scale``: multiply slots for the memory-cap check when estimating on
    a 1/mem_scale row-unit sample."""
    best = None
    best_by_fam = {}
    nnz = len(rows0)
    m_cands = M_CANDS if nnz <= 60_000_000 else (1, 8, 16)
    t_cands = T_CANDS
    mode_cands = (("unit", 10, 1), ("blk", 7, 1),
                  ("blk", 8, 2), ("blk", 9, 4))
    if unit_only:
        mode_cands = (("unit", 10, 1),)
    if fixed is not None:
        mode_cands = tuple(mc for mc in mode_cands
                           if mc[0] == fixed["mode"] and
                           mc[2] == fixed.get("kblk", 1))
        m_cands = (fixed["m"],)
        t_cands = (fixed["t"],)
    for mode, shift, kblk in mode_cands:
        scope0 = rows0 >> shift
        cmult = int(cols0.max()) + 1 if nnz else 1
        o0 = hm.argsort_keys(scope0 * cmult + cols0)
        cols_s = cols0[o0]
        scope_s = scope0[o0]
        sb = np.flatnonzero(np.concatenate([[True],
                                            scope_s[1:] != scope_s[:-1]]))
        scope_starts = np.append(sb, len(cols_s))
        # density guard: skip walks that cannot half-fill rows
        blocks = cols_s >> 7
        chg = np.concatenate([[True], (scope_s[1:] != scope_s[:-1])
                              | (blocks[1:] != blocks[:-1])])
        spb = len(cols_s) / max(int(chg.sum()), 1)
        for m in m_cands:
            if fixed is None and spb * m < 12 and m != m_cands[-1]:
                continue
            sizes, bases, urows = _walk(cols_s, scope_starts, m)
            cands = [("unit", 8 * s) for s in SPAN_CANDS] if mode == "unit" \
                else [("blk", p) for p in BLK_PLANES]
            if fixed is not None:
                cands = [c for c in cands if c[1] == fixed["planes"]]
            for t in t_cands:
                if m * t > 1536:
                    continue
                for _, planes in cands:
                    if mode == "blk" and planes % kblk:
                        continue
                    if mode == "unit":
                        upad = _pad_units(urows, t, planes // 8)
                    else:
                        upad = _pad_blocks(urows, t, planes // kblk)
                    h = int(upad.sum())
                    # refuse a plan whose single unit exceeds one stream
                    # chunk (replays _chunk_cuts' cut condition)
                    max_steps = max(CHUNK_ROWS // t, 1)
                    if h // t > max_steps:
                        bounds = np.cumsum(upad)
                        uc = np.searchsorted(
                            bounds, np.arange(h // t, dtype=np.int64) * t,
                            side="right")
                        marks = np.flatnonzero(
                            np.concatenate([[True], uc[1:] != uc[:-1]]))
                        if int(np.diff(np.append(marks, h // t)).max(
                                initial=0)) > max_steps:
                            continue
                    slots = h * LANES
                    bps = (7 + planes) if mode == "unit" else 8 + kblk
                    if slots > PAD_LIMIT * nnz + (1 << 16) or \
                            slots * bps * mem_scale > SLOT_MEM_CAP:
                        continue
                    sec = _mode_cost(mode, planes, m, h, slots, t, extra_s,
                                     kblk)
                    cand = {"feasible": True, "est_s": sec,
                            "slots": slots, "m": m, "t": t,
                            "planes": planes, "mode": mode, "order": o0,
                            "sizes": sizes, "bases": bases,
                            "urows": urows, "kblk": kblk,
                            "unit_ids": scope_s[sb].astype(np.int32)}
                    if best is None or sec < best["est_s"]:
                        best = cand
                    # runner-up of the other route family (unit vs blk, or
                    # m == 1 vs windowed), for auto's measured trial
                    fam = (mode, m == 1)
                    if (fam not in best_by_fam
                            or sec < best_by_fam[fam]["est_s"]):
                        best_by_fam[fam] = cand
    if best is None:
        return {"feasible": False, "est_s": float("inf"), "slots": 0,
                "m": 1, "t": 32, "planes": 8, "mode": "unit", "kblk": 1}
    alts = [c for fam, c in best_by_fam.items()
            if (c["mode"], c["m"], c["t"], c["planes"], c["kblk"])
            != (best["mode"], best["m"], best["t"], best["planes"],
                best["kblk"])]
    if alts:
        best["alt"] = min(alts, key=lambda c: c["est_s"])
    return best


HUB_DEG = 32               # column degree to qualify as a hub
HUB_MAX = 16384            # appendix capacity (128 col-blocks)
HUB_GATHER_RATE = 0.14e9   # reference gather rate for the appendix build


def _hub_relabel(cols0, degs, n_col):
    """Pick hub columns, return (hub_cols int32, relabeled cols, appendix
    offset) or (None, cols0, 0) when hubs don't apply."""
    cand = np.flatnonzero(degs >= HUB_DEG)
    if len(cand) < 16:
        return None, cols0, 0
    if len(cand) > HUB_MAX:
        top = np.argsort(degs[cand])[::-1][:HUB_MAX]
        cand = np.sort(cand[top])
    off = cdiv(max(n_col, 1), LANES) * LANES
    rank = hm.full(n_col, -1, np.int64)
    rank[cand] = hm.arange(len(cand))
    r = rank[cols0]
    cols_eff = np.where(r >= 0, off + r, cols0)
    return cand.astype(np.int32), cols_eff, off


X_TABLE_CAP = 96 << 20     # TPU VMEM-resident x table bound
CHUNK_ROWS = 160_000       # stream rows per kernel call (TPU SMEM prefetch)


def _chunk_cuts(uids, n_steps: int, t_step: int, n_units: int):
    """Split the step range into chunks of ≤ CHUNK_ROWS stream rows, cutting
    only at steps whose first unit differs from the previous step's, so the
    per-chunk outputs stay disjoint.  Returns [(s0, s1, u0, nu_c)] with
    Σ nu_c == n_units."""
    max_steps = max(CHUNK_ROWS // t_step, 1)
    if n_steps <= max_steps:
        return [(0, n_steps, 0, n_units)]
    new_unit = np.flatnonzero(
        np.concatenate([[True], uids[1:] != uids[:-1]]))
    cuts = [0]
    while cuts[-1] + max_steps < n_steps:
        k = np.searchsorted(new_unit, cuts[-1] + max_steps, side="right") - 1
        s = int(new_unit[k])
        if s <= cuts[-1]:
            raise ValueError(
                "slab: a single unit exceeds the stream-chunk cap "
                f"({max_steps} steps of {t_step} rows)")
        cuts.append(s)
    cuts.append(n_steps)
    out = []
    for i in range(len(cuts) - 1):
        s0, s1 = cuts[i], cuts[i + 1]
        u0 = int(uids[s0])
        u_next = int(uids[s1]) if s1 < n_steps else n_units
        out.append((s0, s1, u0, u_next - u0))
    return out


SAMPLE_NNZ = 6_000_000      # estimate on a 1/s row-unit sample past this


def estimate(coo: COOMatrix, cfg: Config) -> dict:
    """The reference planner; float64 plans are unit mode only, priced
    ×``DF_COST``."""
    unit_only = cfg.dtype == "float64"
    if coo.nnz == 0 or coo.n_row == 0:
        return {"feasible": False, "est_s": 0.0, "slots": 0, "m": 1, "t": 32,
                "hub_cols": None, "cols_eff": None, "hub_off": 0}
    if cdiv(coo.n_col, LANES) * LANES * value_size(cfg.dtype) > X_TABLE_CAP:
        return {"feasible": False, "est_s": float("inf"), "slots": 0,
                "m": 1, "t": 32, "hub_cols": None, "cols_eff": None,
                "hub_off": 0}
    rows0 = hm.astype(coo.row, np.int64)
    cols0 = hm.astype(coo.col, np.int64)
    s = max(-(-coo.nnz // SAMPLE_NNZ), 1)
    if s > 1:
        sel = (rows0 >> 10) % s == 0      # every s-th 1024-row unit
        rows_e = rows0[sel]
    else:
        sel = None
        rows_e = rows0

    def _est(cols_full, extra_s=0.0):
        cols_e = cols_full[sel] if s > 1 else cols_full
        if len(cols_e) == 0:
            return {"feasible": False, "est_s": float("inf"), "slots": 0,
                    "m": 1, "t": 32, "mode": "unit", "planes": 8, "kblk": 1}
        p = _estimate_cols(rows_e, cols_e, len(cols_e), extra_s=extra_s,
                           mem_scale=s, unit_only=unit_only)
        if s > 1 and p["feasible"]:
            for q in (p,) + ((p["alt"],) if p.get("alt") else ()):
                q["est_s"] = s * (q["est_s"] - extra_s) + extra_s
                q["slots"] = s * q["slots"]
                q["sampled"] = s
                for k in ("order", "sizes", "bases", "urows", "unit_ids"):
                    q.pop(k, None)        # sample-only layout: convert redoes
        if p.get("alt"):
            p["alt"].update(feasible=True, hub_cols=None, cols_eff=None,
                            hub_off=0)
        return p

    def _df_scale(pp):
        if unit_only and pp.get("feasible"):
            pp["est_s"] = pp["est_s"] * DF_COST
            if pp.get("alt"):
                pp["alt"]["est_s"] = pp["alt"]["est_s"] * DF_COST
        return pp

    plan = _est(cols0)
    plan.update(hub_cols=None, cols_eff=None, hub_off=0)
    if plan["feasible"] and plan["slots"] <= 1.8 * coo.nnz:
        return _df_scale(plan)
    degs = np.bincount(cols0, minlength=coo.n_col)
    hub_cols, cols_eff, off = _hub_relabel(cols0, degs, coo.n_col)
    if hub_cols is None:
        return _df_scale(plan)
    plan2 = _est(cols_eff, extra_s=len(hub_cols) / HUB_GATHER_RATE)
    if plan2["feasible"] and plan2["est_s"] < plan["est_s"]:
        plan2.update(hub_cols=hub_cols, cols_eff=cols_eff, hub_off=off)
        return _df_scale(plan2)
    return _df_scale(plan)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def convert(coo: COOMatrix, cfg: Config, plan: dict = None) -> SlabState:
    """Build the slab layout on the host; tensors come back on the CPU."""
    check_dtype("slab", cfg.dtype)
    if plan is None:
        plan = estimate(coo, cfg)
    if not plan["feasible"]:
        if coo.nnz == 0:
            return _empty_state(coo, cfg)
        raise ValueError("slab: padding/collision bounds exceeded "
                         f"(slots={plan['slots']}, nnz={coo.nnz})")
    if plan.get("sampled"):
        # the estimate ran on a row-unit sample: materialize the exact layout
        # for the winning candidate only (one sort + one walk)
        rows0 = hm.astype(coo.row, np.int64)
        cols_x = plan["cols_eff"] if plan.get("cols_eff") is not None \
            else hm.astype(coo.col, np.int64)
        fixed = {"mode": plan["mode"], "m": plan["m"], "t": plan["t"],
                 "planes": plan["planes"], "kblk": plan.get("kblk", 1)}
        full = _estimate_cols(rows0, cols_x, coo.nnz, fixed=fixed)
        if not full["feasible"]:
            raise ValueError("slab: sampled plan infeasible at full scale "
                             f"(slots={full.get('slots')}, nnz={coo.nnz})")
        for k in ("hub_cols", "cols_eff", "hub_off"):
            full[k] = plan.get(k)
        full["hub_off"] = plan.get("hub_off", 0)
        plan = full
    m, t_step = plan["m"], plan["t"]
    mode, planes = plan["mode"], plan["planes"]
    kblk = plan.get("kblk", 1)
    dtype = cfg.np_dtype
    if mode == "blk" and cfg.dtype == "float64":
        raise ValueError("slab: float64 runs the unit route only, as in the "
                         "reference; a blk plan was given")

    o = plan["order"]
    sizes, bases = plan["sizes"], plan["bases"]
    urows, unit_ids = plan["urows"], plan["unit_ids"]
    rows = hm.astype(coo.row, np.int64)
    cols = plan["cols_eff"] if plan.get("cols_eff") is not None \
        else hm.astype(coo.col, np.int64)
    hub_cols, hub_off = plan.get("hub_cols"), plan.get("hub_off", 0)
    n_col_eff = (hub_off + len(hub_cols)) if hub_cols is not None \
        else coo.n_col
    rows, cols = rows[o], cols[o]
    vals = hm.astype(coo.val, dtype)[o]

    # pad scopes for the block span; map walk rows → final rows
    n_units = len(urows)
    rows_pad = _pad_units(urows, t_step, planes // 8) if mode == "unit" \
        else _pad_blocks(urows, t_step, planes // kblk)
    h = int(rows_pad.sum())
    ustart = np.concatenate([[0], np.cumsum(rows_pad)[:-1]])
    wstart = np.concatenate([[0], np.cumsum(urows)[:-1]])
    ur = np.repeat(hm.arange(n_units), urows)      # unit per walk row
    final_row = ustart[ur] + (hm.arange(len(sizes)) - wstart[ur])

    # per-slot stream row (walk order = col-sorted), then re-sort slots by
    # (stream row, y row) so each y row is one contiguous run; the stable
    # sort keeps the walk's col order inside each run
    sr0 = final_row[np.repeat(hm.arange(len(sizes)), sizes)]
    o2 = hm.argsort_keys(sr0 * np.int64(coo.n_row) + rows)
    rows, cols, vals, sr = rows[o2], cols[o2], vals[o2], sr0[o2]
    new_row_b = np.concatenate([[True], sr[1:] != sr[:-1]])
    starts = np.flatnonzero(new_row_b)
    li = hm.arange(len(rows)) - starts[np.cumsum(new_row_b) - 1]

    lane = hm.zeros((h, LANES), np.int8)
    sub = hm.zeros((h, LANES), np.int8)
    val = hm.zeros((h, LANES), dtype)
    hm1 = hm.zeros((h, LANES), np.int8)
    win_b = hm.zeros(h, np.int32)

    win_b[final_row] = bases.astype(np.int32)
    cb = cols >> 7
    lane[sr, li] = (cols & (LANES - 1)).astype(np.int8)
    sub[sr, li] = (cb - win_b[sr]).astype(np.int8)
    val[sr, li] = vals

    # runs: contiguous per (stream row, y row) by the sort
    new_run = hm.zeros(len(rows), np.bool_)
    new_run[0] = True
    new_run[1:] = (rows[1:] != rows[:-1]) | (sr[1:] != sr[:-1])
    q = sr * LANES + li
    head_q = np.maximum.accumulate(np.where(new_run, q, -1))
    hm1[sr, li] = (head_q - sr * LANES - 1).astype(np.int8)

    end = hm.zeros(len(rows), np.bool_)
    end[:-1] = new_run[1:]
    end[-1] = True
    r_run, sr_run, e_lane = rows[end], sr[end], li[end]

    # steps: first unit per step = unit of the step's first stream row
    n_steps = h // t_step
    unit_of_frow = np.repeat(hm.arange(n_units),
                             rows_pad.astype(np.int64))
    uids = unit_of_frow[::t_step].astype(np.int32)
    if len(uids) != n_steps:
        raise AssertionError("slab: step count does not match the padding")

    ur_run = unit_of_frow[sr_run]
    first_run = uids[sr_run // t_step].astype(np.int64)
    off = ur_run - first_run
    l_run = r_run & (LANES - 1)
    sig = None
    sg0_s = sg1_s = None
    if mode == "unit":
        # σ ∈ [0, planes): span-local plane — offset 8 per unit past first
        if off.min(initial=0) < 0 or off.max(initial=0) > planes // 8 - 1:
            raise AssertionError(
                "slab: a grid step spans more units than the block covers")
        sigma = ((r_run & (UNIT_ROWS - 1)) >> 7) + 8 * off
        # (σ, l) ↔ row is bijective inside the block span and a stream row
        # holds one run per row, so σ-planes never collide
        idx = hm.full((planes, h, LANES), -1, np.int8)
        idx[sigma, sr_run, l_run] = e_lane.astype(np.int8)
        # per-step active σ range; run ends are stream-row-sorted so the
        # reduceat segments are contiguous
        sg0_s = hm.zeros(n_steps, np.int32)
        sg1_s = hm.full(n_steps, -1, np.int32)
        if len(sr_run):
            s_of = (sr_run // t_step).astype(np.int64)
            bnd = np.flatnonzero(
                np.concatenate([[True], s_of[1:] != s_of[:-1]]))
            sg0_s[s_of[bnd]] = np.minimum.reduceat(sigma, bnd).astype(
                np.int32)
            sg1_s[s_of[bnd]] = np.maximum.reduceat(sigma, bnd).astype(
                np.int32)
    else:
        # plane j of idx holds runs destined to the group's j-th 128-row
        # block; sig per stream row = group offset · kblk
        if off.min(initial=0) < 0 or off.max(initial=0) >= planes // kblk:
            raise AssertionError("slab: a grid step spans more "
                                 "block-groups than the output covers")
        j_run = (r_run >> 7) & np.int64(kblk - 1) if kblk > 1 \
            else np.zeros(len(r_run), np.int64)
        idx = hm.full((kblk, h, LANES), -1, np.int8)
        idx[j_run, sr_run, l_run] = e_lane.astype(np.int8)
        sig_row = hm.zeros(h, np.int8)
        sig_row[final_row] = (
            (ur - uids[(final_row // t_step).astype(np.int64)]) * kblk
        ).astype(np.int8)
        sig = np.broadcast_to(sig_row[:, None], (h, LANES)).copy()

    if mode == "blk" and kblk > 1:
        # out blocks and the y scatter are per 128-row block slot
        uids = (uids.astype(np.int64) * kblk).astype(np.int32)
        unit_ids = (unit_ids.astype(np.int64)[:, None] * kblk
                    + np.arange(kblk)).ravel().astype(np.int32)
        n_units = n_units * kblk

    # units never first in any step get their (unwritten) out block masked
    written = hm.zeros(n_units, np.bool_)
    written[uids.astype(np.int64)] = True
    lo_mask = written.astype(dtype).reshape(n_units, 1)

    # the x table must cover every (base + m) range end
    cb_tot = cdiv(max(n_col_eff, 1), LANES)
    cb_pad = cb_tot + m

    cz = _chunk_cuts(uids, n_steps, t_step, n_units)
    u_t, w_t, la_t, su_t, va_t, hm_t, ix_t, sg_t, s0_t, s1_t = \
        [], [], [], [], [], [], [], [], [], []
    for s0, s1, u0, _nu in cz:
        r0, r1 = s0 * t_step, s1 * t_step
        u_t.append(_t((uids[s0:s1] - u0).astype(np.int32)))
        w_t.append(_t(win_b[r0:r1]))
        la_t.append(_t(lane[r0:r1]))
        su_t.append(_t(sub[r0:r1]))
        va_t.append(value_tensor(val[r0:r1], cfg.dtype))
        hm_t.append(_t(hm1[r0:r1]))
        ix_t.append(_t(idx[:, r0:r1]))
        if sig is not None:
            sg_t.append(_t(sig[r0:r1]))
        if sg0_s is not None:
            s0_t.append(_t(sg0_s[s0:s1]))
            s1_t.append(_t(sg1_s[s0:s1]))

    return with_routes(SlabState(
        n_row=coo.n_row, n_col=coo.n_col, nnz=coo.nnz, m=m, t_step=t_step,
        planes=planes, mode=mode, n_units=n_units, cb_pad=cb_pad,
        n_slots=h * LANES,
        hub_off=hub_off if hub_cols is not None else 0,
        chunk_nu=tuple(c[3] for c in cz),
        uids=tuple(u_t), win=tuple(w_t),
        lane=tuple(la_t), sub=tuple(su_t), val=tuple(va_t),
        hm1=tuple(hm_t), idx=tuple(ix_t),
        unit_ids=_t(unit_ids), lo_mask=value_tensor(lo_mask, cfg.dtype),
        hub_cols=_t(hub_cols) if hub_cols is not None else None,
        sig=tuple(sg_t) if sig is not None else None,
        sg0=tuple(s0_t) if sg0_s is not None else None,
        sg1=tuple(s1_t) if sg0_s is not None else None))


def _empty_state(coo, cfg):
    vt = getattr(torch, cfg.dtype)
    z8 = torch.zeros((0, LANES), dtype=torch.int8)
    return SlabState(
        n_row=coo.n_row, n_col=coo.n_col, nnz=0, m=1, t_step=32, planes=8,
        mode="unit", n_units=0, cb_pad=1, n_slots=0, hub_off=0,
        chunk_nu=(0,),
        uids=(torch.zeros(0, dtype=torch.int32),),
        win=(torch.zeros(0, dtype=torch.int32),),
        lane=(z8,), sub=(z8,),
        val=(torch.zeros((0, LANES), dtype=vt),),
        hm1=(z8,),
        idx=(torch.full((8, 0, LANES), -1, dtype=torch.int8),),
        unit_ids=torch.zeros(0, dtype=torch.int32),
        lo_mask=torch.zeros((0, 1), dtype=vt),
        ybase=(torch.zeros((0, 8), dtype=torch.int32),),
        dest=(torch.zeros((0, LANES), dtype=torch.int16),))


ROUTE_FIELDS = ("ybase", "dest", "merge")
DEST_NONE = -1
MERGE_ENDS = 32      # run ends a stream row, from which the route merges


def route_rows(state) -> dict:
    """{ybase, dest, merge}: the run-end destination stream of the spmv
    route, from the reference's arrays of ``state`` (``uids``, ``idx``,
    ``sg0``/``sg1`` in unit mode, ``sig`` in blk mode, ``unit_ids``,
    ``chunk_nu``, ``planes``, ``mode``, ``t_step``, ``n_units``, ``n_row``,
    ``val``; CPU tensors or numpy arrays).

    A step's runs end inside one out block of planes · 128 positions.  Per
    chunk, ``ybase`` is an (n_steps, planes) int32: entry (t, p) is the y
    position of row 0 of the block's p-th 128 rows, from the step's global
    compact id u = chunk offset (the sum of the earlier ``chunk_nu``) +
    uids[t]: in unit mode unit_ids[u + p // 8] · 1024 + (p % 8) · 128 (a
    16-plane pair block's half p ≥ 8 belongs to the next compact unit), in
    blk mode unit_ids[u + p] · 128; and −1 where the reference drops the
    block: a compact id at or past ``n_units`` (what the pair overlap-add and
    the shift-add's ``[:nu]`` drop) or a row 0 at or past ``n_row``.  A pair
    half or a blk group may reach into the next chunk's blocks, as the
    ``cat`` before the reference's assembly lets it.  ``dest`` is an
    (H, 128) int16 that holds, at the slot e that ends a run, the run's
    position p · 128 + l, where idx[p, r, l] == e in unit mode (for planes p
    in [sg0[t], sg1[t]], every plane where the state has no sg0) and
    idx[j, r, l] == e with p = sig[r] + j in blk mode (for p in
    [0, planes), the one-hot's range), and −1 on every other slot and on a
    run whose block is dropped or whose y row is at or past ``n_row``.
    Raises ValueError on an end lane named twice across a row's planes.

    ``merge`` is what the route kernel can observe of the stream: where its
    stream rows end on average at least ``MERGE_ENDS`` runs each (runs of
    four slots or fewer) and ``MERGE_WARPS`` spans of planes · 128 values
    fit in the merge kernel's shared memory, the span planes · 128, which
    has a block sum its rows' run totals there and add each position into
    y once, 32 consecutive rows a warp instruction; else 0, a reduction
    into y a run end, at scattered rows."""
    planes, T, unit = state.planes, state.t_step, state.mode == "unit"
    n_units, n_row = state.n_units, state.n_row
    unit_ids = np.asarray(state.unit_ids).astype(np.int64)
    p = np.arange(planes, dtype=np.int64)
    if unit:
        step_of, row0, scope_rows = p // 8, (p % 8) * LANES, UNIT_ROWS
    else:
        step_of, row0, scope_rows = p, 0, LANES
    span = planes * LANES
    ybases, dests, u0, n_ends, n_rows = [], [], 0, 0, 0
    for c, (uids, idx, nu_c) in enumerate(zip(state.uids, state.idx,
                                              state.chunk_nu)):
        cu = np.asarray(uids).astype(np.int64)[:, None] + u0 + step_of
        inside = cu < n_units
        yrow = unit_ids[np.where(inside, cu, 0)] * scope_rows + row0
        ybase = np.where(inside & (yrow < n_row), yrow, -1)
        idx = np.asarray(idx)
        h = idx.shape[1]
        if unit and state.sg0 is None:   # every plane, as the reference
            lo, hi = np.zeros(len(cu), np.int64), np.full(len(cu), planes)
        elif unit:
            lo = np.asarray(state.sg0[c]).astype(np.int64)
            hi = np.asarray(state.sg1[c]).astype(np.int64)
        else:
            sig = np.asarray(state.sig[c])[:, 0].astype(np.int64)
        dest = np.full((h, LANES), DEST_NONE, np.int16)
        n_kept = 0
        for j in range(idx.shape[0]):
            rr, ll = np.nonzero(idx[j] >= 0)
            t = rr // T
            if unit:
                pj = np.full(len(rr), j, np.int64)
                keep = (lo[t] <= j) & (j <= hi[t])
            else:
                pj = sig[rr] + j
                keep = (pj >= 0) & (pj < planes)      # the one-hot's range
            rr, ll, pj, t = rr[keep], ll[keep], pj[keep], t[keep]
            b = ybase[t, pj]
            placed = (b >= 0) & (b + ll < n_row)
            dest[rr, idx[j][rr, ll]] = np.where(placed, pj * LANES + ll, -2)
            n_kept += len(rr)
        if np.count_nonzero(dest != DEST_NONE) != n_kept:
            raise ValueError("slab: an end lane is named twice in a stream "
                             "row's idx planes")
        dest[dest == -2] = DEST_NONE
        n_ends += int(np.count_nonzero(dest >= 0))
        n_rows += h
        ybases.append(_t(ybase.astype(np.int32)))
        dests.append(_t(dest))
        u0 += nu_c
    vsz = acc_dtype(state.val[0].dtype).itemsize     # the spans' sums
    merge = (n_ends >= MERGE_ENDS * max(n_rows, 1)
             and MERGE_WARPS * span * vsz <= MERGE_SMEM)
    return dict(ybase=tuple(ybases), dest=tuple(dests),
                merge=span if merge else 0)


def adds_per_row(state: SlabState) -> np.ndarray:
    """(n_row,) int64: the run totals ``spmv`` adds into each y row, one a
    run end of the ``dest`` streams.  On the card their order of addition
    is free (``core/oracle.py:reorder_bound``)."""
    k = np.zeros(state.n_row, np.int64)
    if state.nnz == 0 or state.n_units == 0:
        return k
    for yb, d in zip(state.ybase, state.dest):
        d, yb = to_host(d).astype(np.int64), to_host(yb).astype(np.int64)
        r, lane = np.nonzero(d >= 0)
        e = d[r, lane]
        base = yb[r // state.t_step, e >> 7]
        pos = base + (e & (LANES - 1))
        k += np.bincount(pos[(base >= 0) & (pos < state.n_row)],
                         minlength=state.n_row)
    return k


def with_routes(state: SlabState) -> SlabState:
    """``state`` with its ``ybase``, ``dest`` and ``merge`` from
    ``route_rows``."""
    return dataclasses.replace(state, **route_rows(state))


_ARRAY_FIELDS = ("uids", "win", "lane", "sub", "val", "hm1", "idx", "sig",
                 "sg0", "sg1", "unit_ids", "lo_mask", "hub_cols")


def state_from_reference(arrays: dict) -> SlabState:
    """The port's state from the fields of a reference ``SlabState``.

    ``arrays`` maps field names to numpy arrays (per-chunk tuples stay
    tuples) and scalars, as ``dataclasses.asdict`` of a reference state
    moved to the host gives them.  A df64 state's (hi, lo) float32 value
    planes (``val``, ``val_lo``) fold into float64 ``val = hi + lo``."""
    arrays = dict(arrays)
    if arrays.get("val_lo") is not None:
        arrays["val"] = tuple(
            np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
            for hi, lo in zip(arrays["val"], arrays["val_lo"]))
    kw = {}
    for f in dataclasses.fields(SlabState):
        if f.name in ROUTE_FIELDS:     # derived below, not the reference's
            continue
        v = arrays.get(f.name)
        if f.name in _ARRAY_FIELDS and v is not None:
            v = tuple(from_numpy(np.array(a)) for a in v) \
                if isinstance(v, (tuple, list)) \
                else from_numpy(np.array(v))
        kw[f.name] = v
    state = SlabState(**kw)
    for v in state.val:
        check_dtype("slab", v.dtype)
    return with_routes(state)


# -------------------------------------------------------------------- spmv ---

def x_table(state: SlabState, x: torch.Tensor) -> torch.Tensor:
    """The kernels' (cb_pad, 128) x table: x zero-padded to whole windows,
    with the hub columns copied into the appendix.  For a panel X
    (n_col, B), the interleaved (cb_pad, 128, B) panel: X padded the same
    way, each x row's B values contiguous as in X."""
    xp = torch.zeros((state.cb_pad * LANES,) + x.shape[1:], dtype=x.dtype,
                     device=x.device)
    xp[: state.n_col] = x
    if state.hub_cols is not None:
        n_hub = state.hub_cols.shape[0]
        xp[state.hub_off: state.hub_off + n_hub] = x.index_select(
            0, state.hub_cols)
    return xp.view((state.cb_pad, LANES) + x.shape[1:])


def spmv_acc(state: SlabState, x: torch.Tensor) -> torch.Tensor:
    """y = A x in the accumulator type (float32 for bfloat16 values): the
    kernels add into it."""
    if x.dtype != state.val[0].dtype:
        raise TypeError(f"slab: x is {x.dtype}, the state holds "
                        f"{state.val[0].dtype} values")
    y = torch.zeros(state.n_row, dtype=acc_dtype(x.dtype), device=x.device)
    if state.nnz == 0 or state.n_units == 0:
        return y
    xp = x_table(state, x)
    for yb, w, la, su, va, h1, d in zip(state.ybase, state.win, state.lane,
                                        state.sub, state.val, state.hm1,
                                        state.dest):
        slab_spmv_rows(yb, w, la, su, va, h1, d, xp, y, state.m,
                       state.t_step, state.merge)
    return y


def spmv(state: SlabState, x: torch.Tensor) -> torch.Tensor:
    """y = A x, rounded once to x's type."""
    return spmv_acc(state, x).to(x.dtype)


PANEL_B_MAX = 32           # the reference's panel kernel unrolls B in-kernel


def spmm_acc(state: SlabState, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X, X (n_col, B), in the accumulator type (float32 for
    bfloat16 values): the reference's panel path (its
    ``formats/slab.py:867``).  In unit mode with 2 ≤ B ≤ ``PANEL_B_MAX``, a
    float32 or bfloat16 panel (``PANEL_TYPES``, the TPU's) and B x tables
    within ``X_TABLE_CAP`` (at X's own 4 or 2 bytes a value), one
    ``slab_spmm`` per stream chunk reads the streams once per column tile
    (its x panel interleaved, ``x_table``) into float32 out blocks, which
    the pair-block overlap-add sums in float32; blk mode and every other
    B take the column loop of ``spmv_acc``.  The gates are the reference's,
    the TPU's x-table cap included, so both packages take the same branch
    for one state and B; shedding the cap is ROADMAP A.7b's work."""
    if X.dtype != state.val[0].dtype:
        raise TypeError(f"slab: X is {X.dtype}, the state holds "
                        f"{state.val[0].dtype} values")
    n_cols = X.shape[1]
    table_bytes = state.cb_pad * LANES * X.element_size()
    if (state.mode != "unit" or state.nnz == 0 or state.n_units == 0
            or not 2 <= n_cols <= PANEL_B_MAX
            or n_cols * table_bytes > X_TABLE_CAP
            or X.dtype not in PANEL_TYPES):
        return column_loop(spmv_acc, state, X)
    xp = x_table(state, X)
    nu, planes = state.n_units, state.planes
    outs = [slab_spmm(u, s0, s1, w, la, su, va, h1, ix, xp, nu_c, state.m,
                      state.t_step)
            for u, s0, s1, w, la, su, va, h1, ix, nu_c in zip(
                state.uids, state.sg0, state.sg1, state.win, state.lane,
                state.sub, state.val, state.hm1, state.idx, state.chunk_nu)]
    # out blocks are Y's (row, B) layout: no transpose
    out = outs[0] if len(outs) == 1 else torch.cat(outs, 0)
    if planes == 8:
        yu = out.view(nu, UNIT_ROWS, n_cols)
    else:
        # pair-block overlap-add: block u rows 0-7 → unit u, 8-15 → u+1
        out4 = out.view(nu, 2, UNIT_ROWS, n_cols)
        yu = out4[:, 0].clone()
        yu[1:] += out4[:-1, 1]
    y2 = torch.zeros(cdiv(max(state.n_row, 1), UNIT_ROWS), UNIT_ROWS, n_cols,
                     dtype=out.dtype, device=X.device)
    y2[state.unit_ids.long()] = yu
    return y2.view(-1, n_cols)[: state.n_row]


def spmm(state: SlabState, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X, X (n_col, B), rounded once to X's type."""
    return spmm_acc(state, X).to(X.dtype)


# ----------------------------------------------------------------- reports ---

def report_fields(state: SlabState, cfg: Config) -> dict:
    return {"WindowBlocks": state.m, "StepRows": state.t_step,
            "RoutePlanes": state.planes,
            "PadFactor": round(state.n_slots / max(state.nnz, 1), 3)}


def traffic_bytes(state: SlabState, cfg: Config) -> int:
    vsz = value_size(cfg.dtype)
    if state.mode == "blk":
        per_slot = vsz + 4 + state.idx[0].shape[0]   # lane/sub/hm1/sig + kblk
    else:
        per_slot = vsz + 3 + state.planes
    return (state.n_slots * per_slot + state.n_row * vsz
            + state.cb_pad * LANES * vsz)


def to_coo(state: SlabState) -> COOMatrix:
    """Reassemble the chunked stream on the host (inverse of convert)."""
    def cat(t, ax=0):
        return np.concatenate([to_host(a) for a in t], axis=ax)

    lane = cat(state.lane).astype(np.int64)
    sub = cat(state.sub).astype(np.int64)
    val = cat(state.val).astype(np.float64)
    win = cat(state.win).astype(np.int64)
    hm1 = cat(state.hm1).astype(np.int64)
    idx = cat(state.idx, ax=1).astype(np.int64)  # stream axis 1 (both modes)
    u_base = np.cumsum([0] + list(state.chunk_nu[:-1]))
    uids = np.concatenate(
        [u.cpu().numpy().astype(np.int64) + b
         for u, b in zip(state.uids, u_base)])
    unit_ids = state.unit_ids.cpu().numpy().astype(np.int64)
    h = lane.shape[0]
    if h == 0:
        return COOMatrix.from_triplets(state.n_row, state.n_col, [], [], [],
                                       sort=True)
    # recover per-slot rows from the route planes: walk runs per stream row
    first_cu = uids[np.repeat(np.arange(h // state.t_step), state.t_step)]
    cols = win[:, None] * LANES + sub * LANES + lane
    if state.hub_cols is not None:
        hub = state.hub_cols.cpu().numpy().astype(np.int64)
        is_app = cols >= state.hub_off
        cols = np.where(is_app, hub[np.minimum(cols - state.hub_off,
                                               len(hub) - 1)], cols)
    rows = hm.full((h, LANES), -1, np.int64)
    if state.mode == "blk":
        sig = cat(state.sig)[:, 0].astype(np.int64)
        for j in range(idx.shape[0]):       # idx: (kblk, H, 128)
            sr_i, l_i = np.nonzero(idx[j] >= 0)
            end_lane = idx[j][sr_i, l_i]
            blk = unit_ids[first_cu[sr_i] + sig[sr_i] + j]
            rows[sr_i, end_lane] = blk * LANES + l_i
    else:
        for sigma in range(idx.shape[0]):
            e = idx[sigma]
            sr_i, l_i = np.nonzero(e >= 0)
            end_lane = e[sr_i, l_i]
            cu = first_cu[sr_i] + (sigma >= 8)
            rows[sr_i, end_lane] = (unit_ids[cu] * UNIT_ROWS
                                    + (sigma % 8) * LANES + l_i)
    # propagate row ids backward across each run (ends carry the id);
    # slot j+1 heads a new run iff hm1[j+1] == j
    for j in range(LANES - 2, -1, -1):
        carry = (hm1[:, j + 1] != j) & (rows[:, j] < 0)
        rows[carry, j] = rows[carry, j + 1]
    mask = (rows >= 0) & (val != 0)
    return COOMatrix.from_triplets(
        state.n_row, state.n_col,
        rows[mask], cols[mask], val[mask], sort=True)


def attainable_seconds(state: SlabState, cfg: Config) -> float:
    """The reference planner's step-cost model evaluated at the converted
    state's own plan and slot count, plus x-table and y traffic at the
    state's value size.  Its constants come from ``chipconst``, which holds
    no H100 measurement yet (ROADMAP A.7b), so this prices the plan, not the
    card.  float64 runs natively here: the reference's ×``DF_COST`` for its
    df64 kernel is not applied."""
    if state.n_slots == 0:
        return 0.0
    kblk = state.idx[0].shape[0] if state.mode == "blk" else 1
    h = state.n_slots // LANES
    sec = _mode_cost(state.mode, state.planes, state.m, h, state.n_slots,
                     state.t_step, 0.0, kblk=kblk)
    sec += ((state.cb_pad * LANES + 2 * state.n_row)
            * state.val[0].element_size() / _cc.get("hbm_bps"))
    return float(sec)
