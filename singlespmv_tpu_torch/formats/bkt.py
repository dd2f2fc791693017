"""BKT — the two-phase bucketed format of ``singlespmv_tpu/formats/bkt.py``.

Stage A makes val·x products in (column group, row unit)-bucket order;
stage B takes them in that order and adds each run total straight into y,
at the row that a run-end destination stream names (``route_rows``:
``hm1r``, ``dest``, ``yrow``), for 128-row buckets and the 1024-row buckets
of ``bkt_g`` alike, the inverse of the balance permutation folded into
``yrow``.  The spmv runs both in one CUDA kernel, ``bucket_fused_rows``
(``csrc/bucket.cu`` behind ``ops/bucket.py``), the products in registers.
The first port's pair (``block_gather_mul`` writing the products,
``bucket_rows`` reading them back) and the reference's stage B
(``bucket_reduce``, ``bucket_reduce_grouped``, then ``lane_unpermute``, on
the idx planes, which the state keeps) are on no path: they stay for the
first port's checks.

``estimate`` and ``convert`` are copies of the reference's, array for array:
one COO gives the same plan and the same arrays in both packages (the tests
hold them equal).  ``bkt_row_group`` picks the bucket height: 128 (format
``bkt``) or 1024 (``auto``'s ``bkt_g``).  The planning caps that model TPU
memories (``IDX_VMEM_BUDGET``, ``CB_CHUNK_MAX``, ``K_MAX``) stay as they are, so
the layouts stay the reference's.

Float32 only: the reference's bkt refuses float64 on its chip, and so do
``convert`` and ``spmv`` here (``TypeError``).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..config import Config
from ..core import hostmem as hm
from ..core.dtypes import (from_numpy, name_of, to_host, value_size,
                           value_tensor)
from ..core.types import COOMatrix, cdiv, round_up
from ..ops.bucket import bucket_fused_rows
from .base import TensorState
from .slab import _t

STATE_REV = 1   # bump with a change of the layout (formats/cache.py)
LANES = 128
W_A = 1024             # stage-A stream row width (slots)
PAD_LIMIT = 16.0       # max padded-slots / nnz before refusing
MIN_SLOTS = 1 << 16    # small matrices are always allowed
K_MAX = 32             # absolute collision-chain cap
IDX_VMEM_BUDGET = 4 << 20   # the reference's stage-B idx block budget (VMEM)
CB_CHUNK_MAX = 384     # the reference's stage-B col-group chunk (VMEM)
GROUP_FILL_TARGET = 72  # pack col-blocks until expected bucket fill ≥ this


VALUE_TYPES = ("float32", "bfloat16")   # the bucket kernels'


def _check_dtype(dtype) -> None:
    name = name_of(dtype)
    if name not in VALUE_TYPES:
        raise TypeError(f"bkt runs float32 and bfloat16 kernels only, as the "
                        f"reference's bkt does on its chip; not {name}")


def k_cap(g: int, itemsize: int, floor: int = 4) -> int:
    """Collision-chain cap: idx block = K·G·128·itemsize bytes."""
    return max(floor, min(K_MAX, IDX_VMEM_BUDGET // (g * 128 * itemsize)))


def balance_map(rows: np.ndarray, RB: int) -> np.ndarray:
    """Lane-preserving balance permutation: per lo class, deal rows (heaviest
    first) to the least-loaded row-block.  Returns (RB, 128) new_rb_of."""
    w = np.bincount(rows, minlength=RB * LANES).reshape(RB, LANES)
    new_rb_of = np.empty((RB, LANES), dtype=np.int64)
    loads = np.zeros(RB, dtype=np.int64)
    for cls in range(LANES):          # greedy: heaviest → least-loaded rb
        order_desc = np.argsort(-w[:, cls], kind="stable")
        targets = np.argsort(loads, kind="stable")
        new_rb_of[order_desc, cls] = targets
        loads[targets] += w[order_desc, cls]
    return new_rb_of


def _pick_m(nnz: int, n_buckets: int, cfg: Config) -> int:
    """Column-group width: pack col-blocks until the expected bucket fill
    reaches GROUP_FILL_TARGET."""
    if cfg.bkt_group_cols:
        return int(cfg.bkt_group_cols)
    fill = nnz / max(n_buckets, 1)
    m = 1
    while m < 8 and fill * m < GROUP_FILL_TARGET:
        m *= 2
    return m


def _pack_columns(col_load: np.ndarray, m: int) -> np.ndarray:
    """Serpentine-deal columns (sorted by load, heaviest first) into
    ceil(CB/m) groups of m.  Returns (n_grp, m) member table (tail padded
    with the last column)."""
    CB = len(col_load)
    n_grp = cdiv(CB, m)
    order = np.argsort(-col_load, kind="stable")
    pad = n_grp * m - CB
    if pad:
        order = np.concatenate([order, np.repeat(order[-1:], pad)])
    members = np.empty((n_grp, m), dtype=np.int32)
    for j in range(m):                # serpentine: heavy rounds alternate ends
        blk = order[j * n_grp:(j + 1) * n_grp]
        members[:, j] = blk if j % 2 == 0 else blk[::-1]
    return members


def _plan_s(s_base: int, ru: int) -> int:
    """Bucket depth: 128 in grouped mode (a bucket is one stream row),
    128-multiples at ru=1."""
    return LANES if ru == 8 else round_up(s_base, LANES)


def _ghost_counts(counts2d: np.ndarray, S: int) -> np.ndarray:
    """Ghost groups per original group: the deepest bucket's overflow,
    in units of S."""
    excess = np.maximum(counts2d - S, 0)
    return (-(-excess // S)).max(axis=1)


def _align_groups(g_tot: int, NU_pad: int, S: int, ru: int):
    """Group count aligned so stage A's stream tiles evenly; grouped mode
    also splits the group axis into chunks.  Returns (G_tot, n_chunks)."""
    unit = NU_pad * S
    need = (8 * W_A) // math.gcd(unit, 8 * W_A)
    g_tot = round_up(g_tot, need)
    if ru != 8:
        return g_tot, 1
    n = cdiv(g_tot, CB_CHUNK_MAX)
    while True:
        step = 8 * n                      # chunks of 8-multiples of rows
        lcm = step * need // math.gcd(step, need)
        c = round_up(g_tot, lcm)
        if c // n <= CB_CHUNK_MAX:
            return c, n
        n = cdiv(c, CB_CHUNK_MAX)


def estimate(coo: COOMatrix, cfg: Config) -> dict:
    """Convert-free plan (slots / S / m / ghosts) for ``formats.auto``,
    the reference's."""
    ru = max(1, int(cfg.bkt_row_group) // LANES)
    RB = cdiv(max(coo.n_row, 1), LANES)
    CB = cdiv(max(coo.n_col, 1), LANES)
    NU = cdiv(RB, ru)
    if coo.nnz:
        rows = coo.row.astype(np.int64)
        rb = rows // LANES
        if bool(cfg.bkt_balance) and RB <= 2048:
            rb = balance_map(rows, RB)[rb, rows % LANES]
        cb = coo.col.astype(np.int64) // LANES
        m = _pick_m(coo.nnz, CB * NU, cfg) if ru == 8 else 1
        if m > 1:
            col_load = np.bincount(cb, minlength=CB)
            members = _pack_columns(col_load, m)
            grp_of = np.zeros(CB, dtype=np.int64)
            for j in range(m):
                grp_of[members[:, j]] = np.arange(members.shape[0])
            gb = grp_of[cb]
        else:
            gb = cb
        n_grp = cdiv(CB, m)
        counts0 = np.bincount(gb * NU + rb // ru, minlength=n_grp * NU)
    else:
        m, n_grp = 1, CB
        counts0 = np.zeros(n_grp * NU, dtype=np.int64)
    nz = counts0[counts0 > 0]
    s_need = int(counts0.max(initial=1))
    s_cap = int(np.percentile(nz, cfg.bkt_cap_pct)) if nz.size else 1
    s_base = max(min(s_need, max(s_cap, 1)), 1)

    NU_pad = round_up(NU, 8)
    S = _plan_s(s_base, ru)
    gpc = _ghost_counts(counts0.reshape(n_grp, NU), S)
    if ru == 1:
        ghost_total = _align_groups(n_grp + int(gpc.sum()), NU_pad, S,
                                    ru)[0] * NU_pad * S
        S_d = _plan_s(s_need, ru)
        deep_total = _align_groups(n_grp, NU_pad, S_d, ru)[0] * NU_pad * S_d
        if deep_total < ghost_total:
            S = S_d
            gpc = np.zeros(n_grp, dtype=np.int64)
    g_tot, _nch = _align_groups(n_grp + int(gpc.sum()), NU_pad, S, ru)
    n = g_tot * NU_pad * S
    k_est = 2 if ru == 8 else max(1, min(8, 128 // max(1, S)))
    feasible = n <= max(PAD_LIMIT * max(coo.nnz, 1), MIN_SLOTS)
    return {"slots": n, "s": S, "m": m, "rb_pad": NU_pad * ru,
            "g_tot": g_tot, "ghosts": int(gpc.sum()), "k_est": k_est,
            "feasible": feasible}


@dataclasses.dataclass(frozen=True)
class BKTState(TensorState):
    n_row: int
    n_col: int
    nnz: int
    rb_pad: int
    cb: int           # original col-blocks (x table rows)
    g_tot: int        # column groups incl. ghost groups + alignment pads
    s: int            # bucket depth (128 in grouped mode)
    g: int            # stream rows per row-unit slab = g_tot·s / 128
    k: int            # collision chain depth
    m: int            # col-blocks packed per group (stage-A m-way select)
    n_slots: int
    n_ghost: int
    members: torch.Tensor   # (H·m,) int32 — per stage-A stream row, m x rows
    mem_tab: torch.Tensor   # (g_tot, m) int32 — group → member col-blocks
    lane: torch.Tensor      # (H, W) int8 — in-block column
    src: torch.Tensor       # (H, W) int8 — member index per slot (m > 1)
    val: torch.Tensor       # (H, W) float32
    hm1: torch.Tensor       # int8 — lane of run head − 1 (−1: row start)
    idx: torch.Tensor       # int8 (ru=1) / int16 σ·128+lane (grouped)
    lo_a: torch.Tensor      # (H, W) int32 — row-local per slot (to_coo)
    balanced: bool = False
    src_lane: torch.Tensor = None   # (128, RB_pad) int32 — balance inverse
    src_chunk: torch.Tensor = None
    row_group: int = 128    # rows per bucket unit (128 or 1024)
    n_chunks: int = 1       # the reference's grouped stage-B chunking
    # stage B's run-end stream (route_rows), in stage A's row order
    hm1r: torch.Tensor = None   # (H, 128) int8 — hm1
    dest: torch.Tensor = None   # (H, 128) int8 / int16 — run's unit row
    yrow: torch.Tensor = None   # (rb_pad·128,) int32 — y row of a unit row
    parts: int = 0              # stage B's blocks a unit (0: a warp a row)


def convert(coo: COOMatrix, cfg: Config) -> BKTState:
    """Build the bucket layout on the host; tensors come back on the CPU."""
    _check_dtype(cfg.dtype)
    n_row, n_col, nnz = coo.n_row, coo.n_col, coo.nnz

    ru = max(1, int(cfg.bkt_row_group) // LANES)   # 128-row blocks per bucket
    if ru not in (1, 8):
        raise ValueError("bkt_row_group must be 128 or 1024")
    RL = ru * LANES                                 # rows per bucket unit
    RB = cdiv(max(n_row, 1), LANES)
    CB = cdiv(max(n_col, 1), LANES)
    NU = cdiv(RB, ru)                               # bucket row units

    rows = hm.astype(coo.row, np.int64)
    cols = hm.astype(coo.col, np.int64)
    rb = rows // LANES
    cb = cols // LANES
    lo = rows % LANES

    # lane-preserving balance permutation, inverted after stage B by
    # lane_unpermute
    balanced = bool(cfg.bkt_balance) and RB <= 2048 and nnz > 0
    new_rb_of = None
    if balanced:
        new_rb_of = balance_map(rows, RB)
        rb = new_rb_of[rb, lo]

    ub = rb // ru                                  # bucket row-unit index
    rl = (rb % ru) * LANES + lo                    # row-local within the unit

    # --- column groups: pack m col-blocks per group (serpentine by load) -----
    m = _pick_m(nnz, CB * NU, cfg) if ru == 8 else 1
    if m > 1:
        col_load = np.bincount(cb, minlength=CB)
        base_members = _pack_columns(col_load, m)
        grp_of = np.zeros(CB, dtype=np.int64)
        j_of = np.zeros(CB, dtype=np.int8)
        for j in range(m):
            grp_of[base_members[:, j]] = np.arange(base_members.shape[0])
            j_of[base_members[:, j]] = j
        gb = grp_of[cb]
        j_e0 = j_of[cb]
        n_grp = base_members.shape[0]
    else:
        base_members = np.arange(CB, dtype=np.int32).reshape(CB, 1)
        gb = cb
        j_e0 = np.zeros(nnz, dtype=np.int8)
        n_grp = CB

    # S: bucket depth; dense buckets spill into ghost groups
    counts0 = np.bincount(gb * NU + ub, minlength=n_grp * NU) if nnz else \
        np.zeros(n_grp * NU, dtype=np.int64)
    nz_counts = counts0[counts0 > 0]
    s_need = int(counts0.max(initial=1))
    s_cap = int(np.percentile(nz_counts, cfg.bkt_cap_pct)) if nz_counts.size \
        else 1
    s_base = max(min(s_need, max(s_cap, 1)), 1)

    NU_pad = round_up(NU, 8)
    S = _plan_s(s_base, ru)
    gpc = _ghost_counts(counts0.reshape(n_grp, NU), S)
    if ru == 1:
        # deep-S alternative: cheaper when overflow concentrates in a few
        # dense buckets (a ghost group is a full NU_pad·S panel)
        ghost_total = _align_groups(n_grp + int(gpc.sum()), NU_pad, S,
                                    ru)[0] * NU_pad * S
        S_d = _plan_s(s_need, ru)
        deep_total = _align_groups(n_grp, NU_pad, S_d, ru)[0] * NU_pad * S_d
        if deep_total < ghost_total:
            S = S_d
            gpc = np.zeros(n_grp, dtype=np.int64)
    RB_pad = NU_pad * ru

    # ---- ghost-group bookkeeping ---------------------------------------------
    ghost_base = np.zeros(n_grp + 1, dtype=np.int64)
    np.cumsum(gpc, out=ghost_base[1:])
    next_ghost = n_grp + int(ghost_base[-1])   # first free ghost group index
    ghost_parent = [np.repeat(np.arange(n_grp, dtype=np.int64), gpc)]

    # inverse routing of the balance permutation, sized to the final RB_pad:
    # out[lo, rb_orig] reads y_tab[new_rb_of[rb_orig, lo], lo]
    if balanced:
        rbu = round_up(RB_pad, LANES)
        src_col = np.broadcast_to(np.arange(rbu, dtype=np.int32),
                                  (LANES, rbu)).copy()
        src_col[:, :RB] = new_rb_of.T
        src_lane = _t(src_col % LANES)
        src_chunk = _t(src_col // LANES)
    else:
        src_lane = _t(np.zeros((LANES, LANES), np.int32))
        src_chunk = _t(np.zeros((LANES, LANES), np.int32))

    # ---- entry arrays, bucket-major, row-local-sorted within bucket ---------
    bucket0 = gb * NU_pad + ub
    order = np.lexsort((cols, rl, bucket0)) if nnz else np.zeros(0, np.int64)
    ogrp = gb[order]                   # original group per entry
    ub_e = ub[order]
    rl_e = rl[order]
    col_e = cols[order]
    j_e = j_e0[order]
    val_e = hm.astype(coo.val, cfg.np_dtype)[order]
    counts = np.bincount(bucket0, minlength=n_grp * NU_pad) if nnz else \
        np.zeros(n_grp * NU_pad, dtype=np.int64)
    start = hm.zeros(n_grp * NU_pad, np.int64)
    np.cumsum(counts[:-1], out=start[1:])
    seq = hm.arange(nnz) - start[bucket0[order]]
    bkt_grp = ogrp.copy()              # bucket's group index (ghosts re-home)

    # bucket-cap overflow -> round-0 ghost groups: same unit, seq mod S
    over = seq >= S
    if over.any():
        bkt_grp[over] = n_grp + ghost_base[ogrp[over]] + (seq[over] - S) // S
        seq = np.where(over, (seq - S) % S, seq)

    def assign_ghosts(mask):
        """Re-home masked entries into fresh ghost groups (per parent group,
        so member tables carry over).  Returns the number of new groups."""
        nonlocal bkt_grp, seq, next_ghost
        idx_m = np.nonzero(mask)[0]
        # collision mates (runs sharing a bin lane) land in different stream
        # rows instead of re-colliding in the ghost buckets
        rm = rl_e[idx_m]
        sub = np.lexsort((rm, rm % LANES, rm == RL - 1,
                          ub_e[idx_m], ogrp[idx_m]))
        idx_m = idx_m[sub]
        key = ogrp[idx_m] * NU_pad + ub_e[idx_m]
        cnts = np.bincount(key, minlength=n_grp * NU_pad)
        gpc2 = (-(-cnts.reshape(n_grp, NU_pad) // S)).max(axis=1)
        base2 = np.zeros(n_grp + 1, dtype=np.int64)
        np.cumsum(gpc2, out=base2[1:])
        st2 = np.zeros(n_grp * NU_pad, dtype=np.int64)
        np.cumsum(cnts[:-1], out=st2[1:])
        within = np.arange(len(idx_m)) - st2[key]
        bkt_grp[idx_m] = next_ghost + base2[ogrp[idx_m]] + within // S
        seq[idx_m] = within % S
        ghost_parent.append(np.repeat(np.arange(n_grp, dtype=np.int64), gpc2))
        next_ghost += int(base2[-1])
        return int(base2[-1])

    # ---- entry-space runs + collision chains (with over-chain respill) ------
    # A run = one (bucket, rl) group, split at 128-slot stream-row boundaries;
    # runs deeper than K_TARGET respill into ghost groups.
    K_TARGET = 4 if ru == 8 else 8

    def compute_runs():
        o2 = np.lexsort((seq, rl_e, ub_e, bkt_grp))
        bke = bkt_grp[o2] * NU_pad + ub_e[o2]
        rle = rl_e[o2]
        sq = seq[o2]
        n = len(o2)
        new_g = np.empty(n, dtype=bool)
        if n:
            new_g[0] = True
            new_g[1:] = (bke[1:] != bke[:-1]) | (rle[1:] != rle[:-1])
        first = np.nonzero(new_g)[0]
        last = np.append(first[1:] - 1, n - 1) if len(first) else first
        gbg = bkt_grp[o2[first]]
        ubg = ub_e[o2[first]]
        rlg = rle[first]
        p0 = gbg * S + sq[first]
        # rl == RL-1 merges with the bucket's trailing pads -> extend to end
        p1 = gbg * S + np.where(rlg == RL - 1, S - 1, sq[last])
        n_c = (p1 >> 7) - (p0 >> 7)            # stream-row crossings
        tot = n_c + 1
        offs = np.zeros(len(first) + 1, dtype=np.int64)
        np.cumsum(tot, out=offs[1:])
        rep = np.repeat(np.arange(len(first)), tot)
        j = np.arange(int(offs[-1])) - offs[:-1][rep]
        end_p = np.minimum(p1[rep], ((p0[rep] >> 7) + 1 + j) * 128 - 1)
        r_ub = ubg[rep]
        r_prow = end_p >> 7
        r_el = end_p & 127
        r_bin = rlg[rep]
        key = (r_ub << 32) + r_prow * 128 + r_bin % LANES
        ord2 = np.lexsort((r_el, key))
        key_s = key[ord2]
        is_first = np.empty(len(key_s), dtype=bool)
        if len(key_s):
            is_first[0] = True
            is_first[1:] = key_s[1:] != key_s[:-1]
        grp2 = np.cumsum(is_first) - 1
        fpos = np.nonzero(is_first)[0]
        chain = (np.arange(len(key_s)) - fpos[grp2]) if len(key_s) else \
            np.zeros(0, np.int64)
        return (r_ub[ord2], r_prow[ord2], r_el[ord2], r_bin[ord2], chain,
                rep[ord2], o2, new_g, p0, first)

    for _ in range(3):
        (r_ub, r_prow, r_el, r_bin, chain, run_grp, o2, new_g, p0,
         first) = compute_runs()
        if int(chain.max(initial=0)) < K_TARGET:
            break
        bad_groups = np.unique(run_grp[chain >= K_TARGET])
        gi = np.cumsum(new_g) - 1              # group id per sorted entry
        bad_mask = np.zeros(nnz, dtype=bool)
        bad_mask[o2] = np.isin(gi, bad_groups)
        assign_ghosts(bad_mask)
    K = int(chain.max(initial=0)) + 1
    itemsize = 2 if ru == 8 else 1

    # ---- final geometry -------------------------------------------------------
    G_tot, n_chunks = _align_groups(next_ghost, NU_pad, S, ru)
    n_ghost = G_tot - n_grp
    N = G_tot * NU_pad * S
    if N > max(PAD_LIMIT * max(nnz, 1), MIN_SLOTS):
        raise ValueError(
            f"bkt: padded grid {N} slots vs nnz {nnz} exceeds PAD_LIMIT — "
            "matrix too hyper-sparse for dense bucketing; use csr/css")
    G = G_tot * S // LANES
    k_lim = k_cap(8 * (G // n_chunks) if ru == 8 else G, itemsize, floor=1)
    if K > k_lim:
        raise ValueError(
            f"bkt: collision chains exceed the VMEM cap ({K} > {k_lim}); "
            f"matrix structure unsuited to bkt_row_group={cfg.bkt_row_group}"
            " — try the other row group or csr/css")

    # group → member col-blocks, ghosts inherit their parent's members
    mem_tab = hm.zeros((G_tot, m), np.int32)
    mem_tab[:n_grp] = base_members
    gp = np.concatenate(ghost_parent) if ghost_parent else \
        np.zeros(0, np.int64)
    mem_tab[n_grp: n_grp + len(gp)] = base_members[gp]

    # ---- slot arrays (stage A) -----------------------------------------------
    slot = (bkt_grp * NU_pad + ub_e) * S + seq
    lane_a = hm.zeros(N, np.int64)                   # pad slots: lane 0
    src_a = hm.zeros(N, np.int8)                     # pad slots: member 0
    val_a = hm.zeros(N, cfg.np_dtype)
    rl_slot = hm.full(N, RL - 1, np.int64)           # pad slots sort/merge last
    lane_a[slot] = col_e % LANES
    src_a[slot] = j_e
    val_a[slot] = val_e
    rl_slot[slot] = rl_e

    # m member x-row ids per W_A-slot stream row (group-pure by alignment)
    row_grp = hm.arange(N // W_A) // ((NU_pad * S) // W_A)
    members_flat = hm.astype(mem_tab[row_grp].reshape(-1), np.int32)

    # ---- stage-B stream row of each run / slot --------------------------------
    def to_brow(u, prow):
        if ru == 1:
            return (u // 8) * (8 * G) + prow * 8 + (u % 8)
        return u * G + prow

    # hm1: per slot, the lane of its run's head − 1 (−1 at lane-0 heads)
    B_rows = NU_pad * G
    heads_b = hm.zeros((B_rows, LANES), bool)
    heads_b[:, 0] = True
    bs_p = hm.arange(G_tot) * S                      # bucket starts, any unit
    bs_units = np.repeat(np.arange(NU_pad, dtype=np.int64), G_tot)
    bs_pp = np.tile(bs_p, NU_pad)
    heads_b[to_brow(bs_units, bs_pp >> 7), bs_pp & 127] = True
    g_units = ub_e[o2[first]]
    heads_b[to_brow(g_units, p0 >> 7), p0 & 127] = True
    lane_grid = np.broadcast_to(np.arange(LANES, dtype=np.int64),
                                (B_rows, LANES))
    head_lane = np.maximum.accumulate(
        np.where(heads_b, lane_grid, -1), axis=1)
    hm1_b = hm.astype(head_lane - 1, np.int8)

    # ---- idx: K static routing planes ----------------------------------------
    er = to_brow(r_ub, r_prow)
    if ru == 1:
        blk = 8 * G
        n_blocks = NU_pad // 8
        idx_full = hm.full((n_blocks * K * blk, LANES), -1, np.int8)
        blk_i = er // blk
        row_in_blk = er % blk
        idx_full[(blk_i * K + chain) * blk + row_in_blk, r_bin] = r_el
    else:
        # slab-major, k-minor planes of (G, 128); entry σ·128 + end_lane
        idx_full = hm.full((NU_pad * K * G, LANES), -1, np.int16)
        slab_i = er // G
        row_in = er % G
        idx_full[(slab_i * K + chain) * G + row_in, r_bin % LANES] = \
            (r_bin // LANES) * LANES + r_el

    return with_routes(BKTState(
        n_row=n_row, n_col=n_col, nnz=nnz, rb_pad=RB_pad, cb=CB,
        g_tot=G_tot, s=S, g=G, k=K, m=m, n_slots=N, n_ghost=n_ghost,
        members=_t(members_flat),
        mem_tab=_t(mem_tab),
        lane=_t(hm.astype(lane_a.reshape(N // W_A, W_A), np.int8)),
        src=_t(src_a.reshape(N // W_A, W_A)),
        val=value_tensor(val_a.reshape(N // W_A, W_A), cfg.dtype),
        hm1=_t(hm1_b.reshape(NU_pad, G, LANES) if ru == 8 else hm1_b),
        idx=_t(idx_full.reshape(NU_pad, K, G, LANES) if ru == 8
               else idx_full),
        lo_a=_t(hm.astype(rl_slot.reshape(N // W_A, W_A), np.int32)),
        balanced=balanced, src_lane=src_lane, src_chunk=src_chunk,
        row_group=RL, n_chunks=n_chunks,
    ))


ROUTE_FIELDS = ("hm1r", "dest", "yrow", "parts")
DEST_NONE = -1
MERGE_ENDS = 8       # run ends a stream row, from which stage B merges
MERGE_ROWS = 4       # stream rows a warp of the merge kernel


def _unit_rows(state):
    """(nu_pad, sh, G, H): row units, stream rows a bucket, stream rows a
    unit and stream rows in all."""
    ru = state.row_group // LANES
    nu_pad = state.rb_pad // ru
    sh = state.s // LANES
    return nu_pad, sh, state.g_tot * sh, state.n_slots // LANES


def route_rows(state) -> dict:
    """{hm1r, dest, yrow, parts}: stage B's run-end destination
    stream, from the reference's arrays of ``state`` (``hm1``, ``idx``,
    ``src_lane``/``src_chunk``, the geometry; CPU tensors or numpy arrays).

    ``hm1r`` and ``dest`` are (H, 128), in stage A's own row order: row
    r = (c·nu_pad + n)·sh + j holds the j-th 128 slots of the bucket of
    col-group c and row unit n (sh = S / 128), so stage B takes the
    products in the order stage A makes them.  ``hm1r`` is ``hm1`` moved there
    from stage B's order (bkt_g: (NU_pad, G, 128) unit-major; bkt: the
    j-interleaved blocks of 8 units).  ``dest`` holds, at the slot e that
    ends a run, the run's row in its unit: for bkt_g the int16 σ·128 + l
    of the idx entry idx[n, k, c, l] = σ·128 + e (entries at or past 1024
    route nothing, as the TPU's eight σ masks); for bkt the int8 bin lane l
    of idx[(n // 8)·K·8G + k·8G + prow·8 + n % 8, l] = e (a row of unit n
    ends its runs in row-block n); −1 on every other slot.  ``yrow``
    ((rb_pad·128,) int32) maps unit row n·row_group + d to the row of y: the
    inverse of the balance permutation (identity when unbalanced), −1 at or
    past ``n_row``.  Raises ValueError on an end lane that the idx planes
    name twice.

    ``parts`` is what stage B can observe of the stream: where its rows end
    on average at least ``MERGE_ENDS`` runs and no row names a unit row
    twice, the blocks a unit (``MERGE_ROWS`` rows a warp) of the merge
    kernel, which sums a block's rows in shared memory and adds each y row
    once; else 0, a reduction into y a run end."""
    nu_pad, sh, g, h = _unit_rows(state)
    idx = np.asarray(state.idx)
    hm1 = np.asarray(state.hm1)
    it = np.int32 if h * state.row_group < 2 ** 31 else np.int64
    q = np.flatnonzero(idx.reshape(-1) >= 0)    # the routed entries
    e = idx.reshape(-1)[q].astype(it)
    lane = (q & (LANES - 1)).astype(it)         # the entry's bin lane
    q = (q >> 7).astype(it)                     # its row of the planes
    if state.row_group == 8 * LANES:
        k = idx.shape[1]                        # (NU_pad, K, G, 128)
        if (e >= 8 * LANES).any():
            keep = e < 8 * LANES
            q, e, lane = q[keep], e[keep], lane[keep]
        row = (q % g) * nu_pad + q // (k * g)
        end, d = e & (LANES - 1), (e & ~(LANES - 1)) + lane
        dest = np.full((h, LANES), DEST_NONE, np.int16)
        hm1r = hm1.reshape(nu_pad, g, LANES).transpose(1, 0, 2)
    else:
        k = idx.shape[0] // (nu_pad * g)        # (NU_pad / 8 · K · 8G, 128)
        blk = 8 * g
        row_in = q % blk
        n, prow = (q // (k * blk)) * 8 + row_in % 8, row_in // 8
        row = ((prow // sh) * nu_pad + n) * sh + prow % sh
        end, d = e, lane
        dest = np.full((h, LANES), DEST_NONE, np.int8)
        # stage B's row (n // 8)·8G + prow·8 + n % 8, prow = c·sh + j →
        # stage A's (c·nu_pad + n)·sh + j
        hm1r = (hm1.reshape(nu_pad // 8, state.g_tot, sh, 8, LANES)
                .transpose(1, 0, 3, 2, 4))
    flat = row * LANES + end
    dest.reshape(-1)[flat] = d
    if np.count_nonzero(dest != DEST_NONE) != len(flat):
        raise ValueError("bkt: an end lane is named twice in a stream row's "
                         "idx planes")
    parts = 0
    if len(flat) >= MERGE_ENDS * max(h, 1):
        # one plane names each unit row of a row at most once
        key = np.sort(row * state.row_group + d) if k > 1 else None
        if key is None or not (key[1:] == key[:-1]).any():
            parts = -(-g // (8 * MERGE_ROWS))
    n_rows = state.rb_pad * LANES
    if state.balanced:
        # inverse of the per-lane balance permutation, as to_coo builds it:
        # unit row new_rb·128 + lo is y row inv[lo, new_rb]·128 + lo
        src_col = (np.asarray(state.src_chunk).astype(np.int64) * LANES
                   + np.asarray(state.src_lane))
        inv = np.argsort(src_col, axis=1, kind="stable")[:, : state.rb_pad]
        yrow = (inv.T * LANES + np.arange(LANES)).reshape(-1)
    else:
        yrow = np.arange(n_rows, dtype=np.int64)
    yrow = np.where(yrow < state.n_row, yrow, -1).astype(np.int32)
    return dict(hm1r=_t(np.ascontiguousarray(hm1r).reshape(h, LANES)),
                dest=_t(dest), yrow=_t(yrow), parts=parts)


def with_routes(state: BKTState) -> BKTState:
    """``state`` with its stage-B stream from ``route_rows``."""
    return dataclasses.replace(state, **route_rows(state))


def adds_per_row(state: BKTState) -> np.ndarray:
    """(n_row,) int64: the run totals ``spmv`` adds into each y row, one a
    run end of stage B's ``dest`` stream.  On the card their order of
    addition is free (``core/oracle.py:reorder_bound``)."""
    nu_pad, sh = _unit_rows(state)[:2]
    rg = state.row_group
    d = to_host(state.dest).astype(np.int64)
    r, lane = np.nonzero((d >= 0) & (d < rg))
    unit = (r // sh) % nu_pad
    pos = to_host(state.yrow).astype(np.int64)[unit * rg + d[r, lane]]
    return np.bincount(pos[(pos >= 0) & (pos < state.n_row)],
                       minlength=state.n_row).astype(np.int64)


_ARRAY_FIELDS = ("members", "mem_tab", "lane", "src", "val", "hm1", "idx",
                 "lo_a", "src_lane", "src_chunk")


def state_from_reference(arrays: dict) -> BKTState:
    """The port's state from the fields of a reference ``BKTState``, as
    numpy arrays and scalars (``dataclasses.asdict`` of a reference state
    moved to the host)."""
    kw = {f.name: arrays.get(f.name) for f in dataclasses.fields(BKTState)
          if f.name not in ROUTE_FIELDS}     # derived below
    for name in _ARRAY_FIELDS:
        if kw[name] is not None:
            kw[name] = from_numpy(np.array(kw[name]))
    state = BKTState(**kw)
    _check_dtype(state.val.dtype)
    return with_routes(state)


# -------------------------------------------------------------------- spmv ---

def x_table(state: BKTState, x: torch.Tensor) -> torch.Tensor:
    """Stage A's (CB, 128) x table: x zero-padded to whole col-blocks."""
    xp = torch.zeros(state.cb * LANES, dtype=x.dtype, device=x.device)
    xp[: state.n_col] = x
    return xp.view(state.cb, LANES)


def stage_b_input(state: BKTState, prod: torch.Tensor) -> torch.Tensor:
    """Stage A's products as stage B reads them: the (G_tot, NU_pad, 128)
    group-major grid (grouped mode), or the rb-major, j-interleaved
    (NU_pad·G, 128) stream (128-row buckets; S is a multiple of 128, so this
    is a permute of whole rows)."""
    ru = state.row_group // LANES
    nu_pad = state.rb_pad // ru
    if ru == 8:
        return prod.view(state.g_tot, nu_pad, state.s)
    sh = state.s // LANES
    return (prod.view(state.g_tot, nu_pad // 8, 8, sh, LANES)
            .permute(1, 0, 3, 2, 4).reshape(nu_pad * state.g, LANES))


def y_table_t(state: BKTState, y_tab: torch.Tensor) -> torch.Tensor:
    """Stage B's (RB_pad, 128) row sums transposed into the (128, rbu)
    table that ``lane_unpermute`` takes."""
    rbu = state.src_lane.shape[1]
    y_t = torch.zeros(LANES, rbu, dtype=y_tab.dtype, device=y_tab.device)
    y_t[:, : state.rb_pad] = y_tab.T
    return y_t


def spmv_acc(state: BKTState, x: torch.Tensor) -> torch.Tensor:
    """Stage A's products (of the value type) and stage B into a float32
    y, in one launch."""
    _check_dtype(x.dtype)
    nu_pad, sh = _unit_rows(state)[:2]
    y = torch.zeros(state.n_row, dtype=torch.float32, device=x.device)
    return bucket_fused_rows(state.members, state.lane, state.src, state.val,
                             x_table(state, x), state.m, state.hm1r,
                             state.dest, state.yrow, y, sh, nu_pad,
                             state.parts)


def spmv(state: BKTState, x: torch.Tensor) -> torch.Tensor:
    """y = A x, rounded once to x's type."""
    return spmv_acc(state, x).to(x.dtype)


# ----------------------------------------------------------------- reports ---

def report_fields(state: BKTState, cfg: Config) -> dict:
    return {"RB": state.rb_pad, "ColGroups": state.g_tot,
            "GroupWidth": state.m, "SlotDepth": state.s,
            "ChainK": state.k, "GhostGroups": state.n_ghost,
            "PadFactor": round(state.n_slots / max(state.nnz, 1), 3)}


def traffic_bytes(state: BKTState, cfg: Config) -> int:
    vsz = value_size(cfg.dtype)
    slots = state.n_slots
    isz = 2 if state.row_group // LANES == 8 else 1
    src = slots if state.m > 1 else 0
    stage_a = slots * (1 + 2 * vsz) + src              # lane + src + val + out
    stage_b = slots * (vsz + 1) + state.k * slots * isz  # prod + hm1 + idx
    return stage_a + stage_b + state.n_row * vsz


def to_coo(state: BKTState) -> COOMatrix:
    """Inverse conversion (explicit zeros dropped — they pad like ghosts)."""
    def host(t):
        return to_host(t)

    val = host(state.val).reshape(-1).astype(np.float64)
    rl = host(state.lo_a).reshape(-1)
    N = state.n_slots
    ru = state.row_group // LANES
    nu_pad = state.rb_pad // ru
    slot_grp = np.arange(N) // (nu_pad * state.s)
    mem = host(state.mem_tab).astype(np.int64)
    j = host(state.src).reshape(-1).astype(np.int64)
    col = (mem[slot_grp, j] * LANES
           + host(state.lane).reshape(-1).astype(np.int64))
    group = (np.arange(N) % (nu_pad * state.s)) // state.s
    rows = group * state.row_group + rl
    if state.balanced:
        # invert the balance permutation: new_rb -> original rb, per lo class
        s_rb = rows // LANES
        lo = rows % LANES
        src_col = (host(state.src_chunk).astype(np.int64) * LANES
                   + host(state.src_lane))              # (128, RB_pad)
        inv = np.argsort(src_col, axis=1, kind="stable")
        rows = inv[lo, s_rb] * LANES + lo
    keep = val != 0
    rows, col, val = rows[keep], col[keep], val[keep]
    return COOMatrix.from_triplets(state.n_row, state.n_col, rows, col, val,
                                   sort=True, sum_duplicates=True)

