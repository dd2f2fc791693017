"""ELLG — multi-level row-positional windows with a top-m member-block
gather: ``singlespmv_tpu/formats/ellg.py`` on the port's stage-A kernel.

Level 0 gives every 128-row block t₀ slots a row; each 128-slot row of the
stream (128/t consecutive matrix rows) gathers from its top-m column
blocks (m ∈ {1, 2, 4, 8}).  The entries a level misses (a row longer than
t, a column block outside the member budget) are packed into a fresh set
of windows at the next level, up to ``LEVELS_MAX``; what is left rides
bkt_g (bkt at 1024-row buckets) or csr.  Slots are row-positional (row r
owns t consecutive slots), so a level's y is one (−1, t) row sum.  x is
read from a (≤ ``X_BLOCKS``, 128) table; a matrix wider than
``X_BLOCKS``·128 columns is cut into column panels, and a (level, panel)
pair is one pass over its own x slice.

The host planner (``_plan``, ``_sim_level``, ``_level_route``,
``estimate``) and the pass builder (``_build_passes``) are copies of the
reference's, so one COO gives the same passes array for array, priced by
the reference's v5e rates (``RATE``, ``TAIL_RATE``, ``SCATTER_RATE``,
``PASS_FIXED_S``; their refit for the card is ROADMAP A.7b).

spmv: one CUDA kernel, ``ops/bucket.py:ellg_rows``, runs every pass of the
state: each pass's products (the Pallas ``block_gather_mul`` at ``gran`` =
128, ``ops/pallas/bucket.py:91``, as the reference calls it, on the pass's
panel of the zero-padded x) are made in registers, each matrix row's t
slots summed, and the sum added into y at the row's block (the pass's
own block where it is ``full``, ``blocks`` where not), as the reference
adds its (−1, t) row sums into its (RB, 128) y table; the rest's spmv is
added last.  ``row_passes`` hands the kernel the passes as its table of
tensors and scalars (``ops/bucket.py:RowPass``).  A pass of one member
carries no ``src`` (None, as in the reference), and the kernel gets a null
pointer for it.  The first port of the passes, stage A at gran 128
(``block_gather_mul``) then the row sums and the adds in torch, is
``ellg_rows``' plain version with the kernel for stage A.
``spmm`` is the column loop of the spmv, as the reference vmaps it.  The
reference's ellg refuses every value type its Pallas kernels lack, so the
port runs float32 and bfloat16 (at bfloat16 each product is rounded once
to bfloat16, as stage A stores it, and the row sums, y and the rest's y
are float32, y rounded once) and refuses float64.  auto never offers ellg, as in the
reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..core import hostmem as hm
from ..core.dtypes import (acc_dtype, from_numpy, name_of, to_host,
                           value_size, value_tensor)
from ..core.types import COOMatrix, cdiv
from ..ops.bucket import RowPass, ellg_rows
from . import bkt as bkt_mod
from . import csr as csr_mod
from .base import TensorState, acc_spmv, column_loop, state_from_arrays
from .slab import _t

STATE_REV = 1   # bump with a change of the layout (formats/cache.py)
LANES = 128
W_A = 1024
TILE_SLOTS = 8 * W_A       # one stage-A grid step of the reference
X_BLOCKS = 16384           # col-blocks per x panel (reference: a VMEM slice)
LEVELS_MAX = 3
PAD_LIMIT = 8.0            # total slots / nnz bound
# the reference's block_gather_mul rates (G slot/s) on a TPU v5e
RATE = {1: 57e9, 2: 44e9, 4: 30e9, 8: 19.4e9}
TAIL_RATE = 3.5e9          # bkt_g residue throughput ballpark
SCATTER_RATE = 14.4e9      # XLA 128-row-block scatter-add
PASS_FIXED_S = 12e-6
REST_MODULES = {"bkt_g": bkt_mod, "csr": csr_mod}   # the rest's engines


def _check_dtype(dtype) -> None:
    name = name_of(dtype)
    if name not in bkt_mod.VALUE_TYPES:
        raise TypeError(f"ellg runs the float32 and bfloat16 stage-A kernels "
                        f"only, as the reference's ellg runs only where its "
                        f"Pallas kernels do; not {name}")


@dataclasses.dataclass(frozen=True)
class ELLGPass(TensorState):
    t: int                 # slots per row
    m: int                 # member col-blocks per 128-slot stream row
    n_blocks: int          # 128-row blocks in this pass (incl. tile padding)
    panel_base: int        # first col-block of the x panel
    panel_cb: int          # col-blocks in the x panel slice
    full: bool             # blocks == arange(n_blocks) (level-0 fast path)
    members: torch.Tensor  # (n_blocks·t·m,) int32 — panel-local col-blocks
    lane: torch.Tensor     # (H, W_A) int8 — in-block column
    src: Optional[torch.Tensor]   # (H, W_A) int8 member index; None if m == 1
    val: torch.Tensor      # (H, W_A) float32
    blocks: Optional[torch.Tensor]   # (n_blocks,) int32; None if full


@dataclasses.dataclass(frozen=True)
class ELLGState(TensorState):
    n_row: int
    n_col: int
    nnz: int
    rest_fmt: str          # "" | "bkt_g" | "csr"
    rest_nnz: int
    n_slots: int
    n_levels: int
    passes: tuple          # tuple[ELLGPass]
    rest_state: object = None


# ------------------------------------------------------------------ planning -

def _t_candidates(deg_nz: np.ndarray, prev_t: int | None) -> list:
    """Power-of-two window sizes worth trying for one level."""
    if not len(deg_nz):
        return [1]
    cands = set()
    for q in (50, 90):
        p = max(1.0, float(np.percentile(deg_nz, q)))
        cands.add(min(128, 1 << int(np.ceil(np.log2(p)))))
    if prev_t is not None:
        cands.add(max(1, prev_t // 2))
        cands.add(max(1, prev_t // 4))
    return sorted(cands)


def _sim_level(r_s, c_s, start, t, m, n_row, CBtot):
    """Exact kept count + geometry for one (t, m) candidate.

    r_s/c_s sorted by (row, col); start = CSR row starts of the remaining set.
    Returns (kept, n_blocks, slots).
    """
    m_e = len(r_s)
    within = hm.arange(m_e) - start[r_s]
    fits = within < t
    rb = r_s >> 7
    act = np.unique(rb)
    bpos = np.searchsorted(act, rb)
    rpl = LANES // t
    sr = bpos * t + ((r_s & 127) // rpl)
    cb = c_s >> 7
    panel = cb // X_BLOCKS
    n_panels = cdiv(CBtot, X_BLOCKS)
    if n_panels > 1:
        key_p = sr * n_panels + panel
        up, cnt = np.unique(key_p[fits], return_counts=True)
        us = up // n_panels
        o = np.lexsort((-cnt, us))
        fm = np.ones(len(o), bool)
        fm[1:] = us[o][1:] != us[o][:-1]
        best_panel = np.zeros(int(sr.max(initial=0)) + 1, np.int64)
        best_panel[us[o][fm]] = up[o][fm] % n_panels
        pok = fits & (best_panel[sr] == panel)
    else:
        pok = fits
    key = sr * np.int64(CBtot) + cb
    up, cnt = np.unique(key[pok], return_counts=True)
    us = up // CBtot
    o = np.lexsort((-cnt, us))
    us_o = up[o] // CBtot
    fm = np.ones(len(o), bool)
    if len(o):
        fm[1:] = us_o[1:] != us_o[:-1]
    rank = np.arange(len(o)) - np.maximum.accumulate(
        np.where(fm, np.arange(len(o)), -1))
    ok = rank < m
    sel = up[o][ok]
    sel.sort()
    if len(sel):
        p = np.clip(np.searchsorted(sel, key), 0, len(sel) - 1)
        hit = pok & (sel[p] == key)
    else:
        hit = pok & False
    n_blocks = len(act)
    slots = n_blocks * 128 * t
    return int(hit.sum()), n_blocks, slots


def _plan(r_s, c_s, n_row, CBtot, nnz, sample_cap=1 << 21,
          exact_advance=False):
    """Choose (t, m) per level; returns plans + estimated seconds + residue.

    Candidate (t, m) scoring always runs on a stride sample; with
    ``exact_advance`` the remaining set between levels is advanced exactly
    (convert path), otherwise the sample itself advances (cheap estimate
    path, residues scaled back by the stride)."""
    plans = []
    total_s = 0.0
    total_slots = 0
    m_e0 = len(r_s)
    stride = 1 if exact_advance else max(1, m_e0 // sample_cap)
    rem_r, rem_c = (r_s, c_s) if exact_advance else \
        (r_s[::stride], c_s[::stride])
    prev_t = None
    for lvl in range(LEVELS_MAX):
        m_e = len(rem_r)
        if m_e == 0:
            break
        sub = max(1, m_e // sample_cap)
        rr, cc = rem_r[::sub], rem_c[::sub]
        deg_s = np.bincount(rr, minlength=n_row)
        start_s = hm.zeros(n_row + 1, np.int64)
        np.cumsum(deg_s, out=start_s[1:])
        deg_nz = deg_s[deg_s > 0] * sub
        best = None
        for t in _t_candidates(deg_nz, prev_t):
            for m in (1, 2, 4, 8):
                if m > 1 and CBtot == 1:
                    continue
                kept, n_blocks, slots = _sim_level(
                    rr, cc, start_s, t, m, n_row, CBtot)
                kept *= sub
                dt = (slots / RATE[m] + n_blocks * 128 / SCATTER_RATE
                      + PASS_FIXED_S)
                score = dt + (m_e - kept) / TAIL_RATE
                if best is None or score < best[0]:
                    best = (score, t, m, kept, slots, dt)
        _, t, m, kept, slots, dt = best
        if kept <= 0 or (m_e > 4096 and kept < m_e // 20):
            break                      # this level wouldn't pull its weight
        plans.append((t, m))
        total_s += dt
        total_slots += slots
        prev_t = t
        deg_full = np.bincount(rem_r, minlength=n_row)
        start_f = hm.zeros(n_row + 1, np.int64)
        np.cumsum(deg_full, out=start_f[1:])
        hit, _ = _level_route(rem_r, rem_c, start_f, t, m, n_row, CBtot)
        rem_r, rem_c = rem_r[~hit], rem_c[~hit]
    rest = len(rem_r) * stride
    total_s += rest / TAIL_RATE
    return plans, total_s, rest, total_slots


def _level_route(r_s, c_s, start, t, m, n_row, CBtot):
    m_e = len(r_s)
    within = hm.arange(m_e) - start[r_s]
    fits = within < t
    rb = r_s >> 7
    act = np.unique(rb)
    bpos = np.searchsorted(act, rb)
    rpl = LANES // t
    sr = bpos * t + ((r_s & 127) // rpl)
    cb = c_s >> 7
    n_sr = len(act) * t
    panel = cb // X_BLOCKS
    n_panels = cdiv(CBtot, X_BLOCKS)
    sr_panel = hm.zeros(n_sr, np.int64)
    if n_panels > 1:
        key_p = sr * n_panels + panel
        up, cnt = np.unique(key_p[fits], return_counts=True)
        us = up // n_panels
        o = np.lexsort((-cnt, us))
        fm = np.ones(len(o), bool)
        fm[1:] = us[o][1:] != us[o][:-1]
        sr_panel[us[o][fm]] = up[o][fm] % n_panels
        pok = fits & (sr_panel[sr] == panel)
    else:
        pok = fits
    key = sr * np.int64(CBtot) + cb
    up, cnt = np.unique(key[pok], return_counts=True)
    o = np.lexsort((-cnt, up // CBtot))
    up_o = up[o]
    us_o = up_o // CBtot
    fm = np.ones(len(o), bool)
    if len(o):
        fm[1:] = us_o[1:] != us_o[:-1]
    rank = np.arange(len(o)) - np.maximum.accumulate(
        np.where(fm, np.arange(len(o)), -1))
    ok = rank < m
    sel_key = up_o[ok]
    sel_rank = rank[ok]
    so = np.argsort(sel_key, kind="stable")
    sel_key = sel_key[so]
    sel_rank = sel_rank[so]
    if len(sel_key):
        p = np.clip(np.searchsorted(sel_key, key), 0, len(sel_key) - 1)
        hit = pok & (sel_key[p] == key)
        src = np.where(hit, sel_rank[np.minimum(p, len(sel_rank) - 1)], 0)
    else:
        hit = pok & False
        src = np.zeros(m_e, np.int64)
    # members table: (n_sr, m) panel-local col-blocks
    members = hm.zeros((n_sr, m), np.int64)
    sr_sel = sel_key // CBtot
    members[sr_sel, sel_rank] = (sel_key % CBtot) - sr_panel[sr_sel] * X_BLOCKS
    aux = dict(act=act, bpos=bpos, sr=sr, within=within, src=src,
               members=members, sr_panel=sr_panel, n_panels=n_panels)
    return hit, aux


# ------------------------------------------------------------------ estimate -

def estimate(coo: COOMatrix, cfg: Config) -> dict:
    """Convert-free plan for formats.auto: simulated level cascade on a
    stride sample, exact member-budget accounting per level."""
    n, nnz = coo.n_row, coo.nnz
    if nnz == 0 or n == 0:
        return {"est_s": 0.0, "rest_nnz": 0, "slots": 0, "feasible": False}
    rows = hm.astype(coo.row, np.int64)
    cols = hm.astype(coo.col, np.int64)
    o = np.lexsort((cols, rows))
    CBtot = cdiv(max(coo.n_col, 1), LANES)
    plans, est_s, rest, slots = _plan(rows[o], cols[o], n, CBtot, nnz)
    feasible = (len(plans) > 0 and slots <= PAD_LIMIT * nnz + (1 << 16)
                and rest <= nnz // 2)
    return {"est_s": est_s, "rest_nnz": rest, "slots": slots,
            "feasible": feasible, "plans": plans}


# ------------------------------------------------------------------- convert -

def convert(coo: COOMatrix, cfg: Config) -> ELLGState:
    """Plans and builds the passes on the host; tensors come back on the
    CPU."""
    _check_dtype(cfg.dtype)
    n_row, n_col, nnz = coo.n_row, coo.n_col, coo.nnz
    CBtot = cdiv(max(n_col, 1), LANES)
    dtype = cfg.np_dtype

    rows = hm.astype(coo.row, np.int64)
    cols = hm.astype(coo.col, np.int64)
    vals = hm.astype(coo.val, dtype)
    o = np.lexsort((cols, rows)) if nnz else np.zeros(0, np.int64)
    r_s, c_s, v_s = rows[o], cols[o], vals[o]

    plans, _, _, _ = _plan(r_s, c_s, n_row, CBtot, max(nnz, 1))
    if not plans and nnz:
        raise ValueError("ellg: no level plan pulls its weight; structure "
                         "unsuited to windowed packing")

    passes = []
    for lvl, (t, m) in enumerate(plans):
        if not len(r_s):
            break
        deg = np.bincount(r_s, minlength=n_row)
        start = hm.zeros(n_row + 1, np.int64)
        np.cumsum(deg, out=start[1:])
        hit, aux = _level_route(r_s, c_s, start, t, m, n_row, CBtot)
        if int(hit.sum()) == 0:
            break
        passes.extend(_build_passes(
            r_s, c_s, v_s, hit, aux, t, m, CBtot, dtype, cfg.dtype))
        r_s, c_s, v_s = r_s[~hit], c_s[~hit], v_s[~hit]
    total_slots = sum(p.n_blocks * 128 * p.t for p in passes)

    if total_slots > PAD_LIMIT * max(nnz, 1) + (1 << 16):
        raise ValueError(
            f"ellg: {total_slots} slots vs nnz {nnz} exceeds PAD_LIMIT")

    # ---- residue ----------------------------------------------------------
    rest_nnz = len(r_s)
    rest_fmt = ""
    rest_state = None
    if rest_nnz:
        rcoo = COOMatrix.from_triplets(n_row, n_col, r_s, c_s,
                                       v_s.astype(np.float64), sort=True)
        if rest_nnz <= max(1024, nnz // 256):
            rest_state = csr_mod.convert(rcoo, cfg)
            rest_fmt = "csr"
        else:
            try:
                rest_state = bkt_mod.convert(
                    rcoo, cfg.replace(format="bkt", bkt_row_group=1024))
                rest_fmt = "bkt_g"
            except (ValueError, TypeError):
                if rest_nnz > max(nnz // 20, 1 << 14):
                    raise ValueError(
                        f"ellg: rest {rest_nnz}/{nnz} entries would ride the "
                        "csr gather path; structure unsuited to ellg")
                rest_state = csr_mod.convert(rcoo, cfg)
                rest_fmt = "csr"

    return ELLGState(
        n_row=n_row, n_col=n_col, nnz=nnz, rest_fmt=rest_fmt,
        rest_nnz=rest_nnz, n_slots=total_slots, n_levels=len(plans),
        passes=tuple(passes), rest_state=rest_state)


def _build_passes(r_s, c_s, v_s, hit, aux, t, m, CBtot, dtype, vtype):
    """Materialize one level's kept entries into per-panel ELLGPass arrays
    (host values of ``dtype``, tensors of the value type ``vtype``)."""
    act, bpos, sr = aux["act"], aux["bpos"], aux["sr"]
    within, src, members = aux["within"], aux["src"], aux["members"]
    sr_panel, n_panels = aux["sr_panel"], aux["n_panels"]
    n_blocks_act = len(act)

    out = []
    for p in range(n_panels):
        # blocks whose sublane rows live in panel p (a block belongs to the
        # panel of ANY of its sublane rows; rows split across panels appear in
        # both, each carrying only its own panel's windows)
        blk_of_sr = hm.arange(n_blocks_act * t) // t
        sr_in_p = sr_panel[:n_blocks_act * t] == p
        blocks_mask = np.zeros(n_blocks_act, bool)
        blocks_mask[np.unique(blk_of_sr[sr_in_p])] = True
        if n_panels == 1:
            blocks_mask[:] = True
        if not blocks_mask.any():
            continue
        blist = np.nonzero(blocks_mask)[0]          # positions into act
        n_b = len(blist)
        n_b_pad = n_b
        # pad so slots fill whole (8, W_A) tiles
        while (n_b_pad * t * 128) % TILE_SLOTS:
            n_b_pad += 1
        N = n_b_pad * 128 * t
        ppos = np.full(n_blocks_act + 1, -1, np.int64)
        ppos[blist] = np.arange(n_b)

        ent = hit & (sr_panel[sr] == p) if n_panels > 1 else hit
        lo = r_s & 127
        slot = (ppos[bpos[ent]] * 128 + lo[ent]) * t + within[ent]
        lane_a = hm.zeros(N, np.int8)
        val_a = hm.zeros(N, dtype)
        lane_a[slot] = (c_s[ent] & 127).astype(np.int8)
        val_a[slot] = v_s[ent]
        src_a = None
        if m > 1:
            src_a = hm.zeros(N, np.int8)
            src_a[slot] = src[ent].astype(np.int8)

        mem_p = hm.zeros((n_b_pad * t, m), np.int64)
        sel_sr = sr_in_p & (ppos[blk_of_sr] >= 0)
        mem_p[ppos[blk_of_sr[sel_sr]] * t + (np.nonzero(sel_sr)[0] % t)] = \
            members[:n_blocks_act * t][sel_sr]
        panel_cb = min(X_BLOCKS, CBtot - p * X_BLOCKS)
        mem_p = np.clip(mem_p, 0, max(panel_cb - 1, 0))

        blocks_ids = act[blist]
        full = bool(n_panels == 1
                    and np.array_equal(blocks_ids, np.arange(n_b)))
        H = N // W_A
        out.append(ELLGPass(
            t=t, m=m, n_blocks=n_b_pad, panel_base=p * X_BLOCKS,
            panel_cb=panel_cb, full=full,
            members=_t(hm.astype(mem_p.reshape(-1), np.int32)),
            lane=_t(lane_a.reshape(H, W_A)),
            src=(_t(src_a.reshape(H, W_A)) if m > 1 else None),
            val=value_tensor(val_a.reshape(H, W_A), vtype),
            blocks=(None if full else _t(
                hm.astype(np.concatenate([blocks_ids,
                                          np.zeros(n_b_pad - n_b,
                                                   np.int64)]), np.int32))),
        ))
    return out


_PASS_ARRAYS = ("members", "lane", "src", "val", "blocks")


def state_from_reference(arrays: dict) -> ELLGState:
    """The port's state from the fields of a reference ``ELLGState``, as
    numpy arrays and scalars: ``passes`` a tuple of dicts of an
    ``ELLGPass``'s fields, ``rest_state`` the dict that the rest format's
    ``state_from_reference`` takes (``bkt``'s), or for a csr rest the
    reference's ``CSRState`` fields."""
    passes = []
    for p in arrays["passes"]:
        kw = dict(p)
        for name in _PASS_ARRAYS:
            if kw[name] is not None:
                kw[name] = from_numpy(np.array(kw[name]))
        passes.append(ELLGPass(**kw))
    rest = arrays.get("rest_state")
    if arrays["rest_fmt"] == "bkt_g":
        rest = bkt_mod.state_from_reference(rest)
    elif arrays["rest_fmt"] == "csr":
        rest = state_from_arrays(csr_mod.CSRState, rest, "csr")
    state = ELLGState(
        **{k: arrays[k] for k in ("n_row", "n_col", "nnz", "rest_fmt",
                                  "rest_nnz", "n_slots", "n_levels")},
        passes=tuple(passes), rest_state=rest)
    for p in state.passes:
        _check_dtype(p.val.dtype)
    return state


# ---------------------------------------------------------------------- spmv -

def row_passes(passes) -> tuple:
    """The ``ELLGPass``es as ``ops/bucket.py:ellg_rows`` takes them
    (``RowPass``: a full pass carries no blocks).  Raises ``ValueError`` on
    a pass whose ``full`` and ``blocks`` disagree."""
    out = []
    for i, p in enumerate(passes):
        if p.full != (p.blocks is None):
            raise ValueError(f"pass {i}: a full pass carries no blocks, any "
                             "other pass its blocks")
        out.append(RowPass(p.t, p.m, p.panel_base, p.panel_cb, p.members,
                           p.lane, p.src, p.val, p.blocks))
    return tuple(out)


def spmv(state: ELLGState, x: torch.Tensor) -> torch.Tensor:
    _check_dtype(x.dtype)
    CBtot = cdiv(max(state.n_col, 1), LANES)
    xp = torch.zeros(CBtot * LANES, dtype=x.dtype, device=x.device)
    xp[: state.n_col] = x
    y = torch.zeros(state.n_row, dtype=acc_dtype(x.dtype), device=x.device)
    y = ellg_rows(row_passes(state.passes), xp, y)
    if state.rest_fmt:
        y = y + acc_spmv(REST_MODULES[state.rest_fmt])(state.rest_state, x)
    return y.to(x.dtype)


def spmm(state: ELLGState, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X, X (n_col, B): the column loop of the spmv."""
    return column_loop(spmv, state, X)


# ------------------------------------------------------------------- reports -

def report_fields(state: ELLGState, cfg: Config) -> dict:
    lv = [f"t{p.t}m{p.m}" for p in state.passes]
    return {"Levels": "+".join(lv) or "none",
            "RestFormat": (state.rest_fmt or "none").upper(),
            "RestNnz": state.rest_nnz,
            "PadFactor": round(state.n_slots / max(state.nnz, 1), 3)}


def adds_per_row(state: ELLGState) -> np.ndarray:
    """(n_row,) int64: the totals ``spmv`` adds into each y row in a free
    order on the card: one a pass whose blocks reach the row (its row sum,
    itself summed in a fixed order), then the rest's (bkt_g's run ends;
    one for a csr rest, whose row sums have a fixed order)."""
    n = state.n_row
    rb = cdiv(max(n, 1), LANES)
    reach = np.zeros(rb, np.int64)
    for p in state.passes:
        blocks = (np.arange(min(p.n_blocks, rb)) if p.full
                  else np.unique(to_host(p.blocks).astype(np.int64)))
        reach[blocks[blocks < rb]] += 1
    adds = np.repeat(reach, LANES)[:n]
    if state.rest_fmt == "bkt_g":
        adds = adds + bkt_mod.adds_per_row(state.rest_state)
    elif state.rest_fmt:
        adds = adds + 1
    return adds


def traffic_bytes(state: ELLGState, cfg: Config) -> int:
    vsz = value_size(cfg.dtype)
    main = 0
    for p in state.passes:
        per_slot = vsz + 1 + (1 if p.m > 1 else 0)
        main += p.n_blocks * 128 * p.t * per_slot + p.n_blocks * 128 * vsz
        main += p.n_blocks * p.t * p.m * 4
    main += state.n_row * vsz
    if state.rest_fmt == "bkt_g":
        return main + bkt_mod.traffic_bytes(state.rest_state, cfg)
    if state.rest_fmt == "csr":
        return main + state.rest_nnz * (vsz + 4)
    return main


def to_coo(state: ELLGState) -> COOMatrix:
    """Inverse conversion."""
    rows_l, cols_l, vals_l = [], [], []
    for p in state.passes:
        N = p.n_blocks * 128 * p.t
        val = to_host(p.val).reshape(-1)
        lane = p.lane.cpu().numpy().reshape(-1).astype(np.int64)
        mem = p.members.cpu().numpy().reshape(-1, p.m).astype(np.int64)
        src = (p.src.cpu().numpy().reshape(-1).astype(np.int64)
               if p.m > 1 else np.zeros(N, np.int64))
        sr = np.arange(N) // 128
        cb_local = mem[sr, src]
        col = (p.panel_base + cb_local) * 128 + lane
        if p.full:
            blocks = np.arange(p.n_blocks, dtype=np.int64)
        else:
            blocks = p.blocks.cpu().numpy().astype(np.int64)
        rr = blocks[np.arange(N) // (128 * p.t)] * 128 + \
            (np.arange(N) % (128 * p.t)) // p.t
        keep = val != 0
        rows_l.append(rr[keep])
        cols_l.append(col[keep])
        vals_l.append(val[keep])
    if state.rest_fmt:
        rc = REST_MODULES[state.rest_fmt].to_coo(state.rest_state)
        rows_l.append(rc.row.astype(np.int64))
        cols_l.append(rc.col.astype(np.int64))
        vals_l.append(rc.val)
    rows = np.concatenate(rows_l) if rows_l else np.zeros(0, np.int64)
    cols = np.concatenate(cols_l) if cols_l else np.zeros(0, np.int64)
    vals = np.concatenate(vals_l) if vals_l else np.zeros(0)
    return COOMatrix.from_triplets(state.n_row, state.n_col, rows, cols, vals,
                                   sort=True, sum_duplicates=True)
