"""Distributed xch SpMV: the reference's ``singlespmv_tpu/parallel/xchd.py``,
the v4 exchange engine (``formats/xch.py``) run shard by shard.

The rows are cut into R contiguous spans at out-group grain (gb · 128 rows),
balanced by nnz; every shard converts its span with one common plan (m1 of
the first shard, m2, kblk, t1, t2, p_oh and gb fixed) over its column
footprint, the col-blocks [cb0, cb0 + cb_pad) of x.  x is split over "row"
(x_len / R a shard) and each shard assembles its footprint either from one
tiled ``all_gather`` or, where every footprint spans few owners' slices
(banded matrices), by a bidirectional ``ppermute`` ring of ``n_rounds``
(backward, forward) rounds that deposits the owners' slices into a buffer
guard-padded by one slice on each side, the owners it does not need left
out.  Both give the same table, so the same y bit for bit.

Each shard's spmv is the port's own xch spmv on its footprint: one
``xch_fused_rows`` a pass-2 call, which gathers the footprint at the
shard's ``col2``, multiplies by its ``val2`` in registers and adds the run
totals straight into the shard's y span of ``rows_per`` rows (no product
grid; the reference's scatter of visited groups has nothing left to do); y
is the spans placed at their first rows ``row0s``.  The reference refuses a shard whose layout
needs several Pallas calls; here such a shard runs its calls as
``xch.spmv`` does.  The reference pads every shard's arrays to common
stacked shapes for ``shard_map``; here each shard keeps its own.

float32, as the reference's operator runs.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import Config
from ..core.types import COOMatrix, cdiv, round_up
from ..formats import xch as xch_mod
from .spmv import as_input

LANES = 128
GB = 64           # 128-row blocks an out group: the cut grain


@dataclasses.dataclass
class DistXch:
    """Converted distributed exchange operator.

    Build with ``DistXch.convert(coo, cfg, mesh)``; apply with ``op(x)``."""

    mesh: object
    cfg: Config
    n_row: int
    n_col: int
    nnz: int
    R: int
    rows_per: int
    row0s: tuple             # per-shard first row (balanced contiguous cuts)
    cb0s: tuple              # per-shard footprint base col-block
    sub_nnz: tuple           # per-shard nnz
    m1: int
    m2: int
    t1: int
    t2: int
    kblk: int
    p_oh: int
    gb: int
    ng: int                  # out groups a shard's span
    cb_pad: int              # footprint col-blocks (+ window margin)
    x_len: int               # padded global x length (multiple of R·128)
    x_mode: str              # "ring" (ppermute rounds) | "allgather"
    n_rounds: tuple          # ring rounds (backward, forward owner reach)
    row_axis: str
    states: tuple            # the held shards' Xch4States, on the device

    @staticmethod
    def convert(coo: COOMatrix, cfg: Config, mesh, *,
                row_axis: str = "row") -> "DistXch":
        if cfg.dtype != "float32":
            raise ValueError(f"DistXch runs float32, not {cfg.dtype}")
        R = mesh.shape.get(row_axis, 1)
        if R != mesh.size:
            raise ValueError(f"mesh {mesh.shape} is not a 1-D {row_axis!r} "
                             "mesh")
        gb = GB
        grain = gb * LANES

        # the common plan from the whole matrix's closed form
        est = xch_mod.estimate_v4(coo, cfg, no_long=True)
        if not est.get("feasible", False):
            raise ValueError("distxch: infeasible plan")
        rows0 = np.asarray(coo.row, np.int64)
        cols0 = np.asarray(coo.col, np.int64)

        # nnz-balanced contiguous cuts at out-group grain: greedy prefix cut
        # at the nnz/R quantiles
        n_grain = cdiv(max(coo.n_row, 1), grain)
        gr_nnz = np.bincount(np.minimum(rows0 // grain, n_grain - 1),
                             minlength=n_grain).astype(np.float64)
        cum = np.cumsum(gr_nnz)
        total = max(cum[-1], 1.0)
        if n_grain < R:
            # fewer out-group grains than shards: trailing shards are empty
            bounds = [min(i, n_grain) for i in range(R)] + [n_grain]
        else:
            bounds = [0]
            for rshard in range(1, R):
                g = int(np.searchsorted(cum, total * rshard / R))
                bounds.append(int(np.clip(g + 1, bounds[-1] + 1,
                                          n_grain - (R - rshard))))
            bounds.append(n_grain)
        row0s = [b * grain for b in bounds[:-1]]
        ng = max(b1 - b0 for b0, b1 in zip(bounds[:-1], bounds[1:]))
        rows_per = ng * grain
        shard_of = np.searchsorted(np.asarray(row0s[1:] + [coo.n_row + 1]),
                                   rows0, side="right")
        sub_nnz = np.bincount(shard_of, minlength=R)
        kblk = int(est.get("kblk", 8))
        p_oh = min(int(est.get("p_oh", 16)), gb)
        m2 = xch_mod._align8(max(int(est.get("m2_hint", 8)), 1),
                             xch_mod.M2_CAP)
        plan = {"feasible": True, "route_v": 4,
                "k_slots": int(max(sub_nnz.max(), 16 * LANES)),
                "kblk": kblk, "kblk_fix": True,
                "p_oh": p_oh, "p_oh_fix": p_oh,
                "gb": gb, "gb_fix": True,
                "m2_fix": m2, "t1_fix": 128, "t2_fix": 64,
                "no_long": True, "no_peel": True, "no_refine": True}

        # per-shard column footprint (common width: the widest)
        cb0s, cb1s = [], []
        for r in range(R):
            m = shard_of == r
            cb0s.append(int(cols0[m].min()) >> 7 if m.any() else 0)
            cb1s.append((int(cols0[m].max()) >> 7) + 1 if m.any() else 1)
        cbn = max(b - a for a, b in zip(cb0s, cb1s))

        def shard_state(r, m1=None):
            m = shard_of == r
            lr = rows0[m] - row0s[r]
            lc = cols0[m] - cb0s[r] * LANES
            lv = np.asarray(coo.val)[m]
            if len(lr) == 0:            # an empty shard: one explicit zero
                lr = np.zeros(1, np.int64)
                lc = np.zeros(1, np.int64)
                lv = np.zeros(1, coo.val.dtype)
            sub = COOMatrix(n_row=rows_per, n_col=cbn * LANES,
                            row=lr, col=lc, val=lv)
            st = xch_mod._convert_v4(
                sub, cfg, plan if m1 is None else dict(plan, m1_fix=m1))
            if m1 is not None and st.m1 != m1:
                raise AssertionError("distxch: m1 drift across shards")
            return st

        states = [shard_state(0)]
        m1 = states[0].m1               # the first shard leads
        states += [shard_state(r, m1) for r in range(1, R)]

        cb_pad = states[0].cb_pad
        x_len = round_up(max(cb0s[r] * LANES + cb_pad * LANES
                             for r in range(R)) + LANES, R * LANES)

        # the x exchange: a ppermute ring where every footprint spans few
        # owners' slices, else one tiled all_gather.  Ring round k delivers
        # owner me − k (backward) and me + k (forward)
        L = x_len // R
        n_bwd = n_fwd = 0
        for r in range(R):
            if sub_nnz[r] == 0:
                continue        # an empty shard multiplies one 0 value
            lo = cb0s[r] * LANES
            hi = lo + cb_pad * LANES
            for o in range(R):
                if o * L < hi and o * L + L > lo:
                    n_bwd = max(n_bwd, max(r - o, 0))
                    n_fwd = max(n_fwd, max(o - r, 0))
        x_mode = "ring" if (R > 1 and n_bwd + n_fwd <= R - 2) else "allgather"

        held = [mesh.axis_index(s, row_axis) for s in mesh.shards]
        return DistXch(
            mesh=mesh, cfg=cfg, n_row=coo.n_row, n_col=coo.n_col,
            nnz=coo.nnz, R=R, rows_per=rows_per, row0s=tuple(row0s),
            cb0s=tuple(cb0s), sub_nnz=tuple(int(v) for v in sub_nnz), m1=m1,
            m2=states[0].m2, t1=states[0].t1, t2=states[0].t2, kblk=kblk,
            p_oh=states[0].p_oh, gb=gb, ng=ng, cb_pad=cb_pad, x_len=x_len,
            x_mode=x_mode, n_rounds=(n_bwd, n_fwd), row_axis=row_axis,
            states=tuple(states[r].to(mesh.device) for r in held))

    # ------------------------------------------------------------- the step

    def _held(self):
        return [self.mesh.axis_index(s, self.row_axis)
                for s in self.mesh.shards]

    def footprints(self, x: torch.Tensor) -> list:
        """Each held shard's footprint rows of x, (cb_pad·128,) + x's
        trailing dims: x (n_col,) or a panel (n_col, B), split over "row"
        and assembled by the operator's exchange."""
        mesh, axis, R = self.mesh, self.row_axis, self.R
        span, L = self.cb_pad * LANES, self.x_len // R
        xp = x.new_zeros((self.x_len,) + x.shape[1:])
        xp[: self.n_col] = x
        held = self._held()
        x_loc = [xp[r * L:(r + 1) * L] for r in held]
        fp0 = [self.cb0s[r] * LANES for r in held]
        if self.x_mode != "ring":
            x_all = mesh.all_gather(x_loc, axis)
            return [xa[f:f + span] for xa, f in zip(x_all, fp0)]
        # the bidirectional ring: the backward chain's round k delivers
        # owner me − k, the forward chain's owner me + k, each deposited
        # into a footprint buffer guard-padded by L on both sides where the
        # footprint needs it
        bufs = [xp.new_zeros((L + span + L,) + x.shape[1:]) for _ in held]

        def deposit(parts, k):
            for buf, xk, me, f in zip(bufs, parts, held, fp0):
                owner = (me + k) % R
                if owner * L < f + span and owner * L + L > f:
                    pos = owner * L - f + L
                    buf[pos:pos + L] = xk

        deposit(x_loc, 0)
        n_bwd, n_fwd = self.n_rounds
        for sign, n in ((-1, n_bwd), (1, n_fwd)):
            xk = x_loc
            for k in range(1, n + 1):
                xk = mesh.ppermute(
                    xk, [(i, (i - sign) % R) for i in range(R)], axis)
                deposit(xk, sign * k)
        return [buf[L:L + span] for buf in bufs]

    def _assemble(self, spans: list) -> torch.Tensor:
        """The whole y from the held shards' spans of rows_per rows: each
        span placed at its first row, in shard order (a later shard's span
        overwrites the empty tail of an earlier one's)."""
        y_sh = self.mesh.all_gather(spans, self.row_axis)[0]
        rp = self.rows_per
        y = y_sh.new_zeros((self.n_row + rp,) + y_sh.shape[1:])
        for r, r0 in enumerate(self.row0s):
            take = min(rp, self.n_row + rp - r0)
            y[r0:r0 + take] = y_sh[r * rp:r * rp + take]
        return y[: self.n_row]

    def step(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x for x (n_col,) float32 on the mesh's device."""
        spans = [xch_mod.spmv_acc(st, tab)
                 for st, tab in zip(self.states, self.footprints(x))]
        return self._assemble(spans).to(x.dtype)

    def __call__(self, x) -> torch.Tensor:
        return self.step(as_input(x, torch.float32, self.mesh.device))

    def spmm(self, X) -> torch.Tensor:
        """Y = A @ X for a (n_col, B) panel: each held shard's ``xch.spmm``
        on its assembled footprint panel (the panel kernels at B ≤ 16, the
        column loop above)."""
        X = as_input(X, torch.float32, self.mesh.device)
        spans = [xch_mod.spmm_acc(st, tab[: st.n_col])
                 for st, tab in zip(self.states, self.footprints(X))]
        return self._assemble(spans).to(X.dtype)
