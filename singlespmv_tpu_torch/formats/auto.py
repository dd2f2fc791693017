"""`auto` — structure-adaptive format selection, as in
``singlespmv_tpu/formats/auto.py``.

``estimate_costs`` is the reference's cost model, term for term, over the
engines the port has: dia, dense, bsr, css, bkt, bkt_g, slab, slab2, xch,
csr, ss and hyb.  It prices with the reference's v5e constants
(``core/chipconst.py``) until the planner is refit for the H100 (ROADMAP
A.7b), so its ranking is the reference's.  Which engines it offers at a
value type is the port's own rule (``supports``): bkt and bkt_g at float32
and bfloat16, as on the TPU; every other ported engine at float32,
float64 and bfloat16 (the reference's bfloat16 set: its Pallas engines,
whose kernels take bfloat16, and the closed forms).  At bfloat16 every
price reads 2-byte values, an SpMM plan (``spmm_b`` > 0) among them, and
``spmm`` runs the chosen engine's bfloat16 SpMM (its panel kernels where
its gates take the panel), each column of Y rounded once.  At
float64 css keeps the reference's df64 price (×4 on its kernel term, no
×20), though the port runs it on native fp64.  The reference offers xch
only where its Pallas kernels take the value type, which on the TPU
excludes float64, so its ×7 price of xch at float64 never ran on the chip;
the port offers xch at float64 with that ×7.

With ``cfg.spmm_b`` = B > 1 the model prices an SpMM over a B-column panel,
as the reference's does: dense and bsr by the panel's flops and the X
gather, slab and slab2 at B / 1.05 for B ≤ 32 (the panel kernel), every
other engine B×, and hyb's dia part B×.  The trials still time ``spmv``, as
the reference's do.  ``spmm`` runs the chosen engine's ``spmm``, or the
column loop of its ``spmv``.

``convert`` ranks by the model and, as the reference does on its chip, then
converts and times every candidate within ``TRIAL_SPREAD`` of the cheapest
(at most ``TRIAL_MAX``, up to ``TRIAL_NNZ_CAP`` nonzeros; the conversions
side by side in threads) and keeps the fastest, timing each by the driver's chained runner (CUDA graphs, the
median of marginals, ``_quick_bench``).  The trials run only on a CUDA
device; on the CPU, as the
reference off its chip, the model alone decides, so the tests are
deterministic.  A candidate that refuses with a guard error (``ValueError``,
``TypeError``, ``MemoryError``, a CUDA out-of-memory error) is skipped and
recorded in ``AutoState.failed``; a ``KernelError`` (a kernel that failed to
build or launch) is never skipped.  ``bkt_g`` is the internal name of bkt at
``bkt_row_group`` 1024.
"""
from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..config import Config
from ..core import chipconst as _cc
from ..core.dtypes import value_size, value_tensor
from ..core.types import COOMatrix
from . import bkt as bkt_mod
from . import bsr as bsr_mod
from . import csr as csr_mod
from . import css as css_mod
from . import dense as dense_mod
from . import dia as dia_mod
from . import hyb as hyb_mod
from . import slab as slab_mod
from . import ss as ss_mod
from . import xch as xch_mod
from .base import TensorState, module_spmm

STATE_REV = 1   # bump with a change of AutoState; cache.py folds in
#                 every engine's rev
HBM_BPS = _cc.get("hbm_bps")               # streamed bytes/s achieved
SCATTER_RATE = _cc.get("scatter_rate")     # XLA gather/scatter elements/s
LANE_GATHER_RATE = _cc.get("lane_gather_rate")   # fused css stream elem/s
MXU_FLOPS = _cc.get("mxu_flops")           # effective f32 matmul flops/s

TRIAL_NNZ_CAP = 20_000_000   # past this a spare conversion costs minutes
TRIAL_SPREAD = 2.5           # try every candidate within this factor of the
#                              cheapest estimate
TRIAL_MAX = 3                # at most this many measured candidates
TRIAL_WINDOW_S = 0.35        # each timed loop of a trial lasts at least this

# the refusals on which a candidate is skipped; KernelError is not one
GUARD_ERRORS = (ValueError, TypeError, MemoryError, torch.cuda.OutOfMemoryError)

_MODULES = {"dia": dia_mod, "dense": dense_mod, "bsr": bsr_mod,
            "css": css_mod, "bkt": bkt_mod, "bkt_g": bkt_mod,
            "hyb": hyb_mod, "csr": csr_mod, "ss": ss_mod, "slab": slab_mod,
            "slab2": slab_mod, "xch": xch_mod}


def supports(fmt: str, dtype: str) -> bool:
    """Whether the port offers engine ``fmt`` at value type ``dtype``."""
    if fmt in ("bkt", "bkt_g"):
        return dtype in ("float32", "bfloat16")
    return dtype in ("float32", "float64", "bfloat16")


def _stats(coo: COOMatrix, cfg: Config):
    """The reference's structure statistics."""
    vsz = value_size(cfg.dtype)
    # past 20 M nnz, a contiguous-slice sample scaled by the sampling factor
    SAMP = 20_000_000
    if coo.nnz > SAMP:
        step = coo.nnz // (SAMP // 4)
        row = coo.row[::step].astype(np.int64)
        col = coo.col[::step].astype(np.int64)
        scale = coo.nnz / len(row)
    else:
        row = coo.row.astype(np.int64)
        col = coo.col.astype(np.int64)
        scale = 1.0
    n_diag = int(len(np.unique(col - row)) * scale) if coo.nnz else 1
    bm, bn = max(8, cfg.row_block), cfg.lane_width
    blocks = int(len(np.unique((row // bm) * (2 ** 32) + col // bn))
                 * scale) if coo.nnz else 1
    # css combine slots ≈ (row, col-block) runs; pad ≈ half a tile per
    # nonempty column block (tile = 8·W_eff, W_eff ~ the average block / 8)
    if coo.nnz:
        cb = col // 128
        runs = int(len(np.unique(row * (2 ** 32) + cb)) * scale)
        n_cb = max(int(len(np.unique(cb)) * min(scale, 4.0)), 1)
        w_eff = max(128, -(-int(coo.nnz / n_cb / 8) // 128) * 128)
        css_stream = coo.nnz + n_cb * 4 * w_eff
    else:
        runs, css_stream = 1, 1
    return vsz, n_diag, blocks, runs, css_stream


def bkt_seconds(slots, k, idx_b, vsz, extra_sec=0.0):
    """The reference's bkt price: stage A streams lane, val and the product
    and lane-gathers; stage B streams product, hm1 and idx and takes the
    MXU prefix."""
    stage_a = slots * (1 + 2 * vsz) / HBM_BPS + slots / 40e9
    stage_b = (slots * (vsz + 1 + idx_b * k) / HBM_BPS
               + slots * 256 / MXU_FLOPS)
    return stage_a + stage_b + extra_sec


def estimate_costs(coo: COOMatrix, cfg: Config, plans: dict = None,
                   _inner: bool = False, skip=()) -> dict:
    """Seconds per SpMV by engine (per SpMM of ``cfg.spmm_b`` columns where
    that is > 1), the reference's model
    (``singlespmv_tpu/formats/auto.py:77-283``) over the ported engines.

    ``plans`` collects the slab and xch plans so convert can reuse them;
    ``_inner`` marks the recursive call that prices hyb's residual;
    ``skip`` names engines not to price (hyb's residual chooser skips
    hyb)."""
    vsz, n_diag, blocks, runs, css_stream = _stats(coo, cfg)
    n, m, nnz = coo.n_row, coo.n_col, max(coo.nnz, 1)
    dt = cfg.dtype
    costs = {}
    dia_elems = n_diag * max(n, 1)
    if dia_elems * vsz <= (4 << 30):      # matches dia.MAX_DIA_ELEMENTS
        costs["dia"] = 2 * dia_elems * vsz / HBM_BPS
    dense_elems = n * m
    if dense_elems * vsz <= (1 << 30):
        costs["dense"] = dense_elems * vsz / HBM_BPS
    bm, bn = max(8, cfg.row_block), cfg.lane_width
    costs["bsr"] = blocks * bm * bn * vsz / HBM_BPS + blocks * 1e-8
    if css_stream <= 8 * nnz + (1 << 16) and supports("css", dt):
        # mirrors css's padding guard; the combine is bounded by the stream
        combine_slots = min(css_stream, 8 * runs)
        dff = 4.0 if dt == "float64" else 1.0    # the reference's df64 price
        costs["css"] = (dff * css_stream / LANE_GATHER_RATE
                        + 2 * combine_slots / SCATTER_RATE
                        + css_stream * (vsz + 4) / HBM_BPS)

    # hyper-sparse giant class: the windowed engines' sampled estimators are
    # skipped (they lose to xch there and cost minutes to run)
    hyper_sparse = (not _inner and nnz / max(n, 1) < 12 and n >= 500_000)

    if (coo.nnz and coo.nnz <= 8_000_000 and not hyper_sparse
            and supports("bkt", dt)):
        est = bkt_mod.estimate(coo, cfg)
        if est["feasible"]:
            # ru=1 pays the group → rb relayout (row-granular)
            costs["bkt"] = bkt_seconds(est["slots"], min(est["k_est"], 8), 1,
                                       vsz, extra_sec=est["slots"] / 140e9)
        est_g = bkt_mod.estimate(coo, cfg.replace(bkt_row_group=1024))
        if est_g["feasible"]:
            sel = est_g["slots"] * (est_g["m"] - 1) / 200e9
            costs["bkt_g"] = bkt_seconds(est_g["slots"], est_g["k_est"], 2,
                                         vsz, extra_sec=sel)
    if coo.nnz and not hyper_sparse and supports("slab", dt):
        est_sl = slab_mod.estimate(coo, cfg)
        if est_sl["feasible"]:
            costs["slab"] = est_sl["est_s"]
            if plans is not None:
                plans["slab"] = est_sl
            # the runner-up route family: a distinct candidate for the trials
            alt = est_sl.get("alt")
            if alt is not None and alt.get("feasible"):
                costs["slab2"] = alt["est_s"]
                if plans is not None:
                    plans["slab2"] = alt
    if coo.nnz and supports("xch", dt):
        est_x = xch_mod.estimate(coo, cfg)
        if est_x["feasible"]:
            costs["xch"] = est_x["est_s"]
            if plans is not None:
                plans["xch"] = est_x
    # csr and ss: the fallbacks that run every value type on every structure
    costs["csr"] = nnz / SCATTER_RATE + (nnz * (vsz + 4) + n * vsz) / HBM_BPS
    if supports("ss", dt):
        costs["ss"] = 1.05 * costs["csr"]     # the same gather + a scan pass

    # SpMM: a B-column panel amortizes the index streams; dense and bsr grow
    # by the panel flops and the X gather, slab by the panel kernel's
    # measured (on the TPU) 1.05 over B spmvs, the rest B×
    if cfg.spmm_b and cfg.spmm_b > 1:
        b = cfg.spmm_b
        for k in list(costs):
            if k == "dense":
                costs[k] = (dense_elems * vsz / HBM_BPS
                            + dense_elems * b * 2.0 / MXU_FLOPS)
            elif k == "bsr":
                costs[k] = (blocks * bm * bn * vsz / HBM_BPS      # A once
                            + blocks * bn * b * vsz / HBM_BPS     # X gather
                            + blocks * bm * bn * b * 2.0 / MXU_FLOPS
                            + blocks * 1e-8)
            elif k in ("slab", "slab2") and b <= 32:
                costs[k] = costs[k] * b / 1.05
            else:
                costs[k] = costs[k] * b

    if not _inner and not hyper_sparse and "hyb" not in skip:
        bscale = max(cfg.spmm_b, 1)     # hyb's dia part runs B spmvs
        est_h = hyb_mod.estimate(coo, cfg)
        if est_h["feasible"]:
            if est_h["resid_nnz"] == 0:
                # pure-diagonal matrix: offered only when dia is infeasible
                if "dia" not in costs:
                    costs["hyb"] = bscale * est_h["dia_sec"]
            else:
                peel_offs, _ = hyb_mod.plan_peel(coo, cfg)
                _, rest = hyb_mod._split(coo, peel_offs, cfg)
                rcosts = estimate_costs(rest, cfg, _inner=True)
                rbest = min((v for k, v in rcosts.items()
                             if k in hyb_mod.REST_MODULES or k == "csr"),
                            default=None)
                if rbest is not None:
                    # two-engine fixed tax: dia dispatch + the y-add pass
                    costs["hyb"] = bscale * est_h["dia_sec"] + rbest + 80e-6

    if hyper_sparse:
        for k in ("slab", "hyb", "bkt", "bkt_g"):
            if k in costs:
                costs[k] *= 1.35

    if dt == "float64":
        # the reference's TPU prices at float64: emulated f64 ×20 except
        # its df64 engines, xch-df64 ×7
        for k in costs:
            if k not in ("css", "slab", "slab2", "xch"):
                costs[k] *= 20.0
        if "xch" in costs:
            costs["xch"] *= 7.0
    for k in skip:
        costs.pop(k, None)
    return costs


def choose(coo: COOMatrix, cfg: Config) -> str:
    costs = estimate_costs(coo, cfg)
    return min(costs, key=costs.get)


@dataclasses.dataclass(frozen=True)
class AutoState(TensorState):
    """The chosen engine's name and state, with what the choice saw."""
    chosen: str
    inner: TensorState
    costs: tuple = ()     # (engine, estimated seconds), cheapest first
    trials: tuple = ()    # (engine, measured seconds per spmv)
    failed: tuple = ()    # (engine, "ErrorType: message") of skipped ones

    @property
    def n_row(self):
        return self.inner.n_row

    @property
    def n_col(self):
        return self.inner.n_col

    @property
    def nnz(self):
        return self.inner.nnz


def _measures(device) -> bool:
    """Whether candidates are timed on ``device`` (a CUDA device only)."""
    return device is not None and torch.device(device).type == "cuda"


def _quick_bench(mod, state, n_col: int, dtype, device) -> float:
    """Seconds per spmv: ``harness.driver.marginal_seconds``, the median of
    3 marginals of chained CUDA-graph runs timed with CUDA events, at a
    ``TRIAL_WINDOW_S`` window (the reference's ``_quick_bench``).  A capture
    that fails raises ``CaptureError``, which is no guard error."""
    from ..harness.driver import marginal_seconds

    device = torch.device(device)
    x = value_tensor(np.linspace(-1.0, 1.0, max(n_col, 1)), dtype).to(device)
    fmt = mod.__name__.rsplit(".", 1)[-1]
    return marginal_seconds(mod.spmv, state, x, device, TRIAL_WINDOW_S,
                            name=f"auto trial {fmt}")


def convert(coo: COOMatrix, cfg: Config, log=None, device=None) -> AutoState:
    """Rank by the model, time the close candidates on ``device`` when it is
    a CUDA device, and convert the winner.  The state comes back on
    ``device`` when trials ran there, else on the CPU."""
    plans = {}
    costs = estimate_costs(coo, cfg, plans=plans)
    for ex in cfg.auto_exclude:
        costs.pop(ex, None)
    ranked = sorted(costs, key=costs.get)
    ranked_costs = tuple((f, costs[f]) for f in ranked)
    failed = []

    def _build(chosen):
        ccfg = cfg.replace(bkt_row_group=1024) if chosen == "bkt_g" else cfg
        if chosen in plans:
            return _MODULES[chosen].convert(coo, ccfg, plan=plans[chosen])
        return _MODULES[chosen].convert(coo, ccfg)

    def _refused(chosen, e):
        first = str(e).strip().splitlines()[0][:300] if str(e) else ""
        failed.append((chosen, f"{type(e).__name__}: "
                               + first.replace(";", ",")))
        if log:
            log(f"auto: {chosen} failed ({type(e).__name__}); next")

    trial = [f for f in ranked[:TRIAL_MAX]
             if costs[f] <= costs[ranked[0]] * TRIAL_SPREAD]
    if (_measures(device) and coo.nnz and coo.nnz <= TRIAL_NNZ_CAP
            and len(trial) > 1):
        best, timed = None, []
        built = _build_side_by_side(_build, trial)
        for chosen in trial:
            try:
                got = built.pop(chosen)
                if isinstance(got, BaseException):
                    raise got
                st = got.to(device)
                sec = _quick_bench(_MODULES[chosen], st, coo.n_col,
                                   cfg.dtype, device)
            except GUARD_ERRORS as e:
                _refused(chosen, e)
                continue
            timed.append((chosen, sec))
            if log:
                log(f"auto: measured {chosen}: {sec * 1e6:.0f} us "
                    f"(est {costs[chosen] * 1e6:.0f} us)")
            if best is None or sec < best[0]:
                best = (sec, chosen, st)
            del st
        if best is not None:
            return AutoState(best[1], best[2], ranked_costs, tuple(timed),
                             tuple(failed))
        # every trial candidate refused: fall through to the other ranks
        ranked = [f for f in ranked if f not in trial]

    for chosen in ranked:
        if log:
            log(f"auto: trying {chosen} (est {costs[chosen] * 1e6:.0f} us)")
        try:
            return AutoState(chosen, _build(chosen), ranked_costs, (),
                             tuple(failed))
        except GUARD_ERRORS as e:
            _refused(chosen, e)
    raise ValueError(f"auto: no viable format ({failed})")


def _build_side_by_side(build, engines) -> dict:
    """{engine: its host state, or the exception its convert raised}: the
    trial candidates' conversions, one thread each.  Their sorts and
    scatters run in numpy and the native helpers, which release the GIL,
    so the conversions overlap; the trials then time them one by one."""
    def one(engine):
        try:
            return build(engine)
        except Exception as e:     # re-raised by the trial that needs it
            return e

    with ThreadPoolExecutor(len(engines)) as pool:
        return dict(zip(engines, pool.map(one, engines)))


def spmv(state: AutoState, x: torch.Tensor) -> torch.Tensor:
    return _MODULES[state.chosen].spmv(state.inner, x)


def spmm(state: AutoState, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X through the chosen engine's ``spmm`` (or the column loop
    of its ``spmv``), at every value type."""
    return module_spmm(_MODULES[state.chosen])(state.inner, X)


def adds_per_row(state: AutoState) -> np.ndarray:
    """The chosen engine's k_i (``base.adds_per_row``)."""
    mod = _MODULES[state.chosen]
    fn = getattr(mod, "adds_per_row", None)
    return fn(state.inner) if fn is not None \
        else mod.to_coo(state.inner).row_lengths()


def to_coo(state: AutoState) -> COOMatrix:
    return _MODULES[state.chosen].to_coo(state.inner)


def _us(pairs) -> str:
    return ", ".join(f"{k} {v * 1e6:.1f}" for k, v in pairs) or "none"


def report_fields(state: AutoState, cfg: Config) -> dict:
    mod = _MODULES[state.chosen]
    out = {"ChosenFormat": state.chosen.upper()}
    fn = getattr(mod, "report_fields", None)
    if fn:
        out.update(fn(state.inner, cfg))
    out.update({
        "AutoEstimates(us)": _us(state.costs),
        "AutoTrials(us)": _us(state.trials),
        "AutoFailed": "; ".join(f"{k}: {v}" for k, v in state.failed)
                      or "none"})
    return out


def traffic_bytes(state: AutoState, cfg: Config) -> int:
    mod = _MODULES[state.chosen]
    fn = getattr(mod, "traffic_bytes", None)
    if fn:
        return int(fn(state.inner, cfg))
    m, nnz = state.n_row, state.nnz
    vsz = value_size(cfg.dtype)
    return (m + 1 + nnz) * 4 + (2 * nnz + m) * vsz


def attainable_seconds(state: AutoState, cfg: Config):
    fn = getattr(_MODULES[state.chosen], "attainable_seconds", None)
    return fn(state.inner, cfg) if fn else None
