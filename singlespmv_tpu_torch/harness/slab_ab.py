"""A/B of the slab spmv route's design on the card.

    python -m singlespmv_tpu_torch.harness.slab_ab     # needs a GPU and nvcc

Builds ``csrc/slab.cu`` as it is and the variants of ``VARIANTS``, each a
copy of ``csrc/`` with one change (text substitutions, as in
``panel_ab.py``), and times them in turns on the slab states of the
structure-matched stand-ins (seed 0): raefsky3 and torso1 (the planner's
blk plans, float32), g7jac200sc (the unit-only plan, float32, and the
float64 plan), torso1 (float64: unit) and the slab residuals of the
Chebyshev4 and PR02R hyb states (float32).  Over two passes (the variants
in order, then reversed) it times, as device busy µs (torch.profiler), one
call per chunk of:

- the route: ``slab_spmv_rows`` as built (the merge span ``route_rows``
  chose); ``route direct`` (a reduction a run end on every state);
  ``route merge`` (the merge kernel on every state whose eight spans fit
  its shared memory); the first port (``slab_unit_kernel`` /
  ``slab_blk_kernel`` on the idx planes, a zeroed out block a chunk);
  ``int32 dest`` (absolute int32 positions, ybase unread); ``merge 16
  rows a block`` and ``merge 8 rows a block`` (the merge kernel's blocks
  cut to 16 or 8 rows); ``plain stores`` (diagnostic: y[pos] = v for the
  reductions);
- the whole spmv: as built, and ``as before`` (the first port's kernels and
  glue: zeroed out blocks, their ``cat``, the shift-add or the pair
  overlap-add, the scatter by unit id), busy and on the device's clock
  (CUDA events, 20 calls, host gaps included), with the device operations
  (kernels, memsets, copies) a call makes;
- torch's ``A_csr @ x`` (cuSPARSE), once a pass.

Variants that compute the same function are held to the plain version
within 1e-5·max|y| (1e-12 at float64); the diagnostic one is not.  It
prints the card's name and power limit, each build's registers for the
route's and the first port's kernels (ptxas) and the count of global
reductions (``RED``), global atomics (``ATOMG``) and shared-memory
compare-and-swap loops (``ATOMS.CAST``) in their SASS.
"""
from __future__ import annotations

import subprocess

import numpy as np
import torch

from .. import Config
from ..core.types import cdiv
from ..data import synthesize_structured
from ..formats import hyb, slab
from ..ops import _build
from ..ops import slab as sops
from .panel_ab import build_variant, busy_us
from .xch_ab import _cuda_ms, sass_counts

MERGE_RPB = ("  const int rpb = rows_per_block(T);\n"
             "  slab_rows_merge_kernel<V>")
VARIANTS = {
    "as built": {},
    "plain stores": {
        "if (d >= 0 && b >= 0 && pos < n_y) atomicAdd(y + pos, v);":
            "if (d >= 0 && b >= 0 && pos < n_y) y[pos] = v;",
        "atomicAdd(y + pos, sum);": "y[pos] = sum;"},
    "int32 dest": {"    using SlabDest = int16_t;":
                   "    using SlabDest = int32_t;"},
    # the merge kernel's blocks take 16 or 8 rows of a step (2 or 1 a
    # warp) in place of up to 32: more blocks, more span work a row
    "merge 16 rows a block": {MERGE_RPB: MERGE_RPB.replace(
        "rows_per_block(T)", "min(rows_per_block(T), 16)")},
    "merge 8 rows a block": {MERGE_RPB: MERGE_RPB.replace(
        "rows_per_block(T)", "min(rows_per_block(T), 8)")},
}
DIAGNOSTIC = ("plain stores",)
KERNELS = tuple(f"{k}I{t}" for k in ("slab_rows_kernel",
                                     "slab_rows_merge_kernel",
                                     "slab_unit_kernel") for t in "fd") \
    + ("slab_blk_kernel",)
SASS = ("REDG", "ATOMG", "ATOMS.CAST")
REPS = 20
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
F32 = Config(format="slab", dtype="float32")


def spmv_before(state, x):
    """The first port's spmv: one kernel a chunk on the idx planes into a
    zeroed out block, their ``cat``, then the blk shift-add or the unit
    pair overlap-add and the scatter by unit id."""
    n, dev = state.n_row, x.device
    xp = slab.x_table(state, x)
    nu, planes = state.n_units, state.planes
    if state.mode == "blk":
        outs = [sops.slab_spmv_blk(u, w, la, su, va, h1, ix, sg, xp, nu_c,
                                   state.m, planes, state.t_step)
                for u, w, la, su, va, h1, ix, sg, nu_c in zip(
                    state.uids, state.win, state.lane, state.sub, state.val,
                    state.hm1, state.idx, state.sig, state.chunk_nu)]
        out = outs[0] if len(outs) == 1 else torch.cat(outs, 0)
        dst = (torch.arange(nu, device=dev)[:, None]
               + torch.arange(planes, device=dev)[None, :]).view(-1)
        yb = torch.zeros(nu + planes, 128, dtype=x.dtype, device=dev)
        yb.index_add_(0, dst, out)
        yu, rows_per_unit = yb[:nu], 128
        kblk = state.idx[0].shape[0]
        n_blocks = cdiv(cdiv(max(n, 1), 128), kblk) * kblk
    else:
        outs = [sops.slab_spmv(u, s0, s1, w, la, su, va, h1, ix, xp, nu_c,
                               state.m, state.t_step)
                for u, s0, s1, w, la, su, va, h1, ix, nu_c in zip(
                    state.uids, state.sg0, state.sg1, state.win, state.lane,
                    state.sub, state.val, state.hm1, state.idx,
                    state.chunk_nu)]
        out = outs[0] if len(outs) == 1 else torch.cat(outs, 0)
        if planes == 8:
            yu = out.view(nu, slab.UNIT_ROWS)
        else:
            out3 = out.view(nu, 2, slab.UNIT_ROWS)
            yu = out3[:, 0].clone()
            yu[1:] += out3[:-1, 1]
        rows_per_unit = slab.UNIT_ROWS
        n_blocks = cdiv(max(n, 1), slab.UNIT_ROWS)
    y2 = torch.zeros(n_blocks, rows_per_unit, dtype=x.dtype, device=dev)
    y2[state.unit_ids.long()] = yu
    return y2.view(-1)[:n]


def _rows32(ybase, win, lane, sub, val, hm1, dest, xt, y, m, T, planes):
    """The route's C entry on absolute int32 destinations (the ``int32
    dest`` build), past the wrapper's int16 check."""
    vt = xt.dtype
    entry = getattr(_build.load(), "slab_spmv_rows_"
                    + ("f64" if vt == torch.float64 else "f32"))
    ptr = lambda t: t.data_ptr()     # noqa: E731
    rc = entry(*map(ptr, (ybase, win, lane, sub, val, hm1, dest, xt, y)),
               lane.shape[0], T, m, planes, y.numel(), 0,
               torch.cuda.current_stream().cuda_stream)
    if rc:
        raise _build.KernelError(f"int32 dest route: cudaError {rc}")


def device_ops(fn) -> int:
    """Device operations (kernels, memsets, copies) one call of ``fn``
    makes (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.self_device_time_total > 0)


class Case:
    """One state's inputs and the calls each variant times."""

    def __init__(self, label, coo, state, x):
        self.label, self.st, self.x = label, state, x
        st = state
        self.xt = slab.x_table(st, x)
        self.y = torch.zeros(st.n_row, dtype=x.dtype, device=x.device)
        self.span = st.planes * 128
        self.merge_fits = (sops.MERGE_WARPS * self.span * x.element_size()
                           <= sops.MERGE_SMEM)
        steps = [torch.arange(d.shape[0], device=x.device) // st.t_step
                 for d in st.dest]
        self.d32 = []
        for yb, d, t in zip(st.ybase, st.dest, steps):
            dl = d.long()
            b = yb.long()[t[:, None], dl.clamp(min=0) >> 7]
            self.d32.append(torch.where((dl >= 0) & (b >= 0),
                                        b + (dl & 127), -1).int()
                            .contiguous())
        self.a_csr = torch.sparse_coo_tensor(
            torch.stack([torch.from_numpy(coo.row.astype(np.int64)),
                         torch.from_numpy(coo.col.astype(np.int64))]),
            torch.from_numpy(coo.val.astype(np.float64)).to(x.dtype),
            (coo.n_row, coo.n_col)).coalesce().to_sparse_csr().to(x.device)
        self.want = self._rows(sops.slab_spmv_rows_ref, 0).clone()

    def _rows(self, fn, span):
        st, y = self.st, self.y
        y.zero_()
        for a in zip(st.ybase, st.win, st.lane, st.sub, st.val, st.hm1,
                     st.dest):
            fn(*a, self.xt, y, st.m, st.t_step, span)
        return y

    def route(self):
        return self._rows(sops.slab_spmv_rows, self.st.merge)

    def route_direct(self):
        return self._rows(sops.slab_spmv_rows, 0)

    def route_merge(self):
        return self._rows(sops.slab_spmv_rows, self.span)

    def route32(self):
        st, y = self.st, self.y
        y.zero_()
        for yb, w, la, su, va, h1, d in zip(st.ybase, st.win, st.lane,
                                            st.sub, st.val, st.hm1, self.d32):
            _rows32(yb, w, la, su, va, h1, d, self.xt, y, st.m, st.t_step,
                    st.planes)
        return y

    def first_port(self):
        st, xt = self.st, self.xt
        if st.mode == "blk":
            return [sops.slab_spmv_blk(*a, xt, nu, st.m, st.planes, st.t_step)
                    for *a, nu in zip(st.uids, st.win, st.lane, st.sub,
                                      st.val, st.hm1, st.idx, st.sig,
                                      st.chunk_nu)]
        return [sops.slab_spmv(*a, xt, nu, st.m, st.t_step)
                for *a, nu in zip(st.uids, st.sg0, st.sg1, st.win, st.lane,
                                  st.sub, st.val, st.hm1, st.idx,
                                  st.chunk_nu)]


def _close(got, want, label):
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if err > TOL[want.dtype] * scale:
        raise SystemExit(f"{label}: off the plain version by {err} "
                         f"(max |y| {scale})")


def run_variant(name, case, times):
    """Times (and, unless diagnostic, checks) the variant's calls on one
    case; appends to ``times[(row, label)]``."""
    check = name not in DIAGNOSTIC
    st = case.st
    rows = []
    if name in ("as built", "plain stores"):
        rows.append((f"route {name}", case.route))
    if name == "int32 dest":
        rows.append(("route int32 dest", case.route32))
    if name.startswith("merge ") and case.merge_fits:
        rows.append((f"route {name}", case.route_merge))
    if name == "as built":
        rows.append(("route direct", case.route_direct))
        if case.merge_fits:
            rows.append(("route merge", case.route_merge))
    for row, fn in rows:
        if check:
            _close(fn(), case.want, f"{name} {case.label} {row}")
        times.setdefault((row, case.label), []).append(
            busy_us(fn, "slab_rows", REPS))
    if name != "as built":
        return
    first = "slab_blk_kernel" if st.mode == "blk" else "slab_unit_kernel"
    times.setdefault(("route first port (idx planes)", case.label),
                     []).append(busy_us(case.first_port, first, REPS))
    for row, fn in (("spmv as built", lambda: slab.spmv(st, case.x)),
                    ("spmv as before", lambda: spmv_before(st, case.x))):
        _close(fn(), case.want, f"{case.label} {row}")
        times.setdefault((row + " busy", case.label), []).append(
            busy_us(fn, "", REPS))
        times.setdefault((row + " wall", case.label), []).append(
            _cuda_ms(fn) * 1e3)
        times.setdefault((row + " device ops", case.label), []).append(
            device_ops(fn))
    times.setdefault(("A_csr @ x (cuSPARSE) busy", case.label), []).append(
        busy_us(lambda: case.a_csr @ case.x, "cusparse", REPS))


def _states(dev):
    """(label, COO of the state's matrix, host state) of every case."""
    mats = {n: synthesize_structured(n) for n in (
        "raefsky3", "torso1", "g7jac200sc", "Chebyshev4", "PR02R")}
    g7 = mats["g7jac200sc"]
    unit = slab._estimate_cols(g7.row.astype(np.int64),
                               g7.col.astype(np.int64), g7.nnz,
                               unit_only=True)
    unit.update(hub_cols=None, cols_eff=None, hub_off=0)
    out = [("raefsky3 f32", mats["raefsky3"],
            slab.convert(mats["raefsky3"], F32)),
           ("torso1 f32", mats["torso1"], slab.convert(mats["torso1"], F32)),
           ("g7jac200sc f32", g7, slab.convert(g7, F32, plan=unit)),
           ("g7jac200sc f64", g7,
            slab.convert(g7, F32.replace(dtype="float64"))),
           ("torso1 f64", mats["torso1"],
            slab.convert(mats["torso1"], F32.replace(dtype="float64")))]
    for name in ("Chebyshev4", "PR02R"):
        st = hyb.convert(mats[name], F32.replace(format="hyb"))
        if st.rest_fmt != "slab":
            raise SystemExit(f"{name}: the hyb residual rides {st.rest_fmt}")
        rest = st.rest_state
        out.append((f"{name} residual f32", slab.to_coo(rest), rest))
    return out


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("slab_ab needs a CUDA device")
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    builds = {}
    for name, subs in VARIANTS.items():
        lib, regs, _ = build_variant(name, subs, ("slab.cu",), KERNELS)
        builds[name] = lib
        print(f"build {name!r}: registers {regs}; SASS "
              f"{sass_counts(lib._name, KERNELS, SASS)}", flush=True)
    cases = []
    saved = _build._lib
    _build._lib = builds["as built"]
    try:
        for label, coo, st in _states(dev):
            x = torch.from_numpy(np.random.default_rng(0).uniform(
                -1, 1, coo.n_col)).to(dev, st.val[0].dtype)
            cases.append(Case(label, coo, st.to(dev), x))
            s = cases[-1].st
            print(f"{label}: {s.mode} planes {s.planes} kblk "
                  f"{s.idx[0].shape[0] if s.mode == 'blk' else 1} m {s.m} "
                  f"T {s.t_step} chunks {len(s.dest)} stream rows "
                  f"{s.n_slots // 128} run ends "
                  f"{sum(int((d >= 0).sum()) for d in s.dest)} merge "
                  f"{s.merge}", flush=True)
        times = {}
        for order in (list(VARIANTS), list(VARIANTS)[::-1]):
            for name in order:
                _build._lib = builds[name]
                for case in cases:
                    run_variant(name, case, times)
    finally:
        _build._lib = saved
    labels = [c.label for c in cases]
    print("busy µs (walls: µs on CUDA events; device ops a call), "
          "pass 1 / pass 2")
    print("row".ljust(34) + "".join(f"{lb:>24}" for lb in labels))
    for row in dict.fromkeys(r for r, _ in times):
        print(row.ljust(34) + "".join(
            f"{' / '.join(f'{t:.2f}' for t in times.get((row, lb), [])):>24}"
            for lb in labels), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
