"""A/B of the xch spmv's design on the card: the fused route against the
pair it replaced, and the pair's own designs.

    python -m singlespmv_tpu_torch.harness.xch_ab     # needs a GPU and nvcc
    python -m singlespmv_tpu_torch.harness.xch_ab --no-circuit5M
    python -m singlespmv_tpu_torch.harness.xch_ab --coo-dir DIR

Builds ``csrc/xch.cu`` as it is and the variants of ``VARIANTS``, each a
copy of ``csrc/`` with one change (text substitutions, as in
``panel_ab.py``), and times them in turns on the xch states of the
structure-matched stand-ins (seed 0): webbase-1M and ASIC_680ks in float32
and float64, and circuit5M in float32, every call of a state and of its
nested long-row state; with ``--dist R`` also each shard of DistXch on
webbase-1M at R shards (its x footprint as x).  ``--variants NAME ...``
builds only those variants beside "as built".  Over two passes (the variants in order, then
reversed) it times, as device busy µs (torch.profiler):

- the fused route: ``xch_fused_rows`` as built (both passes in one launch
  a pass-2 call, the products in registers from ``val2``/``col2``) against
  the pair as built (``xch_mul`` then ``xch_route4_rows``, both kernels'
  busy time); ``fused 2 rows a warp`` (a warp of the direct kernel takes
  two stream rows in turn), ``fused x plain loads`` (x gathered by
  plain loads, not through the read-only path ``__ldg``) and ``fused no
  gather`` (diagnostic: every lane reads x at its own four slots, col2
  still loaded);
- the pair's route: ``xch_route4_rows`` as built; ``route direct`` (a
  reduction a run end on every state, the merge span of ``route_rows``
  unused); the first port's route ``xch_route4`` on the idx planes
  ((p_oh, 128) shared accumulator);
  ``plain stores`` (diagnostic: y[pos] = v for the reductions); ``int32
  dest`` (absolute int32 destinations, base 0);
- the multiply: ``xch_mul`` as built; ``mul 2 rows a warp``; ``mul no
  gather`` (diagnostic: every lane reads x at its own four slots);
- the whole spmv: as built (fused); ``pair`` (the spmv before the fused
  route: ``phases``' Mul then Sum); ``as before`` (the glue of the first port:
  the products' ``cat``, one zeroed out block a route call, their ``cat``
  and the y scatter, on the first port's route); on circuit5M ``L2 batches``, pass-1
  and pass-2 calls alternating by batches of chunks whose products fit in
  ``L2_BATCH_BYTES``; with the spmv's time on the device's clock (CUDA
  events, 20 calls, host gaps included) beside its busy time;
- torch's ``A_csr @ x`` (cuSPARSE), once.

Variants that compute the same function are held to the plain versions
within 1e-5·max|y| (1e-12 at float64); the diagnostic ones are not.  It
prints the card's name and power limit, each build's registers for the
kernels (ptxas) and the count of global reductions (``RED``) and
shared-memory compare-and-swap loops (``ATOMS.CAST``) in their SASS, the
fused route's direct and merge kernels beside the pair's.
"""
from __future__ import annotations

import argparse
import os
import subprocess

import numpy as np
import torch

from .. import Config
from ..formats import xch
from ..ops import _build
from ..ops import xch as xops
from .chain_times import stand_in
from .panel_ab import build_variant, busy_us, kernel_hit

ATOMIC = ("  if (d >= 0 && pos < n_y) atomicAdd(y + pos, v);"
          "  // result unused: RED.ADD")
VARIANTS = {
    "as built": {},
    "plain stores": {ATOMIC: "  if (d >= 0 && pos < n_y) y[pos] = v;"},
    "int32 dest": {"    using Dest = int16_t;": "    using Dest = int32_t;"},
    # a warp of xch_mul takes two rows, both rows' loads issued first
    "mul 2 rows a warp": {
        """  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= H) return;
  const size_t off = (size_t)r * kLanes + 4 * (threadIdx.x & 31);
  store4(out + off, mul4(load4(val + off), gather4(r, m, win, lane, sub, x)));""":
        """  const int r0 = 2 * (blockIdx.x * kWarps + (threadIdx.x >> 5));
  V4<S> v[2], g[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (r0 + i >= H) break;
    v[i] = load4(val + (size_t)(r0 + i) * kLanes + 4 * (threadIdx.x & 31));
    g[i] = gather4(r0 + i, m, win, lane, sub, x);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (r0 + i >= H) break;
    store4(out + (size_t)(r0 + i) * kLanes + 4 * (threadIdx.x & 31),
           mul4(v[i], g[i]));
  }""",
        "xch_mul_kernel<V><<<(H + kWarps - 1) / kWarps,":
            "xch_mul_kernel<V><<<(H + 2 * kWarps - 1) / (2 * kWarps),"},
    "mul no gather": {"gather4(r, m, win, lane, sub, x)));":
                      "load4(x + 4 * (threadIdx.x & 31))));"},
    # a warp of the direct route takes two stream rows in turn
    "fused 2 rows a warp": {
        """  const int r = blockIdx.x * kWarps + warp;
  if (r >= H) return;  // uniform over the warp
  const size_t off""":
        """  const int r0 = 2 * (blockIdx.x * kWarps + warp);
#pragma unroll
  for (int r = r0; r < r0 + 2; ++r) {
  if (r >= H) return;  // uniform over the warp
  const size_t off""",
        """  add_run(y, b, d.w, w.w, n_y);
}""": """  add_run(y, b, d.w, w.w, n_y);
  }
}""",
        "xch_route4_rows_kernel<P, Dest><<<(H + kWarps - 1) / kWarps,":
            "xch_route4_rows_kernel<P, Dest><<<(H + 2 * kWarps - 1) / "
            "(2 * kWarps),"},
    # diagnostic: every lane reads x at its own four slots (col2 still
    # loaded): what the gather's locality costs
    "fused no gather": {
        """    const V4<S> g = {ldg_acc(x + c.x), ldg_acc(x + c.y), ldg_acc(x + c.z),
                     ldg_acc(x + c.w)};""":
        """    const V4<S> g = load4(x + 4 * (threadIdx.x & 31) + (c.x < 0));"""},
    "fused x plain loads": {
        """    const V4<S> g = {ldg_acc(x + c.x), ldg_acc(x + c.y), ldg_acc(x + c.z),
                     ldg_acc(x + c.w)};""":
        """    const V4<S> g = {to_acc(x[c.x]), to_acc(x[c.y]), to_acc(x[c.z]),
                     to_acc(x[c.w])};"""},
}
DIAGNOSTIC = ("plain stores", "mul no gather", "fused no gather")
FUSED_VARIANTS = ("fused 2 rows a warp", "fused x plain loads",
                  "fused no gather")
# the kernels whose registers and SASS are counted: the route kernels are
# one template, told apart by their producer (float, double)
KERNELS = tuple((k + "I", f"{p}I{t}") for k in (
    "xch_route4_rows_kernel", "xch_route4_rows_merge_kernel")
    for p in ("StreamGather", "GridProducts") for t in "fd") + tuple(
    f"{k}I{t}" for k in ("xch_route4_kernel", "xch_mul_kernel")
    for t in "fd")
SASS = ("REDG", "ATOMG", "ATOMS.CAST")
MATS = (("webbase-1M", ("float32", "float64")),
        ("ASIC_680ks", ("float32", "float64")),
        ("circuit5M", ("float32",)))
L2_BATCH_BYTES = 24 << 20     # half the H100's 50 MB L2
REPS = 20
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def _states(state):
    while state is not None:
        yield state
        state = state.long


def _label(key) -> str:
    return key if isinstance(key, str) else "<".join(key)


def sass_counts(path: str, kernels=KERNELS, patterns=SASS) -> dict:
    """{kernel: {pattern: instructions}} from cuobjdump's SASS of ``path``."""
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", path], capture_output=True,
                          text=True).stdout
    out, current = {k: dict.fromkeys(patterns, 0) for k in kernels}, None
    for line in sass.splitlines():
        if "Function :" in line:
            current = next((k for k in kernels if kernel_hit(k, line)), None)
        elif current:
            for p in patterns:
                out[current][p] += p in line
    return out


def spmv_before(state, x):
    """The first port's spmv glue and route: the products' ``cat``,
    one zeroed out block a route call, their ``cat``, the y scatter."""
    n = state.n_row
    if state.n_slots1:
        xp = xch.x_table(state, x)
        prods = [xops.xch_mul(w, la, su, va, xp, state.m1, state.t1)
                 for w, la, su, va in zip(state.win1, state.lane1,
                                          state.sub1, state.val1)]
        prod = prods[0] if len(prods) == 1 else torch.cat(prods, 0)
        prod3 = prod.view(state.n_chunks, state.p1, 128)
        outs = [xops.xch_route4(g, o, c, w, la, su, h2, sg, ix, prod3, ng,
                                state.gb, state.m2, state.t2, state.p_oh)
                for g, o, c, w, la, su, h2, sg, ix, ng in zip(
                    state.gids2, state.off2, state.cs2, state.win2,
                    state.lane2, state.sub2, state.hm2, state.sig2,
                    state.idx2, state.chunk_ngrp)]
        out = outs[0] if len(outs) == 1 else torch.cat(outs, 0)
        n_grp_tot = -(-(-(-max(n, 1) // 128)) // state.gb)
        yg = torch.zeros(n_grp_tot, state.gb * 128, dtype=x.dtype,
                         device=x.device)
        yg[state.vis_gids.long()] = out.view(-1, state.gb * 128)
        y = yg.view(-1)[:n]
    else:
        y = torch.zeros(n, dtype=x.dtype, device=x.device)
    if state.long is not None:
        y.index_add_(0, state.long_rows.long(), spmv_before(state.long, x))
    if state.dia_vals is not None:
        y = y + xch._dia_part(state, x)
    return y


def l2_batches(state, budget=L2_BATCH_BYTES):
    """The launches of ``spmv_l2`` for ``state``: [(pass-1 calls, pass-2
    calls)] a batch of chunks whose products fit in ``budget`` bytes, each
    call (product rows, its stream arguments): row slices of the state's
    streams, and copies of the per-step arrays (a slice of them lies off
    the kernels' 16-byte alignment).  None where the pass-2 steps do not
    run chunk by chunk (cs not non-decreasing)."""
    cs = [c.cpu().numpy() for c in state.cs2]
    if not all((np.diff(c) >= 0).all() for c in cs):
        return None
    per = state.p1 * 128 * state.val1[0].element_size()
    k = max(1, budget // per)
    rows1 = np.cumsum([0] + [w.shape[0] for w in state.win1])
    t2 = state.t2
    out = []
    for c0 in range(0, state.n_chunks, k):
        c1 = min(c0 + k, state.n_chunks)
        a, b = c0 * state.p1, c1 * state.p1     # product rows, t1-aligned
        muls = [(slice(max(a, r0), min(b, r1)), tuple(
            f[i][max(a, r0) - r0:min(b, r1) - r0] for f in (
                state.win1, state.lane1, state.sub1, state.val1)))
            for i, (r0, r1) in enumerate(zip(rows1[:-1], rows1[1:]))
            if a < r1 and r0 < b]
        routes = []
        for j, c in enumerate(cs):
            s0, s1 = (int(np.searchsorted(c, v)) for v in (c0, c1))
            if s0 < s1:
                routes.append(tuple(
                    [state.base2[j][s0:s1].clone(),
                     state.cs2[j][s0:s1].clone()]
                    + [f[j][s0 * t2:s1 * t2] for f in (
                        state.win2, state.lane2, state.sub2, state.hm2,
                        state.dest2)]))
        out.append((muls, routes))
    return out


def spmv_l2(state, x, batches):
    """``xch.spmv`` with the outer state's pass-1 and pass-2 calls
    alternating by ``batches`` (``l2_batches``), so that a batch's
    products are read back from L2."""
    y = torch.zeros(state.n_row, dtype=x.dtype, device=x.device)
    xp = xch.x_table(state, x)
    prod = torch.empty(state.n_chunks * state.p1, 128, dtype=x.dtype,
                       device=x.device)
    prod3 = prod.view(state.n_chunks, state.p1, 128)
    for muls, routes in batches:
        for rows, a in muls:
            xops.xch_mul(*a, xp, state.m1, state.t1, out=prod[rows])
        for a in routes:
            xops.xch_route4_rows(*a, prod3, y, state.m2, state.t2,
                                 state.merge2)
    if state.long is not None:
        y.index_add_(0, state.long_rows.long(), xch.spmv(state.long, x))
    if state.dia_vals is not None:
        y = y + xch._dia_part(state, x)
    return y


def _route32(base, cs, win, lane, sub, hm1, dest, prod3, y, m, T):
    """The route's C entry on int32 destinations (the ``int32 dest``
    build), past the wrapper's int16 check."""
    vt = prod3.dtype
    entry = getattr(_build.load(), "xch_route4_rows_"
                    + ("f64" if vt == torch.float64 else "f32"))
    ptr = lambda t: t.data_ptr()     # noqa: E731
    rc = entry(*map(ptr, (base, cs, win, lane, sub, hm1, dest, prod3, y)),
               lane.shape[0], T, m, prod3.shape[1], y.numel(), 0,
               torch.cuda.current_stream().cuda_stream)
    if rc:
        raise _build.KernelError(f"int32 dest route: cudaError {rc}")


def _placed(st, outs):
    """y of one state from the first port's out groups (no long rows, no
    bands)."""
    n_grp_tot = -(-(-(-max(st.n_row, 1) // 128)) // st.gb)
    yg = torch.zeros(n_grp_tot, st.gb * 128, dtype=outs[0].dtype,
                     device=outs[0].device)
    yg[st.vis_gids.long()] = torch.cat(outs, 0).view(-1, st.gb * 128)
    return yg.view(-1)[:st.n_row]


class Case:
    """One state's inputs and the calls each variant times."""

    def __init__(self, label, coo, state, x, dev):
        self.label, self.state, self.x = label, state, x
        self.subs = list(_states(state))
        self.xts = [xch.x_table(s, x) for s in self.subs]
        self.prods = [xch.products(s, xt) for s, xt in zip(self.subs,
                                                            self.xts)]
        self.ys = [torch.zeros(s.n_row, dtype=x.dtype, device=dev)
                   for s in self.subs]
        self.grids = [torch.empty_like(p) for p in self.prods]
        self.d32, self.z32 = [], []
        for s in self.subs:
            steps = [torch.arange(d.shape[0], device=dev) // s.t2
                     for d in s.dest2]
            self.d32.append([torch.where(
                d >= 0, b[t][:, None] + d.int(), -1).int().contiguous()
                for b, d, t in zip(s.base2, s.dest2, steps)])
            self.z32.append([torch.zeros_like(b) for b in s.base2])
        self.batches = l2_batches(state) \
            if label.startswith("circuit5M") else None
        rows = torch.from_numpy(coo.row.astype(np.int64))
        cols = torch.from_numpy(coo.col.astype(np.int64))
        self.a_csr = torch.sparse_coo_tensor(
            torch.stack([rows, cols]),
            torch.from_numpy(coo.val.astype(np.float64)).to(x.dtype),
            (coo.n_row, coo.n_col)).coalesce().to_sparse_csr().to(dev)
        # the plain versions' outputs, for the checks
        self.want_route = [self._rows(i, xops.xch_route4_rows_ref).clone()
                           for i in range(len(self.subs))]
        self.want_mul = [p.clone() for p in self.prods]
        self.want_y = xch.spmv(state, x).clone()

    def _rows(self, i, fn, merge=True):
        s, y = self.subs[i], self.ys[i]
        y.zero_()
        for a in zip(s.base2, s.cs2, s.win2, s.lane2, s.sub2, s.hm2,
                     s.dest2):
            fn(*a, self.prods[i], y, s.m2, s.t2, s.merge2 if merge else 0)
        return y

    def route(self):
        return [self._rows(i, xops.xch_route4_rows)
                for i in range(len(self.subs))]

    def fused(self):
        out = []
        for s, y in zip(self.subs, self.ys):
            y.zero_()
            for a in zip(s.base2, s.val2, s.col2, s.hm2, s.dest2):
                xops.xch_fused_rows(*a, self.x, y, s.t2, s.merge2)
            out.append(y)
        return out

    def pair(self):
        self.mul()
        out = []
        for i, (s, y) in enumerate(zip(self.subs, self.ys)):
            y.zero_()
            for a in zip(s.base2, s.cs2, s.win2, s.lane2, s.sub2, s.hm2,
                         s.dest2):
                xops.xch_route4_rows(*a, self.grids[i], y, s.m2, s.t2,
                                     s.merge2)
            out.append(y)
        return out

    def route_direct(self):
        return [self._rows(i, xops.xch_route4_rows, merge=False)
                for i in range(len(self.subs))]

    def route32(self):
        out = []
        for i, s in enumerate(self.subs):
            y = self.ys[i]
            y.zero_()
            for z, c, w, la, su, h2, d in zip(
                    self.z32[i], s.cs2, s.win2, s.lane2, s.sub2, s.hm2,
                    self.d32[i]):
                _route32(z, c, w, la, su, h2, d, self.prods[i], y, s.m2,
                         s.t2)
            out.append(y)
        return out

    def route_idx(self):
        return [_placed(s, [xops.xch_route4(
            *a, self.prods[i], ng, s.gb, s.m2, s.t2, s.p_oh)
            for *a, ng in zip(s.gids2, s.off2, s.cs2, s.win2, s.lane2,
                              s.sub2, s.hm2, s.sig2, s.idx2, s.chunk_ngrp)])
            for i, s in enumerate(self.subs)]

    def mul(self):
        for s, xt, g in zip(self.subs, self.xts, self.grids):
            r0 = 0
            for w, la, su, va in zip(s.win1, s.lane1, s.sub1, s.val1):
                xops.xch_mul(w, la, su, va, xt, s.m1, s.t1,
                             out=g.view(-1, 128)[r0:r0 + w.shape[0]])
                r0 += w.shape[0]
        return self.grids


def dist_cases(coo, R, dev):
    """A case a shard of DistXch on ``coo`` at R shards: the shard's state,
    its x footprint, its matrix (``to_coo``) for cuSPARSE."""
    from ..parallel import DistXch, make_mesh

    op = DistXch.convert(coo, Config(format="xch"),
                         make_mesh((("row", R),), device=dev))
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, coo.n_col).astype(np.float32)).to(dev)
    out = []
    for k, (st, fp) in enumerate(zip(op.states, op.footprints(x))):
        out.append(Case(f"webbase-1M R{R} shard {k}",
                        xch.to_coo(st.to("cpu")), st, fp[: st.n_col].clone(),
                        dev))
        print(f"{out[-1].label}: nnz {op.sub_nnz[k]} kblk {st.kblk} m1 "
              f"{st.m1} m2 {st.m2} t2 {st.t2} rows {st.n_slots2 // 128} run "
              f"ends {sum(int((d >= 0).sum()) for d in st.dest2)} merge "
              f"{st.merge2}", flush=True)
    return out


def _close(got, want, label):
    for g, w in zip(got, want):
        torch.cuda.synchronize()
        err = float((g - w).abs().max()) if w.numel() else 0.0
        scale = float(w.abs().max()) if w.numel() else 0.0
        if err > TOL[w.dtype] * scale:
            raise SystemExit(f"{label}: off the plain version by {err} "
                             f"(max |y| {scale})")


def _cuda_ms(fn, reps=REPS):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def run_variant(name, case, times):
    """Times (and, unless diagnostic, checks) the variant's calls on one
    case; appends to ``times[(row, label)]``."""
    check = name not in DIAGNOSTIC
    x, st = case.x, case.state
    rows = []
    if name == "as built":
        rows.append(("fused as built", case.fused, "StreamGather",
                     case.want_route))
        rows.append(("pair as built (mul + route)", case.pair, "xch_",
                     case.want_route))
    if name in FUSED_VARIANTS:
        rows.append((name, case.fused, "StreamGather", case.want_route))
    if name in ("as built", "plain stores"):
        rows.append((f"route {name}", case.route, "GridProducts",
                     case.want_route))
    if name == "int32 dest":
        rows.append(("route int32 dest", case.route32, "GridProducts",
                     case.want_route))
    if name == "as built":
        rows.append(("route direct", case.route_direct, "GridProducts",
                     case.want_route))
        rows.append(("route idx planes (first port)", case.route_idx,
                     "xch_route4_kernel", case.want_route))
    if name in ("as built", "mul 2 rows a warp", "mul no gather"):
        rows.append(("mul as built" if name == "as built" else name,
                     case.mul, "xch_mul_kernel", case.want_mul))
    for row, fn, match, want in rows:
        if check:
            _close(fn(), want, f"{name} {case.label} {row}")
        times.setdefault((row, case.label), []).append(
            busy_us(lambda: fn(), match, REPS))
    if name != "as built":
        return
    spmvs = [("spmv as built", lambda: xch.spmv(st, x)),
             ("spmv pair", lambda: xch.pair_spmv_acc(st, x)),
             ("spmv as before", lambda: spmv_before(st, x))]
    if case.batches is not None:
        spmvs.append(("spmv L2 batches", lambda: spmv_l2(st, x,
                                                        case.batches)))
    for row, fn in spmvs:
        _close([fn()], [case.want_y], f"{case.label} {row}")
        times.setdefault((row + " busy", case.label), []).append(
            busy_us(fn, "", REPS))
        times.setdefault((row + " wall", case.label), []).append(
            _cuda_ms(fn) * 1e3)
    times.setdefault(("A_csr @ x (cuSPARSE) busy", case.label), []).append(
        busy_us(lambda: case.a_csr @ x, "cusparse", REPS))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--no-circuit5M", action="store_true",
                    help="leave out circuit5M (its stand-in takes minutes)")
    ap.add_argument("--dist", type=int, default=0, metavar="R",
                    help="add DistXch's R shards of webbase-1M as cases")
    ap.add_argument("--variants", nargs="*", default=None,
                    help="build only these variants beside 'as built'")
    ap.add_argument("--coo-dir", default=None,
                    help="read the stand-ins from DIR/<name>.npz where "
                    "they are there, else keep them there "
                    "(harness/chain_times.py's)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("xch_ab needs a CUDA device")
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    builds = {}
    variants = {k: v for k, v in VARIANTS.items()
                if args.variants is None or k == "as built"
                or k in args.variants}
    for name, subs in variants.items():
        lib, regs, _ = build_variant(name, subs, ("xch.cu",), KERNELS)
        builds[name] = lib
        print(f"build {name!r}: registers "
              f"{ {_label(k): v for k, v in regs.items()} }; SASS "
              f"{ {_label(k): v for k, v in sass_counts(lib._name).items()} }",
              flush=True)
    cases = []
    saved = _build._lib
    _build._lib = builds["as built"]
    try:
        for name, dtypes in MATS:
            if args.no_circuit5M and name == "circuit5M":
                continue
            coo = stand_in(name, args.coo_dir)
            for dtype in dtypes:
                st = xch.convert(coo, Config(format="xch", dtype=dtype))
                x = torch.from_numpy(np.random.default_rng(0).uniform(
                    -1, 1, coo.n_col).astype(dtype)).to(dev)
                label = f"{name} {dtype[-2:]}"
                cases.append(Case(label, coo, st.to(dev), x, dev))
                print(f"{label}: plans " + ", ".join(
                    f"kblk {s.kblk} m2 {s.m2} t2 {s.t2} p_oh {s.p_oh} "
                    f"calls {len(s.win1)}/{len(s.base2)} rows "
                    f"{s.n_slots2 // 128} run ends "
                    f"{sum(int((d >= 0).sum()) for d in s.dest2)} merge "
                    f"{s.merge2}" for s in _states(cases[-1].state))
                    + (f"; L2 batches {len(cases[-1].batches)}"
                       if cases[-1].batches else ""), flush=True)
            del coo
        if args.dist:
            cases += dist_cases(stand_in("webbase-1M", args.coo_dir),
                                args.dist, dev)
        times = {}
        for order in (list(variants), list(variants)[::-1]):
            for name in order:
                _build._lib = builds[name]
                for case in cases:
                    run_variant(name, case, times)
    finally:
        _build._lib = saved
    labels = [c.label for c in cases]
    print("busy µs (walls: µs on CUDA events), pass 1 / pass 2")
    print("row".ljust(34) + "".join(f"{lb:>22}" for lb in labels))
    for row in dict.fromkeys(r for r, _ in times):
        print(row.ljust(34) + "".join(
            f"{' / '.join(f'{t:.2f}' for t in times.get((row, lb), [])):>22}"
            for lb in labels), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
