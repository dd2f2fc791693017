"""A proven accuracy bound of the port's bfloat16 spmv, for the tests.

The port stores values and x as bfloat16, multiplies and sums in float32
and rounds y once.  Against the float64 oracle r of the stored values
(``stored``: the bfloat16-rounded values and x, which both packages read),
row i of its y lies within

    b_i = e_i + ½·ulp_bf16(|r_i| + e_i),
    e_i = u_p·S_i + T_i + γ(n_i)·((1 + u_p)·S_i + T_i),

with S_i = Σ_j |a_ij x_j|, n_i = nnz_i, u = 2⁻²⁴ the float32 unit
roundoff and γ(n) = n·u / (1 − n·u):

- u_p = 2⁻⁸, bfloat16's unit roundoff, where the engine stores its
  products as bfloat16 (xch's and bkt's product grids, ss's and csr5's
  product streams, ellg's stage A), else 0: a product of two bfloat16 is
  exact in float32 (for a float32 spmv, ``dtype="float32"``: u_p = u, each
  product of two float32 rounded once, and no last rounding of y);
- T_i = 2·γ(130)·(1 + u_p)·M_i where the engine takes a run's total as a
  difference W = P[e] − P[h] of a 128-slot stream row's prefix sums (slab,
  xch, bkt): each P is a sum of at most 128 products in some order, off
  by at most γ(128)·|P|, and M_i (``prefix_mass``) is the sum, over the
  run ends of row i, of its stream row's prefix of |p| at the end; else 0;
- γ(n_i): the run totals, a peel's products and the parts of a composite
  format are the at most n_i nonzero terms of one sum, in any order.

The last term is y's one rounding to bfloat16, to nearest.  A product p
dropped from row i moves y_i by |p| and fails wherever |p| > b_i: for a
row without cancellation, any product above about 2⁻⁷·S_i.
"""
import numpy as np
import torch

from singlespmv_tpu_torch.core.dtypes import to_host
from singlespmv_tpu_torch.core.oracle import reference_spmv, ulp
from singlespmv_tpu_torch.core.types import COOMatrix

U = 2.0 ** -24            # float32 unit roundoff
U_BF16 = 2.0 ** -8        # bfloat16 unit roundoff (8-bit significand)
PREFIX_ADDS = 130         # a 128-slot prefix in any order, and a difference
ROUNDED_PRODUCTS = ("xch", "bkt", "bkt_g", "ss", "csr5", "ellg")
PREFIX_ENGINES = ("slab", "slab2", "xch", "bkt", "bkt_g")


def gamma(n):
    n = np.asarray(n, dtype=np.float64)
    return n * U / (1.0 - n * U)


def _engines(state, fmt):
    """(engine name, state) of ``state`` and of the engines inside it."""
    yield fmt, state
    if fmt in ("hyb", "ellg") and state.rest_fmt:
        yield from _engines(state.rest_state, state.rest_fmt)
    if fmt == "auto":
        yield from _engines(state.inner, state.chosen)


def _abs64(t):
    return t.to(torch.float64).abs()


def _mass(state, fmt, x):
    """M_i of one engine that differences prefix sums: its plain versions
    on |val|, |x| and no run heads, in float64, put each run end's prefix
    of |p| into its row."""
    y = torch.zeros(state.n_row, dtype=torch.float64, device=x.device)
    if fmt in ("slab", "slab2"):
        from singlespmv_tpu_torch.formats import slab
        from singlespmv_tpu_torch.ops.slab import slab_spmv_rows_ref

        if state.nnz == 0 or state.n_units == 0:
            return to_host(y)
        xp = _abs64(slab.x_table(state, x))
        for yb, w, la, su, va, h1, d in zip(
                state.ybase, state.win, state.lane, state.sub, state.val,
                state.hm1, state.dest):
            slab_spmv_rows_ref(yb, w, la, su, _abs64(va),
                               torch.full_like(h1, -1), d, xp, y, state.m,
                               state.t_step)
        return to_host(y)
    if fmt == "xch":
        from singlespmv_tpu_torch.formats import xch
        from singlespmv_tpu_torch.ops.xch import (xch_mul_ref, xch_route_ref,
                                                  xch_route4_rows_ref)

        if isinstance(state, xch.XchState):     # v3: the σ-plane route
            if not state.n_buckets:
                return to_host(y)
            xt = _abs64(xch.x_table(state, x))
            prod = torch.cat([
                xch_mul_ref(w, la, su, _abs64(va), xt, state.m1, state.t1)
                for w, la, su, va in zip(state.win1, state.lane1,
                                         state.sub1, state.val1)])
            prod = prod.view(state.n_chunks, state.p1, 128)
            op = state.span * state.planes
            out = [xch_route_ref(u, g, c, s0, s1, w, la, su,
                                 torch.full_like(h2, -1), ix, prod, ngb,
                                 state.m2, op, state.t2, xch.G_GRP)
                   for u, g, c, s0, s1, w, la, su, h2, ix, ngb in zip(
                       state.uids2, state.gids2, state.cs2, state.sg0_2,
                       state.sg1_2, state.win2, state.lane2, state.sub2,
                       state.hm2, state.idx2, state.chunk_nb)]
            return to_host(xch.place_buckets(state, torch.cat(out)))
        if state.n_slots1:
            xt = _abs64(xch.x_table(state, x))
            prod = torch.cat([
                xch_mul_ref(w, la, su, _abs64(va), xt, state.m1, state.t1)
                for w, la, su, va in zip(state.win1, state.lane1,
                                         state.sub1, state.val1)])
            prod = prod.view(state.n_chunks, state.p1, 128)
            for b, c, w, la, su, h2, d in zip(
                    state.base2, state.cs2, state.win2, state.lane2,
                    state.sub2, state.hm2, state.dest2):
                xch_route4_rows_ref(b, c, w, la, su, torch.full_like(h2, -1),
                                    d, prod, y, state.m2, state.t2)
        mass = to_host(y)
        if state.long is not None:
            mass[to_host(state.long_rows).astype(np.int64)] += \
                _mass(state.long, "xch", x)
        return mass
    from singlespmv_tpu_torch.formats import bkt
    from singlespmv_tpu_torch.ops.bucket import (block_gather_mul_ref,
                                                 bucket_rows_ref)

    nu_pad, sh, _, h = bkt._unit_rows(state)
    prod = block_gather_mul_ref(state.members, state.lane, state.src,
                                _abs64(state.val),
                                _abs64(bkt.x_table(state, x)), state.m)
    return to_host(bucket_rows_ref(prod.view(h, 128),
                                   torch.full_like(state.hm1r, -1),
                                   state.dest, state.yrow, y, sh, nu_pad))


def prefix_mass(state, fmt, x) -> np.ndarray:
    """(n_row,) M_i of a state of format ``fmt`` (the engines inside hyb,
    ellg and auto included) and x, on x's device (the CPU for a host x);
    zeros where no engine differences prefix sums."""
    mass = np.zeros(state.n_row)
    for name, st in _engines(state, fmt):
        if name in PREFIX_ENGINES:
            mass += _mass(st.to(x.device), name, x)
    return mass


def rounds_products(state, fmt) -> bool:
    """Whether an engine of the state stores its products as bfloat16."""
    return any(name in ROUNDED_PRODUCTS for name, _ in _engines(state, fmt))


def stored(coo: COOMatrix) -> COOMatrix:
    """``coo`` with its values rounded to bfloat16 (float64 arrays)."""
    from singlespmv_tpu_torch.core.dtypes import round_values

    return COOMatrix(coo.n_row, coo.n_col, coo.row, coo.col,
                     round_values(coo.val, "bfloat16").astype(np.float64))


def accuracy_bound(coo: COOMatrix, xh, state, fmt, x,
                   dtype="bfloat16") -> np.ndarray:
    """(n_row,) b_i for the bfloat16 spmv of ``state`` (format ``fmt``) on
    x (a bfloat16 tensor), ``coo`` holding the stored values and ``xh``
    the stored x; the oracle is ``reference_spmv(coo, xh)``.  At
    ``dtype="float32"`` the same rule for a float32 spmv: every product of
    two float32 values is rounded once (u_p = u) and y, summed in float32,
    is not rounded again."""
    xh = np.asarray(xh, dtype=np.float64)
    s = np.bincount(coo.row, weights=np.abs(coo.val * xh[coo.col]),
                    minlength=coo.n_row)
    r = reference_spmv(coo, xh)
    if dtype == "float32":
        up = U
    else:
        up = U_BF16 if rounds_products(state, fmt) else 0.0
    t = 2.0 * gamma(PREFIX_ADDS) * (1.0 + up) * prefix_mass(state, fmt, x)
    e = up * s + t + gamma(coo.row_lengths()) * ((1.0 + up) * s + t)
    if dtype == "float32":
        return e
    return e + 0.5 * ulp("bfloat16", np.abs(r) + e)


def _f64(args):
    return [a.double() if a.is_floating_point() else a for a in args]


def _abs(args):
    return [a.abs() if a.is_floating_point() else a for a in args]


def route_entry_bound(plain, args, panel, hm1_at, rest, val_at=None):
    """The same rule for one call of a panel route (``slab_spmm``,
    ``xch_route4_panel``) whose out entries are float32 sums of run totals
    W = P[e] − P[h], each P a float32 prefix of at most 128 products taken
    exactly from stored values: with S an entry's Σ|p|, M its prefix mass
    and n its products, b = T + γ(n)·(S + T), T = 2·γ(130)·M.  ``plain`` is
    the route's plain version, run in float64 on the call's ``args`` (hm1
    at ``hm1_at``, the values at ``val_at`` where the route multiplies),
    ``panel`` and ``rest``.  Returns numpy arrays of out's shape: (the
    float64 plain version, the bound, S + M)."""
    exact = plain(*_f64(args), panel.double(), *rest)
    absl = _abs(_f64(args))
    s = plain(*absl, panel.double().abs(), *rest)
    heads = list(absl)
    heads[hm1_at] = torch.full_like(args[hm1_at], -1)
    mass = plain(*heads, panel.double().abs(), *rest)
    count = _f64(args)
    if val_at is not None:
        count[val_at] = (count[val_at] != 0).double()
    n = plain(*count, (panel != 0).double(), *rest)
    t = 2.0 * gamma(PREFIX_ADDS) * to_host(mass)
    s, n = to_host(s), to_host(n)
    return to_host(exact), t + gamma(n) * (s + t), s + to_host(mass)
