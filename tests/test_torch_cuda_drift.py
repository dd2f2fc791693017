"""Port spmv on the card: how far y drifts between two calls on one state.

The slab, xch and bucket routes add run totals into y with float reductions
in the order the warps run (``csrc/slab.cu``, ``csrc/xch.cu``,
``csrc/bucket.cu``), so two calls on the same state and x may differ in the
last bits where several run ends land on one row; the reference's Pallas
kernels write their out blocks in a fixed order.  Each row's drift is held
to ``core/oracle.py:reorder_bound``: (k_i − 1)·eps·Σ_j|a_ij x_j| for the
k_i run totals the state adds into row i (``adds_per_row`` of the format),
0 on a row of one run end.  It replaced a fixed 1e-6·max|y| (1e-12 at
float64), which a correct powerlaw(20000, 120000) slab state broke by
1.9e-6·max|y| (ROADMAP C.7).  A part added in a fixed order after the
free-order sum, a peel, is one more term of k_i on each row it touches:
y = fl(s + d) rounds once more, by an amount that moves with s.  Both y
also pass the oracle.  The states: a merged slab state (run ends per
stream row at or above ``MERGE_ENDS``), a direct slab state, that powerlaw
slab state, an xch state with the main diagonal peeled, a hyb state (a
band peel over a slab or xch residual) and a bkt_g state (float32 only, as
bkt is); and the xch state's fused spmv against the pair it replaced
(``xch_mul`` writing the product grid, ``xch_route4_rows`` routing it),
which add the same run totals in another order.  Each case prints whether
the two results were bitwise equal and the worst drift as a share of its
row's bound.

Needs an NVIDIA GPU and skips without one.  This file imports no jax:

    python -m pytest --noconftest -p no:cacheprovider -q -s tests/test_torch_cuda_drift.py
"""
import numpy as np
import pytest
import torch

from singlespmv_tpu_torch import Config
from singlespmv_tpu_torch.core import COOMatrix, verify_result
from singlespmv_tpu_torch.core.dtypes import to_host
from singlespmv_tpu_torch.core.oracle import reorder_bound
from singlespmv_tpu_torch.data import powerlaw
from singlespmv_tpu_torch.data.generators import generate
from singlespmv_tpu_torch.formats import bkt, hyb, slab, xch

from test_torch_cuda_slab import _state as slab_state
from test_torch_cuda_slab import piled_rows
from test_torch_cuda_bkt import _scattered
from test_torch_cuda_xch import _scatter

pytestmark = pytest.mark.cuda

MODULES = {slab.spmv: slab, xch.spmv: xch, bkt.spmv: bkt, hyb.spmv: hyb}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def within_reorder_bound(coo, st, spmv, x, y1, y2, what):
    """Asserts that y1 and y2, two results of ``spmv`` on state ``st`` and
    x, pass the oracle and lie within each row's reorder bound of each
    other; prints how close they came."""
    mod = MODULES[spmv]
    xh = to_host(x).astype(np.float64)
    out = str(y1.dtype).replace("torch.", "")
    acc = "float64" if out == "float64" else "float32"
    bound = reorder_bound(mod.to_coo(st), xh, mod.adds_per_row(st), acc, out)
    drift = np.abs(to_host(y1).astype(np.float64)
                   - to_host(y2).astype(np.float64))
    for y in (y1, y2):
        ok, det = verify_result(coo, xh, to_host(y), dtype=out)
        assert ok, (what, det)
    worst = float(np.max(drift / np.maximum(bound, 1e-300),
                         initial=0.0))
    print(f"{what}: bitwise equal {torch.equal(y1, y2)}, max drift "
          f"{drift.max(initial=0.0):.3g}, worst row at {worst:.3g} of its "
          f"reorder bound")
    bad = np.nonzero(drift > bound)[0]
    assert bad.size == 0, (what, bad[:5], drift[bad[:5]], bound[bad[:5]])


def _case(kind, dtype):
    """(coo, state, spmv) of one kind of state."""
    if kind == "slab merged":
        coo = piled_rows()
        st = slab_state(coo, dtype, "blk" if dtype == "float32" else "unit")
        assert st.merge > 0
        return coo, st, slab.spmv
    if kind == "slab direct":
        coo = powerlaw(20000, 60000, seed=2)
        st = slab_state(coo, dtype, "blk" if dtype == "float32" else "unit")
        assert st.merge == 0
        return coo, st, slab.spmv
    if kind == "slab powerlaw":
        # the state whose two eager calls broke the fixed bound (C.7)
        coo = powerlaw(20000, 120000, seed=1)
        return coo, slab.convert(coo, Config(format="slab", dtype=dtype)), \
            slab.spmv
    if kind == "hyb":
        band, rest = generate("band", 20000, 5, seed=4), \
            powerlaw(20000, 100000, seed=6)
        coo = COOMatrix.from_triplets(
            20000, 20000, np.concatenate([band.row, rest.row]),
            np.concatenate([band.col, rest.col]),
            np.concatenate([band.val, rest.val]), sum_duplicates=True)
        st = hyb.convert(coo, Config(format="hyb", dtype=dtype))
        assert st.rest_fmt
        return coo, st, hyb.spmv
    coo = _scatter(40000, 200000, seed=8, long_rows=4)
    st = xch.convert(coo, Config(format="xch", dtype=dtype))
    assert st.dia_vals is not None    # the main diagonal, peeled
    return coo, st, xch.spmv


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("kind", ["slab merged", "slab direct",
                                  "slab powerlaw", "xch", "hyb"])
def test_two_calls_drift_within_bound(cuda, kind, dtype):
    coo, st, spmv = _case(kind, dtype)
    st = st.to(cuda)
    vt = getattr(torch, dtype)
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        -1, 1, coo.n_col)).to(cuda, vt)
    y1 = spmv(st, x)
    y2 = spmv(st, x)
    torch.cuda.synchronize()
    assert y1.dtype == vt and y1.shape == (coo.n_row,)
    within_reorder_bound(coo, st, spmv, x, y1, y2, f"{kind} {dtype}")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_fused_xch_against_the_pair_within_bound(cuda, dtype):
    """The fused spmv (``xch_fused_rows``: the products made in registers)
    adds the same run totals as the pair it replaced, in another order:
    the two y lie within each row's reorder bound."""
    from singlespmv_tpu_torch.ops import xch as xops

    coo, st, spmv = _case("xch", dtype)
    st = st.to(cuda)
    vt = getattr(torch, dtype)
    x = torch.from_numpy(np.random.default_rng(2).uniform(
        -1, 1, coo.n_col)).to(cuda, vt)
    fused = xops.xch_fused_rows.launches + xops.xch_fused_rows.launches_f64
    y1 = spmv(st, x)
    torch.cuda.synchronize()
    assert xops.xch_fused_rows.launches + \
        xops.xch_fused_rows.launches_f64 > fused
    y2 = xch.pair_spmv_acc(st, x).to(x.dtype)
    torch.cuda.synchronize()
    within_reorder_bound(coo, st, spmv, x, y1, y2,
                         f"xch fused vs pair {dtype}")


def test_bkt_g_two_calls_drift_within_bound(cuda):
    coo = _scattered(300_000, 900_000, 3)
    st = bkt.convert(coo, Config(bkt_row_group=1024)).to(cuda)
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        -1, 1, coo.n_col).astype(np.float32)).to(cuda)
    y1 = bkt.spmv(st, x)
    y2 = bkt.spmv(st, x)
    torch.cuda.synchronize()
    assert y1.dtype == torch.float32 and y1.shape == (coo.n_row,)
    within_reorder_bound(coo, st, bkt.spmv, x, y1, y2,
                         f"bkt_g float32 (merge parts {st.parts})")
