"""Port spmv on the card: how far y drifts between two calls on one state.

The slab and xch routes add run totals into y with float reductions in the
order the warps run (``csrc/slab.cu``, ``csrc/xch.cu``), so two calls on the
same state and x may differ in the last bits where several run ends land on
one row; the reference's Pallas kernels write their out blocks in a fixed
order.  The drift is held to 1e-6·max|y| at float32 and 1e-12·max|y| at
float64, far inside the oracle's bound, on a merged slab state (run ends
per stream row at or above ``MERGE_ENDS``), a direct slab state, an xch
state and a bkt_g state (float32 only, as bkt is; ``csrc/bucket.cu``).
Each case prints whether the two results were bitwise equal.

Needs an NVIDIA GPU and skips without one.  This file imports no jax:

    python -m pytest --noconftest -p no:cacheprovider -q -s tests/test_torch_cuda_drift.py
"""
import numpy as np
import pytest
import torch

from singlespmv_tpu_torch import Config
from singlespmv_tpu_torch.data import powerlaw
from singlespmv_tpu_torch.formats import bkt, slab, xch

from test_torch_cuda_slab import _state as slab_state
from test_torch_cuda_slab import piled_rows
from test_torch_cuda_bkt import _scattered
from test_torch_cuda_xch import _scatter

pytestmark = pytest.mark.cuda

DRIFT = {torch.float32: 1e-6, torch.float64: 1e-12}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


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
    coo = _scatter(40000, 200000, seed=8, long_rows=4)
    return coo, xch.convert(coo, Config(format="xch", dtype=dtype)), xch.spmv


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("kind", ["slab merged", "slab direct", "xch"])
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
    scale = float(y1.abs().max())
    drift = float((y1 - y2).abs().max())
    print(f"{kind} {dtype}: bitwise equal {torch.equal(y1, y2)}, max drift "
          f"{drift:.3g} of max|y| {scale:.3g}")
    assert scale > 0 and drift <= DRIFT[vt] * scale


def test_bkt_g_two_calls_drift_within_bound(cuda):
    coo = _scattered(300_000, 900_000, 3)
    st = bkt.convert(coo, Config(bkt_row_group=1024)).to(cuda)
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        -1, 1, coo.n_col).astype(np.float32)).to(cuda)
    y1 = bkt.spmv(st, x)
    y2 = bkt.spmv(st, x)
    torch.cuda.synchronize()
    scale = float(y1.abs().max())
    drift = float((y1 - y2).abs().max())
    assert y1.dtype == torch.float32 and y1.shape == (coo.n_row,)
    print(f"bkt_g float32 (merge parts {st.parts}): bitwise "
          f"equal {torch.equal(y1, y2)}, max drift {drift:.3g} of max|y| "
          f"{scale:.3g}")
    assert scale > 0 and drift <= DRIFT[torch.float32] * scale
