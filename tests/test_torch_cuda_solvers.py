"""The solver layer on the card: CG and BiCGStab captured as CUDA graphs
against the same chunk function run eagerly on the same state, their
masked iterations at any chunk, the captures that must fail, and SpTRSV
and SpGEMM against scipy.

Needs an NVIDIA GPU and skips without one.  This file imports no jax:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_solvers.py

A captured solve and the eager one make the same float64 operations in the
same order but for the routes' run totals (ROADMAP C.7), so they agree to
1e-10 of max|x| and in their iteration counts.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.sparse.linalg import spsolve_triangular

from singlespmv_tpu_torch import Config
from singlespmv_tpu_torch.core import COOMatrix, reference_spmv
from singlespmv_tpu_torch.data import powerlaw
from singlespmv_tpu_torch.formats import spmv_fn
from singlespmv_tpu_torch.harness.driver import CaptureError
from singlespmv_tpu_torch.ops import ilu, solvers, spgemm, sptrsv

pytestmark = pytest.mark.cuda

REL = 1e-10


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def grid(n, peclet=0.0):
    """The 7-point operator on an n³ grid: −Δ, with upwind convection
    along x at cell Péclet ``peclet``."""
    idx = np.arange(n ** 3).reshape(n, n, n)
    rows, cols = [idx.ravel()], [idx.ravel()]
    vals = [np.full(n ** 3, 6.0 + peclet)]
    for axis in range(3):
        lo = np.take(idx, np.arange(n - 1), axis=axis).ravel()
        hi = np.take(idx, np.arange(1, n), axis=axis).ravel()
        up = peclet if axis == 2 else 0.0
        rows += [hi, lo]
        cols += [lo, hi]
        vals += [np.full(lo.size, -1.0 - up), np.full(lo.size, -1.0)]
    return COOMatrix.from_triplets(n ** 3, n ** 3, np.concatenate(rows),
                                   np.concatenate(cols), np.concatenate(vals))


CASES = [("cg", "slab", None), ("cg", "slab", "ic0"), ("cg", "csr", "ilu0"),
         ("bicgstab", "slab", None), ("bicgstab", "slab", "ilu0"),
         ("bicgstab", "xch", None)]


@pytest.mark.parametrize("solver,fmt,pre", CASES)
def test_captured_solve_matches_eager(cuda, solver, fmt, pre):
    a = grid(12, 0.0 if solver == "cg" else 4.0)
    b = np.random.default_rng(0).uniform(-1, 1, a.n_row)
    cfg = Config(format=fmt, dtype="float64", verify=False)
    M = None if pre is None else getattr(ilu, f"{pre}_preconditioner")(
        a, cfg, device=cuda)
    fn = getattr(solvers, solver)
    res = fn(a, b, cfg=cfg, tol=1e-10, maxiter=500, M=M, device=cuda)
    assert res.converged and res.info["chunks"] >= 1
    assert np.linalg.norm(b - reference_spmv(a, res.x)) <= \
        1e-10 * np.linalg.norm(b) * 1.001
    loop = getattr(solvers, f"{solver}_loop")(
        spmv_fn(cfg), res.state, torch.from_numpy(b).to(cuda), tol=1e-10,
        maxiter=500, M=M)
    loop.run_eager(res.info["chunk"])
    x = loop.carry["x"].cpu().numpy()
    assert int(loop.carry["it"]) == res.iterations
    assert np.abs(x - res.x).max() <= REL * np.abs(res.x).max()


@pytest.mark.parametrize("k", [1, 5, 16])
def test_graph_stops_at_maxiter_whatever_the_chunk(cuda, k):
    a = grid(10)
    b = np.ones(a.n_row)
    cfg = Config(format="slab", dtype="float64", verify=False)
    _, state, spmv = solvers.setup(a, cfg, cuda)
    loop = solvers.cg_loop(spmv, state, torch.from_numpy(b).to(cuda),
                           tol=1e-14, maxiter=7, M=None)
    info = loop.run_graph(k, "slab")
    assert int(loop.carry["it"]) == 7 and not bool(loop.active)
    assert info["chunks"] == -(-7 // k)
    if info["graph_nodes"] is not None:
        assert info["graph_nodes"] > k


def test_hostlib_state_on_the_card_raises_capture_error(cuda):
    a = grid(6)
    with pytest.raises(CaptureError, match="hostlib"):
        solvers.cg(a, np.ones(a.n_row), cfg=Config(
            format="hostlib", dtype="float64", verify=False), device=cuda)


def test_preconditioner_of_another_value_type_raises(cuda):
    a = grid(6)
    M = ilu.ic0_preconditioner(a, Config(dtype="float64"), device=cuda)
    with pytest.raises(TypeError, match="value type"):
        solvers.cg(a, np.ones(a.n_row), cfg=Config(
            format="slab", dtype="float32", verify=False), M=M, device=cuda)
    with pytest.raises(TypeError, match="value type"):
        M(torch.ones(a.n_row, dtype=torch.float32, device=cuda))


@pytest.mark.parametrize("lower", [True, False])
def test_sptrsv_against_scipy(cuda, lower):
    L = ilu.ic0(grid(14))
    t = L if lower else COOMatrix.from_triplets(L.n_row, L.n_col, L.col,
                                                L.row, L.val)
    b = np.random.default_rng(1).uniform(-1, 1, t.n_row)
    y = sptrsv.sptrsv(t, torch.from_numpy(b).to(cuda), lower=lower,
                      device=cuda).cpu().numpy()
    want = spsolve_triangular(sp.csr_matrix((t.val, (t.row, t.col)),
                                            shape=(t.n_row, t.n_col)),
                              b, lower=lower)
    assert np.abs(y - want).max() <= REL * np.abs(want).max()


def test_spgemm_against_scipy(cuda):
    a = powerlaw(3000, 24000, seed=3)
    c = spgemm.spgemm_coo(a, a, device=cuda)
    A = sp.csr_matrix((a.val, (a.row, a.col)), shape=(a.n_row, a.n_col))
    ref = (A @ A).tocoo()
    order = np.lexsort((ref.col, ref.row))
    assert np.array_equal(c.row, ref.row[order])
    assert np.array_equal(c.col, ref.col[order])
    np.testing.assert_allclose(c.val, ref.data[order], rtol=1e-12,
                               atol=1e-12 * np.abs(ref.data).max())
