"""The port's CG and BiCGStab (``singlespmv_tpu_torch/ops/solvers.py``)
against the reference's (``singlespmv_tpu/ops/solvers.py``) on the CPU: the
same iterations within one and x within 1e-8 of max|x| in float64, over
csr, auto and the other formats; preconditioned solves; and the masked
loop's semantics: it stops at ``maxiter`` exactly whatever the chunk, and
any chunk gives the same iterations and x.

Every test runs inside ``x64_restored`` (``tests/test_torch_f64.py``): the
reference's float64 convert turns ``jax_enable_x64`` on for good.
"""
import contextlib
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from singlespmv_tpu.config import Config as RefConfig
from singlespmv_tpu.core.types import COOMatrix as RefCOO
from singlespmv_tpu.ops import ilu as ref_ilu
from singlespmv_tpu.ops import solvers as ref
from singlespmv_tpu_torch.config import Config
from singlespmv_tpu_torch.formats import spmv_fn
from singlespmv_tpu_torch.ops import ilu, solvers
from torch_parity import port_cfg, port_coo

REF64 = RefConfig(format="csr", dtype="float64", verify=False)
F64 = port_cfg(REF64)
X_REL = 1e-8


@contextlib.contextmanager
def x64_restored():
    """Puts ``jax_enable_x64`` back as it was on entry."""
    saved = jax.config.jax_enable_x64
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", saved)


@pytest.fixture(autouse=True)
def _x64_scope():
    with x64_restored():
        jax.config.update("jax_enable_x64", True)
        yield


def laplacian(n):
    """1-D Laplacian (tridiagonal SPD)."""
    i = np.arange(n)
    return RefCOO.from_triplets(
        n, n, np.concatenate([i, i[1:], i[:-1]]),
        np.concatenate([i, i[1:] - 1, i[:-1] + 1]),
        np.concatenate([np.full(n, 2.0), np.full(2 * n - 2, -1.0)]))


def general(n, seed=0):
    """The reference's ``general_matrix`` (tests/test_solvers.py)."""
    rng = np.random.default_rng(seed)
    dense = np.eye(n) * n + rng.uniform(-1, 1, (n, n)) * (rng.uniform(
        size=(n, n)) < 0.15)
    r, c = np.nonzero(dense)
    return RefCOO.from_triplets(n, n, r, c, dense[r, c])


def same_solve(got, want, tol=X_REL):
    assert abs(got.iterations - want.iterations) <= 1
    assert got.converged == want.converged
    assert isinstance(got.x, np.ndarray)
    assert np.abs(got.x - np.asarray(want.x)).max() <= \
        tol * np.abs(np.asarray(want.x)).max()


_REF = {}


def ref_cg_laplacian():
    """The reference's CG on the 1-D Laplacian (csr, f64), run once."""
    if "lap" not in _REF:
        _REF["lap"] = ref.cg(laplacian(128), np.sin(np.arange(128) / 7.0),
                             cfg=REF64, tol=1e-10, maxiter=500)
    return _REF["lap"]


def test_cg_laplacian_matches_the_reference():
    a = laplacian(128)
    b = np.sin(np.arange(128) / 7.0)
    got = solvers.cg(port_coo(a), b, cfg=F64, tol=1e-10, maxiter=500,
                     device="cpu")
    want = ref_cg_laplacian()
    same_solve(got, want)
    assert got.converged and got.info["format"] == "csr"
    np.testing.assert_allclose(a.to_dense() @ got.x, b, atol=1e-8)


@pytest.mark.parametrize("fmt", ["coo", "ell", "jds", "dia", "dense",
                                 "slab", "xch", "css", "ss", "hostlib"])
def test_cg_over_the_formats(fmt):
    a = laplacian(128)
    got = solvers.cg(port_coo(a), np.sin(np.arange(128) / 7.0),
                     cfg=F64.replace(format=fmt), tol=1e-10, maxiter=500,
                     device="cpu")
    same_solve(got, ref_cg_laplacian())


def test_cg_with_ilu0_takes_fewer_iterations():
    a = laplacian(256)
    b = np.ones(256)
    plain = solvers.cg(port_coo(a), b, cfg=F64, tol=1e-8, maxiter=1000,
                       device="cpu")
    M = ilu.ilu0_preconditioner(port_coo(a), F64, device="cpu")
    pre = solvers.cg(port_coo(a), b, cfg=F64, tol=1e-8, maxiter=1000, M=M,
                     device="cpu")
    want = ref.cg(a, b, cfg=REF64, tol=1e-8, maxiter=1000,
                  M=ref_ilu.ilu0_preconditioner(a, REF64))
    assert pre.converged and pre.iterations < plain.iterations
    same_solve(pre, want)


def test_cg_with_ic0_matches_the_reference():
    a = general(80, seed=4)
    a = RefCOO.from_triplets(80, 80, np.concatenate([a.row, a.col]),
                             np.concatenate([a.col, a.row]),
                             np.concatenate([a.val, a.val]),
                             sum_duplicates=True)     # A + Aᵀ: SPD here
    b = np.random.default_rng(1).standard_normal(80)
    want = ref.cg(a, b, cfg=REF64, tol=1e-10, maxiter=200,
                  M=ref_ilu.ic0_preconditioner(a, REF64))
    got = solvers.cg(port_coo(a), b, cfg=F64, tol=1e-10, maxiter=200,
                     M=ilu.ic0_preconditioner(port_coo(a), F64,
                                              device="cpu"), device="cpu")
    assert got.converged
    same_solve(got, want)


@pytest.mark.parametrize("pre", [None, "ilu0"])
def test_bicgstab_general_matches_the_reference(pre):
    a = general(96, seed=2)
    b = np.cos(np.arange(96) / 5.0)
    M = None if pre is None else ilu.ilu0_preconditioner(
        port_coo(a), F64, device="cpu")
    rM = None if pre is None else ref_ilu.ilu0_preconditioner(a, REF64)
    want = ref.bicgstab(a, b, cfg=REF64, tol=1e-9, maxiter=500, M=rM)
    got = solvers.bicgstab(port_coo(a), b, cfg=F64, tol=1e-9, maxiter=500,
                           M=M, device="cpu")
    assert got.converged
    same_solve(got, want)
    np.testing.assert_allclose(a.to_dense() @ got.x, b, atol=1e-6)


def test_cg_with_auto_float64():
    a = laplacian(200)
    cfg = RefConfig(format="auto", dtype="float64", verify=False,
                    segment_width=128)
    want = ref.cg(a, np.ones(200), cfg=cfg, tol=1e-8, maxiter=800)
    got = solvers.cg(port_coo(a), np.ones(200), cfg=port_cfg(cfg), tol=1e-8,
                     maxiter=800, device="cpu")
    assert got.converged and got.info["format"].startswith("auto/")
    same_solve(got, want)


@pytest.mark.parametrize("solver,maxiter", [("cg", 37), ("bicgstab", 5)])
def test_maxiter_stops_the_loop_exactly(solver, maxiter):
    a = laplacian(128) if solver == "cg" else general(96, seed=2)
    b = np.ones(a.n_row)
    want = getattr(ref, solver)(a, b, cfg=REF64, tol=1e-30,
                                maxiter=maxiter)
    got = getattr(solvers, solver)(port_coo(a), b, cfg=F64, tol=1e-30,
                                   maxiter=maxiter, device="cpu")
    assert maxiter % got.info["chunk"]
    assert got.iterations == want.iterations == maxiter
    assert not got.converged and not want.converged
    same_solve(got, want)


@pytest.mark.parametrize("k", [1, 3, 16])
def test_any_chunk_gives_the_same_solve(k):
    a = port_coo(laplacian(64))
    b = torch.from_numpy(np.sin(np.arange(64) / 3.0))
    _, state, spmv = solvers.setup(a, F64, "cpu")
    loops = [solvers.cg_loop(spmv, state, b, tol=1e-10, maxiter=500)
             for _ in range(2)]
    loops[0].run_eager(1)
    info = loops[1].run_eager(k)
    assert info["chunks"] == -(-int(loops[0].carry["it"]) // k)
    for name in loops[0].carry:
        torch.testing.assert_close(loops[1].carry[name],
                                   loops[0].carry[name], rtol=0, atol=0)


def test_the_loop_keeps_the_carry_type():
    a = port_coo(laplacian(32))
    cfg = F64.replace(dtype="float32")
    res = solvers.cg(a, np.ones(32), cfg=cfg, tol=1e-5, maxiter=100,
                     device="cpu")
    assert res.x.dtype == np.float32 and res.converged
    assert res.state is not None and res.info["chunks"] >= 1
    loop = solvers.cg_loop(spmv_fn(cfg), res.state,
                           torch.ones(32, dtype=torch.float32), tol=1e-5,
                           maxiter=100)
    assert {v.dtype for k, v in loop.carry.items() if k != "it"} == {
        torch.float32}


def test_preconditioner_of_another_value_type_raises():
    a = port_coo(laplacian(32))
    M = ilu.ilu0_preconditioner(a, F64, device="cpu")
    for fn in (solvers.cg, solvers.bicgstab):
        with pytest.raises(TypeError, match="value type"):
            fn(a, np.ones(32), cfg=F64.replace(dtype="float32"), M=M,
               device="cpu")


def test_chunk_size_follows_the_graph_budget():
    assert solvers.chunk_size(10) == solvers.CHUNK
    assert solvers.chunk_size(solvers.GRAPH_NODES // 3) == 3
    assert solvers.chunk_size(10 * solvers.GRAPH_NODES) == 1


def test_no_card_raises_unless_the_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solvers.cg(port_coo(laplacian(8)), np.ones(8), cfg=F64)


def test_solver_layer_runs_without_the_reference_package():
    """A fresh process where ``singlespmv_tpu`` cannot be imported: the
    solver layer imports and solves, and neither jax nor the reference
    package is loaded."""
    code = (
        "import sys\n"
        "sys.modules['singlespmv_tpu'] = None\n"
        "import numpy as np, torch\n"
        "from singlespmv_tpu_torch import Config\n"
        "from singlespmv_tpu_torch.data import generate\n"
        "from singlespmv_tpu_torch.ops import ilu, solvers, spgemm, sptrsv\n"
        "a = generate('band', 200, 3, seed=1)\n"
        "cfg = Config(format='slab', dtype='float64', verify=False)\n"
        "M = ilu.ilu0_preconditioner(a, cfg, device='cpu')\n"
        "r = solvers.bicgstab(a, np.ones(200), cfg=cfg, tol=1e-8, M=M,\n"
        "                     device='cpu')\n"
        "assert r.converged, r\n"
        "assert spgemm.spgemm_coo(a, a, device='cpu').nnz > a.nnz\n"
        "bad = sorted(m for m in sys.modules if m.startswith("
        "('jax', 'singlespmv_tpu.')) or m == 'jaxlib')\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
