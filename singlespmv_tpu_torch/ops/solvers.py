"""Iterative solvers over the formats' spmv: ``singlespmv_tpu/ops/solvers.py``.

CG and BiCGStab run on a converted state of any registered format, ``auto``
by default, with an optional preconditioner ``M``, any callable on tensors
(``ops/ilu.py``'s among them).

The reference compiles each solver into one ``lax.while_loop``.  Its
counterpart here is ``MaskedLoop``: the carry lives in fixed tensors, and
one iteration computes ``active = (‖r‖ > tol·‖b‖) & (it < maxiter)`` on
the device, updates every carry with ``torch.where(active, new, old)`` and
adds ``active`` to the count.  An iteration after the loop's end therefore
changes nothing, so the iteration count, ``converged`` and the residual are
the reference's whatever number of iterations runs between two looks of
the host at ``active``.  On a CUDA device ``CHUNK`` such iterations (fewer
where a preconditioner's levels would make the graph large:
``chunk_size``) are captured once as a CUDA graph and replayed until
``active`` reads false, one host read a replay; a capture that fails
raises ``CaptureError`` naming the format, and nothing falls back to an
eager loop.  On the CPU the same chunk runs eagerly.
"""
from __future__ import annotations

import ctypes
import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from .. import formats
from ..config import Config
from ..core.types import COOMatrix
from ..harness.driver import CaptureError, device_of

CHUNK = 16              # iterations a CUDA graph holds at most
GRAPH_NODES = 1 << 15   # device operations a graph holds at most
SPMV_NODES = 8          # an spmv's device operations, the estimate that
#                         sizes a chunk (glue and kernels of the formats)
CG_NODES = 24           # a CG iteration's own operations, masking included
BICGSTAB_NODES = 40     # a BiCGStab iteration's


@dataclasses.dataclass
class SolveResult:
    x: np.ndarray
    iterations: int
    residual: float
    converged: bool
    state: object = None    # the converted state the products ran on
    info: dict = dataclasses.field(default_factory=dict)  # chunk, graph and
    #                                                       seconds


def chunk_size(nodes_per_iter: int) -> int:
    """Iterations a graph holds: ``CHUNK``, fewer where that many would
    exceed ``GRAPH_NODES`` operations (at least one)."""
    return max(1, min(CHUNK, GRAPH_NODES // max(int(nodes_per_iter), 1)))


def _new_graph():
    """(graph, kept): a CUDA graph that keeps its cudaGraph_t for
    ``graph_nodes`` where this torch can keep one (``instantiate`` then
    builds the executable), else a plain one."""
    try:
        return torch.cuda.CUDAGraph(keep_graph=True), True
    except TypeError:
        return torch.cuda.CUDAGraph(), False


def graph_nodes(graph) -> Optional[int]:
    """The nodes of a captured graph that kept its cudaGraph_t
    (``cuGraphGetNodes``); None where the driver is not reachable."""
    try:
        cuda = ctypes.CDLL("libcuda.so.1")
    except OSError:
        return None
    count = ctypes.c_size_t(0)
    cuda.cuGraphGetNodes.restype = ctypes.c_int
    cuda.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_size_t)]
    rc = cuda.cuGraphGetNodes(graph.raw_cuda_graph(), None,
                              ctypes.byref(count))
    return int(count.value) if rc == 0 else None


class MaskedLoop:
    """``while cond(carry): carry = body(carry)`` as masked iterations on
    fixed carry tensors (``step``), run in chunks of k iterations, eagerly
    (``run_eager``) or as one replayed CUDA graph (``run_graph``)."""

    def __init__(self, carry: dict, body: Callable, cond: Callable,
                 nodes_per_iter: int):
        self.carry = {name: v.clone() for name, v in carry.items()}
        self.body, self.cond = body, cond
        self.nodes_per_iter = nodes_per_iter
        self.active = cond(self.carry).clone()

    def step(self) -> None:
        """One iteration where ``active``, none where not.  The branch not
        taken may hold NaN (ρ/ρ once r = 0): ``where`` drops it."""
        for name, v in self.body(self.carry).items():
            c = self.carry[name]
            torch.where(self.active, v, c, out=c)
        self.active.copy_(self.cond(self.carry))

    def chunk(self, k: int) -> None:
        for _ in range(k):
            self.step()

    def run_eager(self, k: int) -> dict:
        """Chunks of k eager iterations until ``active`` reads false."""
        t0 = time.perf_counter()
        chunks = 0
        while bool(self.active):
            self.chunk(k)
            chunks += 1
        return {"chunk": k, "chunks": chunks,
                "loop_s": time.perf_counter() - t0}

    def run_graph(self, k: int, name: str) -> dict:
        """Captures a chunk of k iterations and replays it until ``active``
        reads false.  The warm-up step, on a side stream as torch's CUDA
        graph documentation asks, runs on a copy of the carry, so the solve
        starts from the carry as it is."""
        if not bool(self.active):
            return {"chunk": k, "chunks": 0, "capture_s": 0.0,
                    "loop_s": 0.0, "graph_nodes": 0}
        dev = self.active.device
        t0 = time.perf_counter()
        graph, kept = _new_graph()
        try:
            warm = MaskedLoop(self.carry, self.body, self.cond,
                              self.nodes_per_iter)
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                warm.step()
            torch.cuda.current_stream(dev).wait_stream(side)
            torch.cuda.synchronize(dev)
            del warm
            with torch.cuda.graph(graph):
                self.chunk(k)
            if kept:
                graph.instantiate()
        except Exception as e:
            raise CaptureError(
                f"{name}: the warm-up or CUDA graph capture of {k} solver "
                f"iterations failed: {type(e).__name__}: {e}") from e
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        chunks = 0
        while bool(self.active):
            graph.replay()
            chunks += 1
        return {"chunk": k, "chunks": chunks, "capture_s": t1 - t0,
                "loop_s": time.perf_counter() - t1,
                "graph_nodes": graph_nodes(graph) if kept else None}

    def run(self, name: str) -> dict:
        """The solve on the carry's device: graph replays on a CUDA device,
        eager chunks on the CPU."""
        k = chunk_size(self.nodes_per_iter)
        if self.active.device.type == "cuda":
            return self.run_graph(k, name)
        return self.run_eager(k)


def setup(coo: COOMatrix, cfg: Optional[Config], device):
    """(cfg, state on the device, spmv), the state converted as the driver
    converts it; the reference's default cfg."""
    cfg = cfg or Config(format="auto", dtype="float32", verify=False)
    dev = device_of(device)
    if cfg.format == "auto":
        state = formats.get_format("auto").convert(coo, cfg,
                                                   device=dev).to(dev)
    else:
        state = formats.convert(coo, cfg).to(dev)
    return cfg, state, formats.spmv_fn(cfg)


def _rhs(b, cfg: Config, device) -> torch.Tensor:
    if isinstance(b, torch.Tensor):
        return b.to(device=device, dtype=getattr(torch, cfg.dtype))
    return torch.from_numpy(np.array(b, dtype=cfg.np_dtype)).to(device)


def _m_nodes(M, b: torch.Tensor) -> int:
    """A preconditioner's operations an apply (0 for the identity); a
    preconditioner that states its value type must have b's."""
    if M is None:
        return 0
    dtype = getattr(M, "dtype", b.dtype)
    if dtype != b.dtype:
        raise TypeError(f"the preconditioner is {dtype}, b {b.dtype}: build "
                        "it in the solver's value type")
    return getattr(M, "graph_nodes", 0)


def cg_loop(spmv, state, b: torch.Tensor, *, tol: float, maxiter: int,
            M: Optional[Callable] = None) -> MaskedLoop:
    """Conjugate gradients on A = ``state`` as a ``MaskedLoop`` (the
    reference's ``cg`` body and cond), started at x = 0."""
    m_nodes = _m_nodes(M, b)
    Mi = M if M is not None else (lambda v: v)
    thresh = tol * torch.linalg.vector_norm(b)

    def body(c):
        Ap = spmv(state, c["p"])
        alpha = c["rz"] / torch.dot(c["p"], Ap)
        r = c["r"] - alpha * Ap
        z = Mi(r)
        rz = torch.dot(r, z)
        return {"x": c["x"] + alpha * c["p"], "r": r,
                "p": z + (rz / c["rz"]) * c["p"], "rz": rz,
                "it": c["it"] + 1}

    def cond(c):
        return ((torch.linalg.vector_norm(c["r"]) > thresh)
                & (c["it"] < maxiter))

    z0 = Mi(b)
    carry = {"x": torch.zeros_like(b), "r": b, "p": z0,
             "rz": torch.dot(b, z0),
             "it": torch.zeros((), dtype=torch.int64, device=b.device)}
    return MaskedLoop(carry, body, cond,
                      CG_NODES + SPMV_NODES + m_nodes)


def bicgstab_loop(spmv, state, b: torch.Tensor, *, tol: float,
                  maxiter: int, M: Optional[Callable] = None) -> MaskedLoop:
    """BiCGStab on A = ``state``, right-preconditioned, as a
    ``MaskedLoop`` (the reference's ``bicgstab`` body and cond)."""
    m_nodes = _m_nodes(M, b)
    Mi = M if M is not None else (lambda v: v)
    thresh = tol * torch.linalg.vector_norm(b)
    rhat = b

    def body(c):
        rho = torch.dot(rhat, c["r"])
        beta = (rho / c["rho"]) * (c["alpha"] / c["omega"])
        p = c["r"] + beta * (c["p"] - c["omega"] * c["v"])
        phat = Mi(p)
        v = spmv(state, phat)
        alpha = rho / torch.dot(rhat, v)
        s = c["r"] - alpha * v
        shat = Mi(s)
        t = spmv(state, shat)
        omega = torch.dot(t, s) / torch.dot(t, t)
        return {"x": c["x"] + alpha * phat + omega * shat,
                "r": s - omega * t, "p": p, "v": v, "rho": rho,
                "alpha": alpha, "omega": omega, "it": c["it"] + 1}

    def cond(c):
        return ((torch.linalg.vector_norm(c["r"]) > thresh)
                & (c["it"] < maxiter))

    one = torch.ones((), dtype=b.dtype, device=b.device)
    carry = {"x": torch.zeros_like(b), "r": b, "p": torch.zeros_like(b),
             "v": torch.zeros_like(b), "rho": one, "alpha": one,
             "omega": one,
             "it": torch.zeros((), dtype=torch.int64, device=b.device)}
    return MaskedLoop(carry, body, cond,
                      BICGSTAB_NODES + 2 * (SPMV_NODES + m_nodes))


def _solve(make_loop, coo, b, cfg, tol, maxiter, M, device) -> SolveResult:
    t0 = time.perf_counter()
    cfg, state, spmv = setup(coo, cfg, device)
    dev = device_of(device)
    bd = _rhs(b, cfg, dev)
    bnorm = float(torch.linalg.vector_norm(bd))
    t1 = time.perf_counter()
    loop = make_loop(spmv, state, bd, tol=tol, maxiter=maxiter, M=M)
    name = cfg.format + (f"/{state.chosen}" if cfg.format == "auto" else "")
    info = loop.run(name)
    res = float(torch.linalg.vector_norm(loop.carry["r"]))
    x = loop.carry["x"].cpu().numpy()
    info |= {"format": name, "nodes_per_iter_est": loop.nodes_per_iter,
             "convert_s": t1 - t0, "wall_s": time.perf_counter() - t1}
    return SolveResult(x, int(loop.carry["it"]), res,
                       res <= tol * bnorm * 1.001, state, info)


def cg(coo: COOMatrix, b, *, cfg: Optional[Config] = None, tol: float = 1e-6,
       maxiter: int = 1000, M: Optional[Callable] = None,
       device="cuda") -> SolveResult:
    """Conjugate gradients (SPD A), optionally preconditioned, on
    ``device``."""
    return _solve(cg_loop, coo, b, cfg, tol, maxiter, M, device)


def bicgstab(coo: COOMatrix, b, *, cfg: Optional[Config] = None,
             tol: float = 1e-6, maxiter: int = 1000,
             M: Optional[Callable] = None, device="cuda") -> SolveResult:
    """BiCGStab (general square A), optionally right-preconditioned, on
    ``device``."""
    return _solve(bicgstab_loop, coo, b, cfg, tol, maxiter, M, device)
