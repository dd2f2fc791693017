"""Requests of one CG solve of ``maxiter`` iterations (``tol`` 0, so every
solve runs them all), each on the next right-hand side b = A x* of a pool
of ``pool``, x* uniform in [-1, 1) from the seed and b made by the
reference (its seconds are not set-up's).  Each solve goes through the port's ``cg_loop(...).run``: its
chunks captured as a CUDA graph and replayed until the loop ends.

Parameters (the traffic file): ``maxiter``, ``tol``, ``pool``, ``sample``
(solutions kept for the check)."""
from __future__ import annotations

import time

import torch

from benchmark import reference


class Traffic:
    columns = 1

    def __init__(self, run, spec: dict):
        self.run, self.spec = run, spec
        self.maxiter = int(spec["maxiter"])
        self.tol = float(spec["tol"])
        self.products_per_request = self.maxiter
        self.sample = int(spec["sample"])
        m = run.matrix
        xs = torch.rand((int(spec["pool"]), m.n_col), generator=run.gen,
                        device=run.device, dtype=torch.float64) * 2 - 1
        with run.reference_work():
            op = reference.Operator(m, run.device)
            self.b = torch.stack([op.matvec(x) for x in xs]).to(
                reference.value_type(run.dtype))
            del op

    def _solve(self, b):
        run = self.run
        with run.span("bench.loop"):
            loop = run.port.cg_loop(run.cfg, run.state, b, tol=self.tol,
                                    maxiter=self.maxiter)
        with run.span("bench.solve"):
            return run.port.solve(run.cfg, run.state, loop)

    def warm(self, traced: bool = False):
        """One solve, which captures and replays as every request does."""
        x, _, _ = self._solve(self.b[0])
        self.kept = torch.empty((self.sample,) + tuple(x.shape),
                                dtype=x.dtype, device=x.device)
        self.kept_it = torch.zeros(self.sample, dtype=torch.int64,
                                   device=x.device)
        self.kept_input = [None] * self.sample
        self.run.synchronize()

    def request(self, i: int, slot):
        run = self.run
        p = i % self.b.shape[0]
        t0 = time.perf_counter()
        with run.segment("solve", "bench.launch"):
            x, it, info = self._solve(self.b[p])
        with run.span("bench.sync"):
            run.synchronize()
        t1 = time.perf_counter()
        if slot is not None:
            with run.segment("keep", "bench.keep"):
                self.kept[slot].copy_(x)
                self.kept_it[slot].copy_(it)
            self.kept_input[slot] = p
        return {"solve_s": t1 - t0, "capture_s": info.get("capture_s")}

    def free(self):
        pass

    def check(self, op: reference.Operator) -> dict:
        """``x_err``: the worst kept solution's max |x − x_ref| / max
        |x_ref| against ``maxiter`` iterations of the reference's CG from
        the same b (made in the configuration's type); ``iters_off``: how
        far a kept solve's iteration count lies from ``maxiter``."""
        err, off = 0.0, 0
        kept_it = self.kept_it.tolist()
        for slot, p in enumerate(self.kept_input):
            if p is None:
                continue
            ref = reference.cg(op, self.b[p].double(), self.maxiter)
            err = max(err, reference.vector_error(self.kept[slot], ref))
            off = max(off, abs(kept_it[slot] - self.maxiter))
        return {"x_err": err, "iters_off": off}
