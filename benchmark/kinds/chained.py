"""Requests of ``chain`` chained products Y = A X, each product's answer
entering the next one's input: x_{k+1} = y_k / max|y_k| + u_{k+1}
(``reference.step``, column by column), the drives u_k inputs of a pool of
``pool`` made from the seed.  A request copies the next input of the pool
into x_0 and runs the chain: a CUDA graph of the whole chain, captured
once in set-up by the benchmark itself around the program's product and
replayed, then waits for it.  ``columns`` 1 is y = A x (the format's
spmv), more is SpMM.  The answer judged, the last y, depends on every
product of the chain.

Parameters (the traffic file): ``chain``, ``pool``, ``columns``,
``sample`` (answers kept: the last product of each is judged row by row),
``chains`` (of those, how many are judged against the reference's whole
chain)."""
from __future__ import annotations

import torch

from benchmark import reference, trace

WARMUP_CALLS = 3


class Traffic:
    def __init__(self, run, spec: dict):
        self.run, self.spec = run, spec
        self.columns = int(spec["columns"])
        self.chain = int(spec["chain"])
        self.products_per_request = self.chain
        shape = (int(spec["pool"]), run.matrix.n_col) + (
            (self.columns,) if self.columns > 1 else ())
        self.pool = (torch.rand(shape, generator=run.gen, device=run.device,
                                dtype=torch.float64) * 2 - 1).to(
            reference.value_type(run.dtype))
        self.sample = int(spec["sample"])
        self.chains = int(spec["chains"])

    def _body(self, fn, x, marks: bool):
        """The chain from the input buffer ``x``: (its last input, its
        last answer).  With ``marks`` a spin mark leads each product and
        each step, so a trace cuts them apart."""
        state, drives = self.run.state, self.pool
        for k in range(self.chain):
            if marks:
                trace.mark()
            x_last = x
            y = fn(state, x)
            if k + 1 < self.chain:
                if marks:
                    trace.mark()
                x = reference.step(y, drives[(k + 1) % drives.shape[0]])
        return x_last, y

    def warm(self, traced: bool = False):
        """The chain captured as a CUDA graph (a second one with spin
        marks for a traced run), and one request run."""
        run = self.run
        self.x = self.pool[0].clone()
        fn = run.port.product(run.cfg, self.columns)
        self.graphs = {}
        if run.device.type == "cuda":
            side = torch.cuda.Stream(run.device)
            side.wait_stream(torch.cuda.current_stream(run.device))
            with torch.cuda.stream(side):
                for _ in range(WARMUP_CALLS):
                    fn(run.state, self.x)
            torch.cuda.current_stream(run.device).wait_stream(side)
            run.synchronize()
            for marks in (False, True) if traced else (False,):
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    x_last, y = self._body(fn, self.x, marks)
                self.graphs[marks] = (graph, x_last, y)
        else:
            self.fn = fn
        x_last, out = self._replay(False)
        self.kept = torch.empty((self.sample,) + tuple(out.shape),
                                dtype=out.dtype, device=out.device)
        self.kept_x = torch.empty_like(self.kept)
        self.kept_input = [None] * self.sample
        run.synchronize()

    def _replay(self, marks: bool):
        if not self.graphs:
            return self._body(self.fn, self.x, False)
        graph, x_last, y = self.graphs[marks]
        graph.replay()
        return x_last, y

    def request(self, i: int, slot):
        run = self.run
        p = i % self.pool.shape[0]
        with run.segment("input", "bench.x_copy"):
            self.x.copy_(self.pool[p])
        with run.span("bench.launch"):
            if run.tracing:
                run.kinds.extend(["product", "step"] * (self.chain - 1)
                                 + ["product"])
            x_last, out = self._replay(run.tracing)
        if slot is not None:
            with run.segment("keep", "bench.keep"):
                self.kept[slot].copy_(out)
                self.kept_x[slot].copy_(x_last)
            self.kept_input[slot] = p
        with run.span("bench.sync"):
            run.synchronize()
        return {}

    def free(self):
        self.graphs = self.fn = self.x = None

    def check(self, op: reference.Operator) -> dict:
        """``y_err``: every kept answer's worst row against the reference's
        product of the input the last product was given, in units of the
        row's Σ|a_ij x_j|; ``chain_err``: the first ``chains`` kept
        answers against the reference's whole chain from the same x_0, in
        units of the answer's largest entry."""
        y_err, chain_err, chains = 0.0, 0.0, 0
        drives = list(self.pool.double())
        for slot, p in enumerate(self.kept_input):
            if p is None:
                continue
            x = self.kept_x[slot].double()
            y_err = max(y_err, reference.row_error(
                self.kept[slot], op.matvec(x), op.abs_sums(x)))
            if chains < self.chains:
                chains += 1
                chain_err = max(chain_err, reference.vector_error(
                    self.kept[slot],
                    reference.chain(op, drives[p], drives, self.chain)))
        return {"y_err": y_err, "chain_err": chain_err}
