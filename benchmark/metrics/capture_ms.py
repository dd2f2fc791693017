"""The median over the untraced requests of the solver's capture of its
chunk as a CUDA graph (``MaskedLoop.run_graph``'s ``capture_s``), ms."""
import statistics


def read(ctx):
    t = [q["capture_s"] * 1e3 for q in ctx["requests"]
         if q.get("capture_s") is not None]
    return statistics.median(t) if t else None
