"""The 95th percentile of a request's milliseconds from its start to its
synchronised end, over every request of the window (``statistics.
quantiles``, exclusive method)."""
import statistics


def read(ctx):
    t = [q["solve_s"] * 1e3 for q in ctx["requests"] if "solve_s" in q]
    return statistics.quantiles(t, n=20)[-1] if len(t) > 1 else None
