"""Useful work over the whole window: 2·nnz·B flops for each product the
completed requests hold (B columns; not the steps between chained
products), over the window's seconds on the host clock."""


def read(ctx):
    r = ctx["run"]
    if not ctx["products"] or ctx["window_s"] <= 0:
        return None
    return (2.0 * r.matrix.nnz * r.traffic.columns * ctx["products"]
            / ctx["window_s"] / 1e9)
