"""A product's share of its roofline: the CSR-minimum bytes of one product
(``yardstick.csr_min_bytes``, from the benchmark's own matrix) at the
card's published bandwidth, over the device's busy time a product segment
of a complete trace (one product each)."""


def read(ctx):
    tr, peaks = ctx["trace"], ctx["peaks"]
    if not tr or tr["refused"] or not peaks or not tr.get("product_busy_s"):
        return None
    bound_s = ctx["csr_min_bytes"] / peaks["hbm_bytes_per_s"]
    return 100.0 * bound_s / (tr["product_busy_s"] / tr["product_segments"])
