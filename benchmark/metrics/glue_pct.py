"""The share of a product's device busy time spent outside the program's
own CUDA kernels (named by the ``__global__`` declarations of its
``csrc/``), from the product segments of a complete trace."""


def read(ctx):
    tr = ctx["trace"]
    if not tr or tr["refused"] or not tr.get("product_busy_s"):
        return None
    return 100.0 * (1.0 - tr["product_port_s"] / tr["product_busy_s"])
