"""Seconds from the process's start to the window's: imports, the device's
start, the kernels' build or load, the matrix, the convert, the inputs and
the warm-up (``harness.Run.setup``)."""


def read(ctx):
    return ctx["run"].setup_s
