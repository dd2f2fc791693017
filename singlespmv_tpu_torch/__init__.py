"""singlespmv_tpu_torch — the PyTorch and CUDA port of singlespmv_tpu.

The JAX package ``singlespmv_tpu`` stays the reference: every module here
mirrors the name of its counterpart there, and the tests hold the two against
each other on the same inputs.  This package imports torch and numpy and never
jax, and nothing of the reference package: it keeps its own copies of the
reference's framework-free host modules (``config``, ``core``, ``data``), so
it imports and runs where ``singlespmv_tpu`` is absent.

The formats are in ``formats/`` (``formats.available_formats()`` lists
them), their hand-written CUDA kernels in ``csrc/`` behind the wrappers of
``ops/``, and the benchmark driver in ``harness/driver.py``.  README.md says
what is ported, ROADMAP.md what is still to come.
"""
from .config import Config

__all__ = ["Config"]
