"""singlespmv_tpu_torch — the PyTorch and CUDA port of singlespmv_tpu.

The JAX package ``singlespmv_tpu`` stays the reference: every module here
mirrors the name of its counterpart there, and the tests hold the two against
each other on the same inputs.  This package imports torch and numpy and never
jax.  It reuses the reference's framework-free host modules by name
(``config``, ``core.{types, mmio, oracle, rng, hostmem, chipconst}``,
``data``); importing those leaves jax unloaded.

Ported so far: the slab format (``formats/slab.py``) and its two CUDA
kernels (``csrc/slab.cu`` behind ``ops/slab.py``), the xch v4 exchange
engine (``formats/xch.py``) and its two CUDA kernels (``csrc/xch.cu`` behind
``ops/xch.py``), and the benchmark driver (``harness/driver.py``).
ROADMAP.md lists what is still to come.
"""
from singlespmv_tpu.config import Config

__all__ = ["Config"]
