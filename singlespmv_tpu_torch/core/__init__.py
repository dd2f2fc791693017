"""The reference's framework-free host layer (``singlespmv_tpu.core``), which
the port uses as it is: the COO container, the float64 oracle and the seeded
input vector.  Importing it leaves jax unloaded."""
from singlespmv_tpu.core.oracle import reference_spmv, verify_result
from singlespmv_tpu.core.rng import create_random_vector
from singlespmv_tpu.core.types import COOMatrix

__all__ = ["COOMatrix", "create_random_vector", "reference_spmv",
           "verify_result"]
