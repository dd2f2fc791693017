"""The parallel layer of the port: the reference's
``singlespmv_tpu/parallel/``, where matrices are row/column-partitioned
over a ``jax.sharding.Mesh`` and x and y move by XLA collectives inside
``shard_map``.

Here a mesh (``mesh.py``) has two backends: ``local``, every shard in this
process on one device (the card, or the CPU on request), its collectives
torch operations there; and ``dist``, one shard a rank of a
``torch.distributed`` group (gloo on the CPU, NCCL on cards).  The
operators ``DistSpMV`` (``spmv.py``), ``HaloSpMV`` (``halo.py``) and
``DistXch`` (``xchd.py``) run the port's kernels shard by shard;
``bench.py`` is the scaling harness and ``dryrun.py`` the multichip
dryrun."""
from .halo import HaloSpMV
from .mesh import Mesh, device_count, make_mesh
from .spmv import DistSpMV, partition_rows_balanced
from .xchd import DistXch

__all__ = ["make_mesh", "device_count", "DistSpMV", "DistXch", "HaloSpMV",
           "Mesh", "partition_rows_balanced"]
