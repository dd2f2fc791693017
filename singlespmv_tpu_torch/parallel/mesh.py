"""The device mesh of the parallel operators (the reference's
``singlespmv_tpu/parallel/mesh.py:9-42``, where a mesh is a
``jax.sharding.Mesh`` and the collectives run inside ``shard_map``).

A ``Mesh`` names its axes and their sizes and holds one device.  Shard s of
a mesh of sizes (n_0, n_1, ...) sits at the row-major coordinates of s, as
in the reference's reshaped device array.  The operators keep the tensors
of the shards that this process holds in a list, in shard order, and call
the mesh's collectives on that list; each returns a list of the same
length:

- ``all_gather(parts, axis)``: each shard gets the parts of the shards
  along ``axis`` through it, concatenated along dim 0 in axis order (the
  reference's tiled ``all_gather``);
- ``ppermute(parts, pairs, axis)``: ``pairs`` holds (src, dst) axis
  indices, each index at most once as src and once as dst; shard dst gets
  src's part, a shard that is no dst gets zeros;
- ``psum(parts, axis)``: each shard gets the sum of the parts along
  ``axis``, added in axis order on a local mesh and in ``all_reduce``'s
  order under ``dist`` (the same bits for two parts).

A collective over an axis the mesh lacks returns the parts as they are.

Two backends:

- ``local``: all shards live in this process, on the mesh's device (what
  XLA's virtual devices give the reference).  The collectives are torch
  operations on that device; a result that several shards share is one
  tensor, which no operator writes into.
- ``dist``: one shard a rank of an initialised ``torch.distributed``
  group whose world size is the mesh size; shard s is rank s.  Gathers go
  through ``all_gather``, permutations through ``batch_isend_irecv``, sums
  through ``all_reduce``, each on the axis's group (the world where the
  axis spans it, else a subgroup made at ``make_mesh``).  Every rank calls
  every collective of an operator in the same order.

Neither backend gives way to the other: ``make_mesh(backend="dist")``
without an initialised group, or with a world of another size, raises.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..harness.driver import device_of

LOCAL_SHARDS = 8      # the reference's virtual CPU devices (tests/conftest.py)
BACKENDS = ("local", "dist")


def _dist():
    import torch.distributed as dist

    return dist


def device_count(backend: Optional[str] = None) -> int:
    """Shards a mesh can have: the world size under ``dist``, and under
    ``local`` ``LOCAL_SHARDS``.  Without ``backend``, ``dist`` where a
    torch.distributed group is initialised, else ``local``."""
    if backend is None:
        dist = _dist()
        backend = "dist" if dist.is_available() and dist.is_initialized() \
            else "local"
    if backend == "dist":
        return _dist().get_world_size()
    if backend != "local":
        raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
    return LOCAL_SHARDS


class Mesh:
    """Axis names and sizes, a device and a backend; see the module
    docstring for the collectives."""

    def __init__(self, names: Tuple[str, ...], sizes: Tuple[int, ...],
                 device: torch.device, backend: str):
        self.axis_names, self.axis_sizes = names, sizes
        self.device, self.backend = device, backend
        self.size = int(np.prod(sizes))
        self.shape = dict(zip(names, sizes))
        self._groups = {}
        if backend == "local":
            self.shards = tuple(range(self.size))
            return
        dist = _dist()
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError("a dist mesh needs an initialised "
                               "torch.distributed process group")
        world = dist.get_world_size()
        if world != self.size:
            raise ValueError(f"a dist mesh of {self.size} shards needs a "
                             f"world of {self.size} ranks, not {world}")
        rank = dist.get_rank()
        self.shards = (rank,)
        for a, n in zip(names, sizes):
            if n == world:
                self._groups[a] = None            # the default group
                continue
            # every rank makes every group of the axis, in the same order
            for s in range(self.size):
                members = self.members(s, a)
                if members[0] != s:
                    continue
                g = dist.new_group(list(members))
                if rank in members:
                    self._groups[a] = g

    def axis_index(self, s: int, axis: str) -> int:
        """Shard s's coordinate along ``axis`` (0 off the mesh)."""
        if axis not in self.shape:
            return 0
        return int(np.unravel_index(s, self.axis_sizes)[
            self.axis_names.index(axis)])

    def members(self, s: int, axis: str) -> Tuple[int, ...]:
        """The shards along ``axis`` through shard s, in axis order."""
        if axis not in self.shape:
            return (s,)
        k = self.axis_names.index(axis)
        c = list(np.unravel_index(s, self.axis_sizes))
        out = []
        for i in range(self.axis_sizes[k]):
            c[k] = i
            out.append(int(np.ravel_multi_index(c, self.axis_sizes)))
        return tuple(out)

    # ---------------------------------------------------------- collectives

    def _check(self, parts):
        if len(parts) != len(self.shards):
            raise ValueError(f"{len(parts)} parts for the {len(self.shards)} "
                             "shards this process holds")

    def all_gather(self, parts: Sequence[torch.Tensor], axis: str) -> list:
        self._check(parts)
        if axis not in self.shape:
            return list(parts)
        if self.backend == "dist":
            part = parts[0].contiguous()
            out = [torch.empty_like(part) for _ in range(self.shape[axis])]
            _dist().all_gather(out, part, group=self._groups[axis])
            return [torch.cat(out)]
        done = {}
        for s in self.shards:
            m = self.members(s, axis)
            if m not in done:
                done[m] = torch.cat([parts[i] for i in m])
        return [done[self.members(s, axis)] for s in self.shards]

    def psum(self, parts: Sequence[torch.Tensor], axis: str) -> list:
        self._check(parts)
        if axis not in self.shape:
            return list(parts)
        if self.backend == "dist":
            out = parts[0].clone()
            _dist().all_reduce(out, group=self._groups[axis])
            return [out]
        done = {}
        for s in self.shards:
            m = self.members(s, axis)
            if m not in done:
                acc = parts[m[0]]
                for i in m[1:]:
                    acc = acc + parts[i]
                done[m] = acc
        return [done[self.members(s, axis)] for s in self.shards]

    def ppermute(self, parts: Sequence[torch.Tensor],
                 pairs: Sequence[Tuple[int, int]], axis: str) -> list:
        self._check(parts)
        src_of = {int(d): int(s) for s, d in pairs}
        if len(src_of) != len(pairs) or \
                len({int(s) for s, _ in pairs}) != len(pairs):
            raise ValueError(f"pairs {list(pairs)} are not a partial "
                             "permutation")
        if axis not in self.shape:
            return list(parts)
        if self.backend == "dist":
            return [self._ppermute_dist(parts[0], pairs, src_of, axis)]
        out = []
        for k, s in enumerate(self.shards):
            src = src_of.get(self.axis_index(s, axis))
            m = self.members(s, axis)
            out.append(torch.zeros_like(parts[k]) if src is None
                       else parts[m[src]])
        return out

    def _ppermute_dist(self, part, pairs, src_of, axis):
        dist = _dist()
        s = self.shards[0]
        me, m = self.axis_index(s, axis), self.members(s, axis)
        dst_of = {int(a): int(b) for a, b in pairs}
        part = part.contiguous()
        out = torch.zeros_like(part)
        src, dst = src_of.get(me), dst_of.get(me)
        if src == me:                          # a pair onto itself
            out.copy_(part)
            src = dst = None
        ops = []
        if dst is not None:
            ops.append(dist.P2POp(dist.isend, part, m[dst],
                                  group=self._groups[axis]))
        if src is not None:
            ops.append(dist.P2POp(dist.irecv, out, m[src],
                                  group=self._groups[axis]))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out


def make_mesh(shape: Optional[Sequence[Tuple[str, int]]] = None, *,
              device=None, backend: str = "local") -> Mesh:
    """A mesh from (axis, size) pairs; by default a 1-D "row" mesh of
    ``device_count(backend)`` shards.

    ``device`` goes through ``harness/driver.py:device_of``: the card unless
    the caller asks for "cpu", and an error where no card is present.
    Under ``dist`` the default device of a card is ``cuda:<rank mod
    cards>``, NCCL's one rank a card."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
    if shape is None:
        shape = (("row", device_count(backend)),)
    names = tuple(str(n) for n, _ in shape)
    sizes = tuple(int(s) for _, s in shape)
    if len(set(names)) != len(names) or min(sizes, default=0) < 1:
        raise ValueError(f"mesh shape {tuple(shape)}: axis names must "
                         "differ and sizes be at least 1")
    dev = device_of("cuda" if device is None else device)
    if backend == "local" and int(np.prod(sizes)) > LOCAL_SHARDS:
        raise ValueError(f"mesh needs {int(np.prod(sizes))} shards, a local "
                         f"mesh has {LOCAL_SHARDS}")
    if backend == "dist" and dev.type == "cuda" and dev.index is None:
        dist = _dist()
        if dist.is_available() and dist.is_initialized():
            dev = torch.device("cuda", dist.get_rank()
                               % torch.cuda.device_count())
    return Mesh(names, sizes, dev, backend)
