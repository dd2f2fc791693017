"""Distributed SpMV over a mesh: the reference's
``singlespmv_tpu/parallel/spmv.py``.

A 2-D grid ("row" × "col") of shards: shard (i, j) holds a row block × a
column block of the matrix as an ss stream (``formats/ss.py:build_stream``)
of the same shape as every other shard's.  Rows are sorted by length and
snake-dealt to the row shards (``partition_rows_balanced``), so the shards
carry about equal nnz; y comes back through the inverse of that
permutation.  x is split over "col" (shard (i, j) holds column block j);
with ``gather_x`` on a 1-D row mesh it is split over "row" and
all-gathered.  The step: the gather of x, the products val · x[col], the
segmented scan of every held shard's (H, W) rows in one call
(``ops/segscan.py:segmented_scan_tiles`` for the "optimized" variant, the
plain Hillis–Steele loop for "simple"), the run totals added into their
rows by ``ops/segsum.py:combine_runs`` (the real runs only: the
reference's ``combine_partials`` adds every padding slot into one ghost
bin, ROADMAP C.4), the ``psum`` over "col", the gather of the row blocks
over "row" and one ``index_select`` through the permutation.

Under the local backend the held shards are all R·C; under ``dist`` one.
A row's sums add in the same order under both, so on the CPU their y agree
bit for bit, but where a ``psum`` adds more than two shards (the local
mesh adds them in axis order, ``all_reduce`` in its own).  The shards'
order of addition differs from the
single-device ss spmv's: hold y to the oracle, never bit for bit to
another engine (ROADMAP C.7).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..core.dtypes import acc_dtype, torch_dtype
from ..core.types import COOMatrix, cdiv, round_up
from ..formats import ss as ss_format
from ..formats.base import TensorState
from ..ops.segscan import segmented_scan_tiles
from ..ops.segsum import combine_runs, segmented_scan_inclusive

STREAM_FIELDS = ("col", "val", "heads", "end_pos", "rank_rows")


def partition_rows_balanced(coo: COOMatrix, n_shards: int) -> np.ndarray:
    """Assign rows to shards, balancing nnz; returns (n_shards, rows_per)
    global row ids, padded with the ghost id n_row.

    Rows sorted by descending nnz are snake-dealt across the shards (the
    reference's loop, vectorised): shard loads differ by at most one
    longest row, and every shard has the same row count."""
    rows_per = cdiv(max(coo.n_row, 1), n_shards)
    order = np.argsort(-coo.row_lengths(), kind="stable")
    cycle, pos = np.divmod(np.arange(order.size), n_shards)
    shard = np.where(cycle % 2 == 0, pos, n_shards - 1 - pos)
    perm = np.full((n_shards, rows_per), coo.n_row, dtype=np.int64)
    perm[shard, cycle] = order
    return perm


def slots_of(perm: np.ndarray, n_row: int):
    """(shard, local slot) of every global row of a partition, ghost slots
    left out; the ghost id n_row maps to (0, 0)."""
    shard_of = np.zeros(n_row + 1, dtype=np.int64)
    local_of = np.zeros(n_row + 1, dtype=np.int64)
    s, slot = np.nonzero(perm < n_row)
    shard_of[perm[s, slot]] = s
    local_of[perm[s, slot]] = slot
    return shard_of, local_of


@dataclasses.dataclass(frozen=True)
class ShardStreams(TensorState):
    """The ss streams of the shards a process holds, stacked: L shards of
    (H, W) stream rows each, their real runs' flat end slots into the
    (L, H, W) stack and their rows into the (L, n_out) stack of the
    shards' y."""
    n_out: int                # rows of a shard's y
    variant: str              # simple | optimized
    col: torch.Tensor         # (L, H, W) index type, shard-local columns
    val: torch.Tensor         # (L, H, W) values
    heads: torch.Tensor       # (L, H, W) uint8
    run_pos: torch.Tensor     # (P,) int64
    run_rows: torch.Tensor    # (P,) int64


def same_shape(coos, cfg: Config, every=None) -> list:
    """The ss streams of ``coos``, all of the largest H and R_max among
    the streams of ``every`` (by default ``coos``): the reference's two
    passes, one sizing the shapes and one building at them, where a stream
    already of the common shape is not built again."""
    every = coos if every is None else every
    first = {id(c): ss_format.build_stream(c, cfg) for c in every}
    h = max(st.h for st in first.values())
    r_max = max(st.r_max for st in first.values())
    out = []
    for c in coos:
        st = first[id(c)]
        if (st.h, st.r_max) != (h, r_max):
            st = ss_format.build_stream(c, cfg, min_h=h, min_r_max=r_max)
        out.append(st)
    return out


def stack_streams(states, n_out: int, variant: str) -> ShardStreams:
    """The ``ShardStreams`` of ss states of one shape (CPU tensors)."""
    h, w = states[0].h, states[0].w
    pos = [st.run_pos.long() + k * h * w for k, st in enumerate(states)]
    rows = [st.run_rows.long() + k * n_out for k, st in enumerate(states)]
    return ShardStreams(
        n_out=n_out, variant=variant,
        col=torch.stack([st.col for st in states]),
        val=torch.stack([st.val for st in states]),
        heads=torch.stack([st.heads for st in states]),
        run_pos=torch.cat(pos), run_rows=torch.cat(rows))


def stream_products(st: ShardStreams, xs) -> torch.Tensor:
    """(L·H, W): the products val · x[col] of every held shard's stream,
    its x one tensor of ``xs`` a shard."""
    n_sh, h, w = st.col.shape
    prod = torch.empty(n_sh, h, w, dtype=st.val.dtype, device=st.val.device)
    for k, x in enumerate(xs):
        torch.mul(st.val[k], x.index_select(0, st.col[k].view(-1)).view(h, w),
                  out=prod[k])
    return prod.view(n_sh * h, w)


def apply_streams(st: ShardStreams, xs) -> torch.Tensor:
    """(L, n_out) in the accumulator type: each held shard's y from its
    stream and its x, the scan of all L shards' rows in one call."""
    n_sh, _, w = st.col.shape
    prod, heads = stream_products(st, xs), st.heads.view(-1, w)
    if st.variant == "optimized":
        scanned = segmented_scan_tiles(prod, heads)
    else:
        scanned = segmented_scan_inclusive(prod.to(acc_dtype(prod.dtype)),
                                           heads)
    return combine_runs(scanned, st.run_pos, st.run_rows,
                        n_sh * st.n_out).view(n_sh, st.n_out)


def from_stacks(stacks: dict, shards, n_row: int, n_col: int, cfg: Config):
    """The port's ss states of ``shards`` from a reference operator's
    stacked stream fields (numpy, leading dim the shard), through
    ``formats/ss.py:state_from_reference``."""
    h, w = stacks["col"].shape[1:]
    out = []
    for s in shards:
        a = {f: np.asarray(stacks[f][s]) for f in STREAM_FIELDS}
        real = ss_format.stream_rows(a["heads"], a["rank_rows"]) < n_row
        out.append(ss_format.state_from_reference(dict(
            a, n_row=n_row, n_col=n_col, nnz=int(real.sum()), w=int(w),
            h=int(h), r_max=int(a["end_pos"].shape[1]), variant=cfg.variant,
            n_step=int(np.ceil(np.log2(w))), step_counts=(),
            sorted_combine=True)))
    return out


def as_input(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """x (numpy or a tensor) as a tensor of the values' type on the
    mesh's device."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device=device, dtype=dtype)


@dataclasses.dataclass
class DistSpMV:
    """Converted distributed SpMV operator.

    Build with ``DistSpMV.convert(coo, cfg, mesh)``; apply with ``op(x)``
    where x is (n_col,) on the host or a device; returns the whole y
    (n_row,) on the mesh's device, in every process."""

    mesh: object
    cfg: Config
    n_row: int
    n_col: int
    nnz: int
    R: int                   # row shards
    C: int                   # col shards
    rows_per: int
    cols_per: int
    gather_x: bool
    row_axis: str
    col_axis: Optional[str]
    streams: ShardStreams    # the held shards', on the mesh's device
    perm: np.ndarray         # (R, rows_per) global row a slot (ghost n_row)
    inv: torch.Tensor        # (n_row,) int64: each row's slot in R·rows_per

    @staticmethod
    def _grid(mesh, row_axis, col_axis, gather_x):
        R = mesh.shape.get(row_axis, 1)
        C = mesh.shape.get(col_axis, 1) if col_axis else 1
        if gather_x and C != 1:
            raise ValueError("gather_x requires a 1-D row mesh (C == 1)")
        if R * C != mesh.size:
            raise ValueError(f"mesh {mesh.shape} is not the {row_axis!r} × "
                             f"{col_axis!r} grid")
        return R, C

    @staticmethod
    def convert(coo: COOMatrix, cfg: Config, mesh, *,
                row_axis: str = "row", col_axis: Optional[str] = "col",
                gather_x: bool = False) -> "DistSpMV":
        R, C = DistSpMV._grid(mesh, row_axis, col_axis, gather_x)
        perm = partition_rows_balanced(coo, R)
        rows_per = perm.shape[1]
        cols_per = cdiv(max(coo.n_col, 1), C)
        shard_of, local_of = slots_of(perm, coo.n_row)

        ec = np.asarray(coo.col, np.int64)
        e_rs = shard_of[coo.row]
        e_cs = np.minimum(ec // cols_per, C - 1)
        e_lr = local_of[coo.row]
        e_lc = ec - e_cs * cols_per

        # triplets per (row shard, col shard), sorted by local row
        subs = {}
        for s in range(R):
            for c in range(C):
                m = (e_rs == s) & (e_cs == c)
                lr, lc, lv = e_lr[m], e_lc[m], np.asarray(coo.val)[m]
                o = np.lexsort((lc, lr))
                subs[(s, c)] = COOMatrix(
                    n_row=rows_per, n_col=cols_per,
                    row=lr[o].astype(coo.row.dtype),
                    col=lc[o].astype(coo.col.dtype), val=lv[o])
        grid = [(mesh.axis_index(s, row_axis),
                 mesh.axis_index(s, col_axis) if col_axis else 0)
                for s in mesh.shards]
        states = same_shape([subs[key] for key in grid], cfg,
                            [subs[key] for key in subs])
        return DistSpMV._make(mesh, cfg, coo.n_row, coo.n_col, coo.nnz, R, C,
                              rows_per, cols_per, gather_x, row_axis,
                              col_axis, states, perm)

    @staticmethod
    def from_reference(arrays: dict, cfg: Config, mesh, *,
                       row_axis: str = "row",
                       col_axis: Optional[str] = "col") -> "DistSpMV":
        """The port's operator from a reference ``DistSpMV``'s fields as
        numpy arrays and scalars: its stacked ``col``, ``val``, ``heads``,
        ``end_pos`` and ``rank_rows`` (leading dim R·C, row-major over the
        grid), ``perm`` (R·rows_per), and ``n_row``, ``n_col``, ``nnz``,
        ``rows_per``, ``cols_per`` and ``gather_x``."""
        R, C = DistSpMV._grid(mesh, row_axis, col_axis, arrays["gather_x"])
        rows_per, cols_per = int(arrays["rows_per"]), int(arrays["cols_per"])
        grid = [mesh.axis_index(s, row_axis) * C
                + (mesh.axis_index(s, col_axis) if col_axis else 0)
                for s in mesh.shards]
        states = from_stacks(arrays, grid, rows_per, cols_per, cfg)
        perm = np.asarray(arrays["perm"], np.int64).reshape(R, rows_per)
        return DistSpMV._make(mesh, cfg, int(arrays["n_row"]),
                              int(arrays["n_col"]), int(arrays["nnz"]), R, C,
                              rows_per, cols_per, bool(arrays["gather_x"]),
                              row_axis, col_axis, states, perm)

    @staticmethod
    def _make(mesh, cfg, n_row, n_col, nnz, R, C, rows_per, cols_per,
              gather_x, row_axis, col_axis, states, perm) -> "DistSpMV":
        inv = np.zeros(n_row, np.int64)
        slot = np.nonzero(perm.reshape(-1) < n_row)[0]
        inv[perm.reshape(-1)[slot]] = slot
        return DistSpMV(
            mesh=mesh, cfg=cfg, n_row=n_row, n_col=n_col, nnz=nnz, R=R, C=C,
            rows_per=rows_per, cols_per=cols_per, gather_x=gather_x,
            row_axis=row_axis, col_axis=col_axis,
            streams=stack_streams(states, rows_per, cfg.variant).to(
                mesh.device),
            perm=perm, inv=torch.from_numpy(inv).to(mesh.device))

    def shard_x(self, x: torch.Tensor) -> list:
        """Each held shard's x: its column block of x, or with
        ``gather_x`` the whole x all-gathered from the row shards'
        slices."""
        mesh = self.mesh
        if self.gather_x:
            n_pad = round_up(self.n_col, self.R)
            xp = x.new_zeros(n_pad)
            xp[: self.n_col] = x
            piece = n_pad // self.R
            return mesh.all_gather(
                [xp[i * piece:(i + 1) * piece] for i in (
                    mesh.axis_index(s, self.row_axis) for s in mesh.shards)],
                self.row_axis)
        xp = x.new_zeros(self.cols_per * self.C)
        xp[: self.n_col] = x
        cp = self.cols_per
        return [xp[j * cp:(j + 1) * cp] for j in (
            mesh.axis_index(s, self.col_axis) if self.col_axis else 0
            for s in mesh.shards)]

    def step(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x for x (n_col,) of the values' type on the mesh's
        device."""
        y_loc = list(apply_streams(self.streams, self.shard_x(x)))
        if self.C > 1:
            y_loc = self.mesh.psum(y_loc, self.col_axis)
        y_perm = self.mesh.all_gather(y_loc, self.row_axis)[0]
        return y_perm.index_select(0, self.inv).to(x.dtype)

    def __call__(self, x) -> torch.Tensor:
        return self.step(as_input(x, torch_dtype(self.cfg.dtype),
                                  self.mesh.device))

    def spmm(self, X) -> torch.Tensor:
        """Y = A @ X for a (n_col, B) panel: each column the spmv's y."""
        X = as_input(X, torch_dtype(self.cfg.dtype), self.mesh.device)
        return torch.stack([self.step(x) for x in X.t().contiguous()], 1)
