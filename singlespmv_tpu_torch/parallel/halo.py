"""Halo-exchange distributed SpMV over a 1-D row mesh: the reference's
``singlespmv_tpu/parallel/halo.py``.

x is split over "row" (shard o owns x[o·xs, (o+1)·xs)).  At convert each
shard's triplets split into a **local** ss stream (the columns it owns)
and a **halo** stream (the columns it needs from others, renumbered into
the received buffer), and the pairwise column needs become one of three
exchange plans, chosen by a volume-plus-latency cost model (``LAT_ELEMS``
elements a collective), exactly as the reference chooses:

- ``rounds``: ``ppermute`` rounds, greedy size-balanced matchings of the
  nonzero (dst, src) needs (``_schedule_rounds``); a shard sends to at most
  one peer a round and receives from at most one;
- ``boundary``: each shard publishes the columns any peer needs from it,
  in one ``all_gather`` of (R, B); when most nnz are remote (``merged``),
  the own columns ride that table too and the local stream is empty;
- ``none``: no shard needs another's columns.

Rows are contiguous where that is balanced (bands keep their locality),
else snake-dealt as ``DistSpMV``'s.  The step issues the exchange first,
then the local stream, then the halo stream, and adds their y; each
stream's run totals go into their rows through ``ops/segsum.py:
combine_runs`` (ROADMAP C.4).  On the card the exchange runs on a second
CUDA stream while the local stream's products, scan and combine run on the
first, which waits for the second only before the halo stream.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import Config
from ..core.dtypes import torch_dtype
from ..core.types import COOMatrix, cdiv
from .spmv import (ShardStreams, apply_streams, as_input, from_stacks,
                   partition_rows_balanced, same_shape, slots_of,
                   stack_streams)

# exchange-plan cost model: elements-equivalent fixed cost per collective
LAT_ELEMS = 4096
_EMPTY = np.zeros(0, dtype=np.int64)
MODES = ("auto", "rounds", "boundary", "none")


def _schedule_rounds(needs: dict, R: int):
    """Greedy size-balanced matchings over the nonzero (dst, src) pairs.

    Returns a list of rounds; each round is (pairs, h) with pairs a list of
    (dst, src) and h the round's uniform buffer length (its largest pair).
    Pairs are taken largest-first so similar sizes share a round; every
    shard appears at most once as dst and once as src per round (a partial
    permutation)."""
    todo = sorted(((int(needs[(s, o)].size), s, o)
                   for (s, o) in needs if needs[(s, o)].size > 0),
                  reverse=True)
    rounds = []
    while todo:
        used_dst, used_src = set(), set()
        taken, rest = [], []
        for sz, s, o in todo:
            if s not in used_dst and o not in used_src:
                taken.append((s, o))
                used_dst.add(s)
                used_src.add(o)
            else:
                rest.append((sz, s, o))
        h = max(needs[(s, o)].size for s, o in taken)
        rounds.append((taken, int(h)))
        todo = rest
    return rounds


_SIDE = {}        # device -> the exchange's stream


def _fork(device: torch.device):
    """On a card, the exchange's stream (one a device, so that its cached
    blocks are reused), made to wait for the current stream's work so far;
    elsewhere None (``torch.cuda.stream(None)`` does nothing)."""
    if device.type != "cuda":
        return None
    if device not in _SIDE:
        _SIDE[device] = torch.cuda.Stream(device)
    side = _SIDE[device]
    side.wait_stream(torch.cuda.current_stream(device))
    return side


def _join(side, made) -> None:
    """The current stream waits for ``side``'s work so far, and the
    tensors ``made`` there are marked as used on it; without ``side``,
    nothing."""
    if side is None:
        return
    main = torch.cuda.current_stream(side.device)
    main.wait_stream(side)
    for t in made:
        t.record_stream(main)


@dataclasses.dataclass
class HaloSpMV:
    """Halo-exchanged distributed SpMV over a 1-D row mesh.

    Build with ``HaloSpMV.convert(coo, cfg, mesh)``; apply with
    ``op(x)``."""

    mesh: object
    cfg: Config
    n_row: int
    n_col: int
    nnz: int
    R: int
    rows_per: int
    xs: int                   # x slice length per shard
    mode: str                 # "rounds" | "boundary" | "none"
    balanced: bool            # snake-dealt rows (y reassembled via perm)
    merged: bool              # own cols ride the boundary table too
    rounds: tuple             # rounds mode: ((dst, src) pairs, H_r) a round
    bnd_len: int              # boundary mode: B (uniform boundary length)
    local_nnz: int
    halo_nnz: int
    row_axis: str
    local: ShardStreams       # the held shards' local streams (n_col xs)
    halo: ShardStreams        # their halo streams (n_col: the halo total)
    send_idx: tuple           # a round's (L, H_r) int64 x positions to
    #                           send; boundary mode one (L, B) entry
    perm: np.ndarray          # (R, rows_per) global row ids (ghost n_row)
    inv: torch.Tensor         # (n_row,) int64: each row's slot in R·rows_per

    @staticmethod
    def convert(coo: COOMatrix, cfg: Config, mesh, *,
                row_axis: str = "row", mode: str = "auto") -> "HaloSpMV":
        if mode not in MODES:
            raise ValueError(f"mode {mode!r} is not one of {MODES}")
        R = mesh.shape.get(row_axis, 1)
        if R != mesh.size:
            raise ValueError(f"mesh {mesh.shape} is not a 1-D {row_axis!r} "
                             "mesh")
        rows = np.asarray(coo.row, np.int64)
        cols = np.asarray(coo.col, np.int64)
        vals = np.asarray(coo.val)

        # rows: contiguous where balanced, else snake-dealt
        rows_per = cdiv(max(coo.n_row, 1), R)
        xs = cdiv(max(coo.n_col, 1), R)
        cont_s = np.minimum(rows // rows_per, R - 1)
        counts = np.bincount(cont_s, minlength=R)
        balanced = counts.max(initial=0) > 1.25 * max(counts.mean(), 1.0)
        if balanced:
            perm = partition_rows_balanced(coo, R)
            rows_per = perm.shape[1]
            shard_of, local_of = slots_of(perm, coo.n_row)
            e_s, e_lr = shard_of[rows], local_of[rows]
        else:
            perm = (np.arange(R)[:, None] * rows_per
                    + np.arange(rows_per)[None, :]).astype(np.int64)
            perm[perm >= coo.n_row] = coo.n_row          # ghost slots
            e_s = cont_s
            e_lr = rows - e_s * rows_per
        e_owner = np.minimum(cols // xs, R - 1)

        # pairwise needs: unique cols shard s requires from owner o
        needs = {}
        for s in range(R):
            in_s = e_s == s
            for o in range(R):
                if o != s:
                    m = in_s & (e_owner == o)
                    needs[(s, o)] = np.unique(cols[m]) if m.any() else _EMPTY
        n_remote = int((e_owner != e_s).sum())
        merged = n_remote > coo.nnz - n_remote
        if merged:
            for s in range(R):
                m = (e_s == s) & (e_owner == s)
                needs[(s, s)] = np.unique(cols[m]) if m.any() else _EMPTY

        # exchange plans and the cost model's pick (merged needs the own
        # columns delivered, which only the boundary table does)
        pair_needs = {k: v for k, v in needs.items() if k[0] != k[1]}
        rounds = _schedule_rounds(pair_needs, R)
        vol_rounds = sum(h for _, h in rounds)
        cost_rounds = vol_rounds + LAT_ELEMS * len(rounds)
        boundary = {}
        for o in range(R):
            got = [needs[(s, o)] for s in range(R) if (s, o) in needs]
            boundary[o] = np.unique(np.concatenate(got)) \
                if any(g.size for g in got) else _EMPTY
        B = max((b.size for b in boundary.values()), default=0)
        cost_boundary = R * B + LAT_ELEMS
        if mode == "auto":
            if vol_rounds == 0 and not merged:
                mode = "none"
            elif merged:
                mode = "boundary"
            else:
                mode = "rounds" if cost_rounds <= cost_boundary else "boundary"
        if merged and mode != "boundary":
            merged = False
            needs = pair_needs

        send_idx, offsets = [], {}    # (s, o) -> halo base for shard s
        if mode == "rounds":
            off = 0
            for pairs, h in rounds:
                arr = np.zeros((R, h), dtype=np.int64)
                for s, o in pairs:
                    arr[o, : needs[(s, o)].size] = needs[(s, o)] - o * xs
                    offsets[(s, o)] = off
                send_idx.append(arr)
                off += h
            halo_total = max(off, 1)
        elif mode == "boundary":
            arr = np.zeros((R, max(B, 1)), dtype=np.int64)
            for o, b in boundary.items():
                arr[o, : b.size] = b - o * xs
            send_idx.append(arr)
            for s in range(R):
                for o in range(R):
                    if o != s or merged:
                        offsets[(s, o)] = o * max(B, 1)
            halo_total = max(R * max(B, 1), 1)
        else:
            halo_total = 1

        # split each shard's triplets into its local and halo streams
        local_subs, halo_subs = [], []
        ldt = coo.row.dtype
        for s in range(R):
            in_s = e_s == s
            loc = in_s & (e_owner == s) & (not merged)
            rem = in_s & ~loc
            lr_l = e_lr[loc]
            lc_l = (cols[loc] - s * xs).astype(ldt)
            o_l = np.lexsort((lc_l, lr_l))
            local_subs.append((lr_l[o_l].astype(ldt), lc_l[o_l],
                               vals[loc][o_l]))
            lr_h, own_h, cols_h = e_lr[rem], e_owner[rem], cols[rem]
            # halo coordinate: the plan's offset + the column's rank in the
            # (sorted) needs list of its owner
            hc = np.zeros(lr_h.size, dtype=np.int64)
            for o in range(R):
                if o == s and not merged:
                    continue
                mo = own_h == o
                if mo.any():
                    ref = boundary[o] if mode == "boundary" else needs[(s, o)]
                    hc[mo] = offsets[(s, o)] + np.searchsorted(ref, cols_h[mo])
            o_h = np.lexsort((hc, lr_h))
            halo_subs.append((lr_h[o_h].astype(ldt), hc[o_h].astype(ldt),
                              vals[rem][o_h]))
        local = same_shape([COOMatrix(n_row=rows_per, n_col=xs, row=r, col=c,
                                      val=v) for r, c, v in local_subs], cfg)
        halo = same_shape([COOMatrix(n_row=rows_per, n_col=halo_total, row=r,
                                     col=c, val=v)
                           for r, c, v in halo_subs], cfg)
        return HaloSpMV._make(
            mesh, cfg, coo.n_row, coo.n_col, coo.nnz, R, rows_per, xs, mode,
            bool(balanced), bool(merged),
            tuple((tuple(p), h) for p, h in rounds) if mode == "rounds"
            else (),
            max(B, 1) if mode == "boundary" else 0,
            int((e_owner == e_s).sum()), int((e_owner != e_s).sum()),
            row_axis, [local[s] for s in mesh.shards],
            [halo[s] for s in mesh.shards], send_idx, perm)

    @staticmethod
    def from_reference(arrays: dict, cfg: Config, mesh, *,
                       row_axis: str = "row") -> "HaloSpMV":
        """The port's operator from a reference ``HaloSpMV``'s fields as
        numpy arrays and scalars: ``local_state`` and ``halo_state`` (dicts
        of stacked ss fields, leading dim R), ``send_idx`` (a tuple of
        (R, ·) arrays), ``perm``, ``rounds`` and the scalars ``n_row``,
        ``n_col``, ``nnz``, ``rows_per``, ``xs``, ``mode``, ``balanced``,
        ``merged``, ``bnd_len``, ``local_nnz`` and ``halo_nnz``."""
        R = mesh.shape.get(row_axis, 1)
        rows_per, xs = int(arrays["rows_per"]), int(arrays["xs"])
        halo_state = arrays["halo_state"]
        halo_total = {"rounds": sum(h for _, h in arrays["rounds"]),
                      "boundary": R * int(arrays["bnd_len"])}.get(
            arrays["mode"], 1)
        return HaloSpMV._make(
            mesh, cfg, int(arrays["n_row"]), int(arrays["n_col"]),
            int(arrays["nnz"]), R, rows_per, xs, str(arrays["mode"]),
            bool(arrays["balanced"]), bool(arrays["merged"]),
            tuple((tuple(tuple(int(v) for v in p) for p in pairs), int(h))
                  for pairs, h in arrays["rounds"]),
            int(arrays["bnd_len"]), int(arrays["local_nnz"]),
            int(arrays["halo_nnz"]), row_axis,
            from_stacks(arrays["local_state"], mesh.shards, rows_per, xs,
                        cfg),
            from_stacks(halo_state, mesh.shards, rows_per, max(halo_total, 1),
                        cfg),
            [np.asarray(a, np.int64) for a in arrays["send_idx"]],
            np.asarray(arrays["perm"], np.int64).reshape(R, rows_per))

    @staticmethod
    def _make(mesh, cfg, n_row, n_col, nnz, R, rows_per, xs, mode, balanced,
              merged, rounds, bnd_len, local_nnz, halo_nnz, row_axis, local,
              halo, send_idx, perm) -> "HaloSpMV":
        inv = np.zeros(n_row, np.int64)
        slot = np.nonzero(perm.reshape(-1) < n_row)[0]
        inv[perm.reshape(-1)[slot]] = slot
        dev = mesh.device
        held = list(mesh.shards)
        return HaloSpMV(
            mesh=mesh, cfg=cfg, n_row=n_row, n_col=n_col, nnz=nnz, R=R,
            rows_per=rows_per, xs=xs, mode=mode, balanced=balanced,
            merged=merged, rounds=rounds, bnd_len=bnd_len,
            local_nnz=local_nnz, halo_nnz=halo_nnz, row_axis=row_axis,
            local=stack_streams(local, rows_per, cfg.variant).to(dev),
            halo=stack_streams(halo, rows_per, cfg.variant).to(dev),
            send_idx=tuple(torch.from_numpy(np.ascontiguousarray(a[held]))
                           .to(dev) for a in send_idx),
            perm=perm, inv=torch.from_numpy(inv).to(dev))

    def local_x(self, x: torch.Tensor) -> list:
        """Each held shard's own slice of x (n_col,), of ``xs`` entries."""
        xp = torch.zeros(self.xs * self.R, dtype=x.dtype, device=x.device)
        xp[: self.n_col] = x
        return [xp[o * self.xs:(o + 1) * self.xs] for o in (
            self.mesh.axis_index(s, self.row_axis) for s in self.mesh.shards)]

    def exchange(self, x_loc: list) -> list:
        """Each held shard's received halo buffer (the halo stream's x),
        from the shards' own slices ``x_loc``; empty in mode ``none``."""
        mesh, axis = self.mesh, self.row_axis
        recvs = []
        if self.mode == "rounds":
            for (pairs, _), sidx in zip(self.rounds, self.send_idx):
                sends = [xl.index_select(0, i) for xl, i in zip(x_loc, sidx)]
                recvs.append(mesh.ppermute(
                    sends, [(o, s) for s, o in pairs], axis))
        elif self.mode == "boundary":
            sends = [xl.index_select(0, i)
                     for xl, i in zip(x_loc, self.send_idx[0])]
            recvs.append(mesh.all_gather(sends, axis))
        return [torch.cat(r) if len(r) > 1 else r[0] for r in zip(*recvs)]

    def step(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x for x (n_col,) of the values' type on the mesh's
        device."""
        x_loc = self.local_x(x)
        # 1) the exchange first, on the card on a stream of its own
        side = _fork(x.device)
        with torch.cuda.stream(side):
            x_halo = self.exchange(x_loc)
        # 2) the local stream meanwhile (merged mode has none), 3) the halo
        #    stream once the exchange is in
        y = None if self.merged else apply_streams(self.local, x_loc)
        _join(side, x_halo)
        if x_halo:
            yh = apply_streams(self.halo, x_halo)
            y = yh if y is None else y + yh
        y_perm = self.mesh.all_gather(list(y), self.row_axis)[0]
        if self.balanced:
            y_perm = y_perm.index_select(0, self.inv)
        return y_perm[: self.n_row].to(x.dtype)

    def __call__(self, x) -> torch.Tensor:
        return self.step(as_input(x, torch_dtype(self.cfg.dtype),
                                  self.mesh.device))

    @property
    def exchange_elems(self) -> int:
        """Per-shard exchanged x elements per SpMV (vs n_col for
        all-gather)."""
        if self.mode == "boundary":
            return self.R * self.bnd_len
        return sum(h for _, h in self.rounds)

    @property
    def n_collectives(self) -> int:
        if self.mode == "boundary":
            return 1
        return len(self.rounds)
