"""SpGEMM, the sparse × sparse product of ``singlespmv_tpu/ops/spgemm.py``.

Both factors are the port's transposed ELL states (``formats/ell.py``: col
and val (K, n_row_pad)), and the product runs in plain torch, as the
reference runs it in XLA:

1. every A nonzero (i, k, a) meets the K_b slots of B's row k: a
   (K_b, K_a, n_row_pad) rectangle of candidate products
   (i, B.col[k, :], a · B.val[k, :]);
2. each candidate gets the key i·n_col_b + j, a product that is 0 (a pad
   of either factor, or an annihilated one) the ghost key past every real
   one;
3. the keys are sorted (``torch.sort``, stable), a head flag marks each
   key's first candidate, its running count ranks the keys, and a segment
   sum (``ops/segsum.py``) adds each key's candidates.

``spgemm_coo`` is the host-facing product: it groups B's rows by degree and
compacts each group's row spaces, so that one long row of B cannot blow the
rectangle up, and sums an entry that several groups reach on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import Config
from ..core.types import COOMatrix
from ..formats import ell as ell_format
from .segsum import segment_sum_sorted


def spgemm_arrays(a_state, b_state, n_col_b: int):
    """C = A·B from two ELL-T states on one device: (keys, vals, n_unique).

    keys (cap,) int64, the sorted row-major flat indices i·n_col_b + j of
    C's entries, the ghost key past them; vals (cap,) each key's sum;
    n_unique a device scalar, the count of real keys.  cap is the
    rectangle's size K_b · K_a · n_row_pad."""
    ka, nra = a_state.col.shape
    acol = a_state.col.long()
    bcol = b_state.col.long()[:, acol]             # (K_b, K_a, n_row_pad)
    prod = a_state.val[None] * b_state.val[:, acol]
    out_i = torch.arange(nra, device=prod.device).expand(prod.shape)
    key = out_i * n_col_b + bcol

    ghost = a_state.n_row * n_col_b + n_col_b      # > any real key
    key = torch.where(prod != 0, key, ghost).reshape(-1)
    key_sorted, order = torch.sort(key, stable=True)
    val_sorted = prod.reshape(-1)[order]
    heads = torch.ones_like(key_sorted, dtype=torch.bool)
    heads[1:] = key_sorted[1:] != key_sorted[:-1]
    seg = torch.cumsum(heads, 0) - 1               # each key's rank
    cap = key.numel()
    sums = segment_sum_sorted(val_sorted, seg, cap)
    # every candidate of a rank carries its key, so the scatter writes one
    # value a slot
    uniq_keys = torch.full_like(key_sorted, ghost).scatter_(0, seg,
                                                            key_sorted)
    n_unique = (uniq_keys != ghost).sum()
    return uniq_keys, sums, n_unique


DEG_GROUPS = (8, 32, 128, 512, 2048, 8192, 1 << 30)


def spgemm_coo(a: COOMatrix, b: COOMatrix, cfg: Config = None, *,
               device="cuda") -> COOMatrix:
    """Host-facing C = A·B as a COOMatrix (explicit zeros dropped), the
    products on ``device`` in ``cfg``'s value type (float64 by default).

    B's rows are bucketed by degree: a single dense row of B would make the
    rectangle nnz_A × max_deg.  Group g holds B's rows of degree ≤ K_g and
    only the A entries that point at them, so the rectangles hold about
    Σ_r coldeg_A(r)·deg_B(r) candidates.  Each group's B rows and A rows are
    renumbered densely: the ELL planes are (K, rows), so B's whole row space
    would give a dense-row group a K_g × n_row plane (a 20k-degree row in a
    100k B: a 15 GiB plane), and A's a rectangle of every row of A."""
    from ..harness.driver import device_of

    if a.n_col != b.n_row:
        raise ValueError("inner dimensions must agree")
    cfg = cfg or Config(dtype="float64")
    dev = device_of(device)
    bdeg = np.bincount(b.row.astype(np.int64), minlength=b.n_row)
    parts = []
    lo = 0
    for K in DEG_GROUPS:
        rows_g = (bdeg > lo) & (bdeg <= K)
        lo = K
        if not rows_g.any():
            continue
        bm = rows_g[b.row.astype(np.int64)]
        am = rows_g[a.col.astype(np.int64)]
        if not am.any():
            continue
        gsel = np.flatnonzero(rows_g)
        remap = np.zeros(b.n_row, np.int64)
        remap[gsel] = np.arange(len(gsel))
        arows = np.unique(a.row[am].astype(np.int64))
        armap = np.zeros(a.n_row, np.int64)
        armap[arows] = np.arange(len(arows))
        a_sub = COOMatrix(n_row=len(arows), n_col=len(gsel),
                          row=armap[a.row[am].astype(np.int64)],
                          col=remap[a.col[am].astype(np.int64)],
                          val=a.val[am])
        b_sub = COOMatrix(n_row=len(gsel), n_col=b.n_col,
                          row=remap[b.row[bm].astype(np.int64)],
                          col=b.col[bm], val=b.val[bm])
        a_state = ell_format.convert(a_sub, cfg).to(dev)
        b_state = ell_format.convert(b_sub, cfg).to(dev)
        keys, vals, n = spgemm_arrays(a_state, b_state, b.n_col)
        n = int(n)
        keys = keys[:n].cpu().numpy()
        vals = vals[:n].cpu().numpy()
        live = vals != 0
        keys, vals = keys[live], vals[live]
        # the group's A rows back to C's rows
        keys = arows[keys // b.n_col] * np.int64(b.n_col) + keys % b.n_col
        parts.append((keys, vals))
        del a_state, b_state
    if not parts:
        return COOMatrix.from_triplets(a.n_row, b.n_col, [], [], [],
                                       sort=True)
    keys = np.concatenate([p[0] for p in parts])
    vals = np.concatenate([p[1] for p in parts])
    # an entry (i, j) can take products from several degree groups: sum
    # them (spgemm_arrays merged those within a group)
    return COOMatrix.from_triplets(
        a.n_row, b.n_col, (keys // b.n_col).astype(np.int64),
        (keys % b.n_col).astype(np.int64), vals, sort=True,
        sum_duplicates=True)
