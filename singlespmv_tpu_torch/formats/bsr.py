"""BSR — block-sparse rows of dense (bm × bn) tiles, the layout of
``singlespmv_tpu/formats/bsr.py``.

Blocks are sorted by (block row, block col) and hold explicit zeros; the
reference's convert, guard and fill ratio are copied as they are.  Its
product is XLA (a gather of x blocks, a broadcast multiply with a lane sum,
a sorted segment sum), so the port's is plain torch: ``index_select`` of the
x blocks, one batched matrix-vector product (``torch.bmm``) and
``index_add_`` by block row.

SpMM, as the reference's (XLA ``dot_general``, no Pallas kernel), is plain
torch too.  Where convert built the reference's block-ELL layout (each
block row's K blocks side by side, under the reference's padding guard),
Y is one ``torch.bmm`` of (n_brow, bm, K·bn) @ (n_brow, K·bn, B); otherwise
the gathered X blocks, one ``torch.bmm`` per column chunk of at most
``MAX_GATHERED_ELEMS`` gathered elements, and ``index_add_`` by block row.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..core.dtypes import acc, to_host, value_size, value_tensor
from ..core.types import COOMatrix, cdiv
from .base import TensorState, check_dtype, state_from_arrays
from .slab import _t

MAX_GATHERED_ELEMS = 1 << 28    # cap on the gathered (n_blocks, bn, Bc) X


@dataclasses.dataclass(frozen=True)
class BSRState(TensorState):
    n_row: int
    n_col: int
    nnz: int
    bm: int
    bn: int
    n_blocks: int
    n_brow: int
    fill: float            # nnz / (n_blocks·bm·bn)
    blocks: torch.Tensor   # (n_blocks, bm, bn) dense values
    brow: torch.Tensor     # (n_blocks,) block-row id, sorted
    bcol: torch.Tensor     # (n_blocks,) block-col id
    ell_k: int = 0         # block-ELL SpMM panel width (0: not built)
    ell_blocks: Optional[torch.Tensor] = None   # (n_brow, bm, K·bn)
    ell_bcol: Optional[torch.Tensor] = None     # (n_brow, K) int32, pad → CB


def convert(coo: COOMatrix, cfg: Config) -> BSRState:
    """Build the blocks on the host; tensors come back on the CPU."""
    check_dtype("bsr", cfg.dtype)
    bm = max(8, cfg.row_block)
    bn = cfg.lane_width
    n_brow = cdiv(max(coo.n_row, 1), bm)
    key = (coo.row.astype(np.int64) // bm) * (2 ** 32) \
        + coo.col.astype(np.int64) // bn
    uniq, inv = np.unique(key, return_inverse=True)
    n_blocks = max(len(uniq), 1)
    # scattered inputs make one near-empty block per nonzero: refuse
    dense_elems = n_blocks * bm * bn
    if dense_elems > max(32 * coo.nnz, 1 << 22) or \
            dense_elems * value_size(cfg.dtype) > (2 << 30):
        raise ValueError(
            f"bsr: {n_blocks} blocks at fill {coo.nnz / dense_elems:.4f} — "
            "block storage would dwarf the matrix; use ellg/bkt/csr")
    blocks = np.zeros((n_blocks, bm, bn), dtype=cfg.np_dtype)
    if coo.nnz:
        lr = coo.row.astype(np.int64) % bm
        lc = coo.col.astype(np.int64) % bn
        np.add.at(blocks, (inv, lr, lc), coo.val.astype(cfg.np_dtype))
        brow = (uniq // (2 ** 32)).astype(cfg.index_dtype)
        bcol = (uniq % (2 ** 32)).astype(cfg.index_dtype)
    else:
        brow = np.zeros(1, dtype=cfg.index_dtype)
        bcol = np.zeros(1, dtype=cfg.index_dtype)
    fill = coo.nnz / float(n_blocks * bm * bn)
    # block-ELL SpMM layout: each block row's K blocks side by side along
    # the contraction, built where padding to the widest block row stays
    # within 3x the blocks (the reference's guard)
    ell_k, ell_blocks, ell_bcol = 0, None, None
    if coo.nnz:
        counts = np.bincount(brow.astype(np.int64), minlength=n_brow)
        k_max = int(counts.max())
        cb = cdiv(max(coo.n_col, 1), bn)
        if 0 < k_max * n_brow <= 3 * n_blocks and \
                k_max * n_brow * bm * bn * value_size(cfg.dtype) <= (2 << 30):
            ell_bcol = np.full((n_brow, k_max), cb, dtype=np.int32)
            eb = np.zeros((n_brow, k_max, bm, bn), dtype=blocks.dtype)
            pos = np.arange(n_blocks) - np.concatenate(
                [[0], np.cumsum(counts)[:-1]])[brow.astype(np.int64)]
            ell_bcol[brow.astype(np.int64), pos] = bcol.astype(np.int32)
            eb[brow.astype(np.int64), pos] = blocks
            ell_blocks = eb.transpose(0, 2, 1, 3).reshape(n_brow, bm,
                                                          k_max * bn)
            ell_k = k_max
    return BSRState(
        n_row=coo.n_row, n_col=coo.n_col, nnz=coo.nnz, bm=bm, bn=bn,
        n_blocks=n_blocks, n_brow=n_brow, fill=fill,
        blocks=value_tensor(blocks, cfg.dtype),
        brow=_t(brow), bcol=_t(bcol), ell_k=ell_k,
        ell_blocks=value_tensor(ell_blocks, cfg.dtype) if ell_k else None,
        ell_bcol=_t(ell_bcol) if ell_k else None)


def state_from_reference(arrays: dict) -> BSRState:
    """The port's state from the fields of a reference ``BSRState``, given
    as numpy arrays and scalars; the block-ELL fields come across too."""
    return state_from_arrays(BSRState, arrays, "bsr", values="blocks")


def spmv(state: BSRState, x: torch.Tensor) -> torch.Tensor:
    return spmv_acc(state, x).to(x.dtype)


def spmv_acc(state: BSRState, x: torch.Tensor) -> torch.Tensor:
    """y in the accumulator type (float32 for bfloat16 values)."""
    n_col_pad = cdiv(state.n_col, state.bn) * state.bn
    xp = torch.zeros(n_col_pad, dtype=x.dtype, device=x.device)
    xp[: state.n_col] = x
    xb = xp.view(-1, state.bn).index_select(0, state.bcol)   # (n_blocks, bn)
    part = torch.bmm(acc(state.blocks), acc(xb).unsqueeze(2)).squeeze(2)
    yb = torch.zeros(state.n_brow, state.bm, dtype=part.dtype,
                     device=x.device)
    yb.index_add_(0, state.brow, part)
    return yb.view(-1)[: state.n_row]


def spmm_acc(state: BSRState, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X, X (n_col, B) (the reference's ``formats/bsr.py:118``), in
    the accumulator type: blocks and X widened, as ``spmv_acc`` does."""
    b, bn = X.shape[1], state.bn
    cb = cdiv(state.n_col, bn)
    if state.ell_k:
        # one batched matmul; block col cb is the all-zero pad target
        Xp = torch.zeros((cb + 1) * bn, b, dtype=X.dtype, device=X.device)
        Xp[: state.n_col] = X
        Xg = Xp.view(cb + 1, bn, b).index_select(
            0, state.ell_bcol.view(-1)).view(state.n_brow, state.ell_k * bn,
                                             b)
        return torch.bmm(acc(state.ell_blocks), acc(Xg)).view(
            -1, b)[: state.n_row]
    chunk = max(8, min(b, MAX_GATHERED_ELEMS
                       // max(state.n_blocks * bn, 1)))

    def one_chunk(Xc):
        bc = Xc.shape[1]
        Xp = torch.zeros(cb * bn, bc, dtype=X.dtype, device=X.device)
        Xp[: state.n_col] = Xc
        Xb = Xp.view(cb, bn, bc).index_select(0, state.bcol)
        part = torch.bmm(acc(state.blocks), acc(Xb))
        Yb = torch.zeros(state.n_brow, state.bm, bc, dtype=part.dtype,
                         device=X.device)
        Yb.index_add_(0, state.brow, part)
        return Yb.view(-1, bc)[: state.n_row]

    if chunk >= b:
        return one_chunk(X)
    return torch.cat([one_chunk(X[:, i: i + chunk])
                      for i in range(0, b, chunk)], 1)


def spmm(state: BSRState, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X, X (n_col, B), rounded once to X's type."""
    return spmm_acc(state, X).to(X.dtype)


def report_fields(state: BSRState, cfg: Config) -> dict:
    return {"BlockM": state.bm, "BlockN": state.bn, "nBlocks": state.n_blocks,
            "BlockFill": round(state.fill, 6)}


def traffic_bytes(state: BSRState, cfg: Config) -> int:
    isz = 4 if cfg.index_bits == 32 else 8
    vsz = value_size(cfg.dtype)
    return (state.n_blocks * (state.bm * state.bn + state.bn) * vsz
            + state.n_blocks * 2 * isz + state.n_row * vsz)


def to_coo(state: BSRState) -> COOMatrix:
    """Inverse conversion (explicit zeros dropped)."""
    blocks = to_host(state.blocks)
    brow = state.brow.cpu().numpy().astype(np.int64)
    bcol = state.bcol.cpu().numpy().astype(np.int64)
    b, lr, lc = np.nonzero(blocks)
    rows = brow[b] * state.bm + lr
    cols = bcol[b] * state.bn + lc
    keep = (rows < state.n_row) & (cols < state.n_col)
    return COOMatrix.from_triplets(state.n_row, state.n_col, rows[keep],
                                   cols[keep], blocks[b, lr, lc][keep],
                                   sort=True)
