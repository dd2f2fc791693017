"""Segment-reduction engines of ``singlespmv_tpu/ops/segsum.py``, in plain
torch.

The reference leaves these to XLA, so the port computes them with torch ops:

- ``segment_sum_sorted``: an ``index_add_`` of products into their rows;
- ``segmented_scan_inclusive``: the segmented inclusive sum-scan along the
  last axis, as log₂(W) shifted adds (Hillis–Steele), the loop of the
  reference's Pallas scan (``ops/pallas/segscan.py:36-42``).  It is the
  "simple" engine of ss, css and csr5 and the plain version of the
  ``segmented_scan_tiles`` and ``block_gather_scan`` kernels;
- ``extract_run_partials``: each run's inclusive total at its end lane, a
  ``torch.gather`` along the last axis;
- ``combine_partials``: an ``index_add_`` of the run totals into
  ``n_row + 1`` bins, the ghost bin ``n_row`` dropped.  The row ids are not
  sorted: ghost ids interleave with the real ones;
- ``combine_runs``: the two above over the real runs only, by a flat index
  of their end slots built once at convert.  The formats use it: on the
  card every ghost slot of ``combine_partials`` is an atomic add into the
  one ghost bin, and millions of them serialise there.

None of these adds across a row's boundary, so a row's error is that of its
own sum, as in the reference.
"""
from __future__ import annotations

import torch


def segment_sum_sorted(products: torch.Tensor, rows: torch.Tensor,
                       n_row: int) -> torch.Tensor:
    """y[r] = Σ products[i where rows[i] == r]."""
    y = torch.zeros(n_row, dtype=products.dtype, device=products.device)
    y.index_add_(0, rows.reshape(-1), products.reshape(-1))
    return y


def segmented_scan_inclusive(values: torch.Tensor,
                             heads: torch.Tensor) -> torch.Tensor:
    """Inclusive segmented sum-scan along the last axis; ``heads`` (bool or
    0/1 integers) is set at the first element of each run.  Every leading
    index scans on its own."""
    v = values
    f = heads != 0
    w = v.shape[-1]
    d = 1
    while d < w:
        vz = torch.cat([torch.zeros_like(v[..., :d]), v[..., :-d]], dim=-1)
        fz = torch.cat([torch.ones_like(f[..., :d]), f[..., :-d]], dim=-1)
        v = torch.where(f, v, v + vz)
        f = f | fz
        d *= 2
    return v


def extract_run_partials(scanned: torch.Tensor,
                         end_pos: torch.Tensor) -> torch.Tensor:
    """scanned[h, end_pos[h, r]]: each run's total at its last lane."""
    return torch.gather(scanned, -1, end_pos.long())


def combine_partials(partials: torch.Tensor, partial_rows: torch.Tensor,
                     n_row: int) -> torch.Tensor:
    """Adds the run totals into their rows; ``n_row`` is the ghost id of
    padded slots, whose bin is dropped."""
    y = torch.zeros(n_row + 1, dtype=partials.dtype, device=partials.device)
    y.index_add_(0, partial_rows.reshape(-1), partials.reshape(-1))
    return y[:n_row]


def combine_runs(scanned: torch.Tensor, run_pos: torch.Tensor,
                 run_rows: torch.Tensor, n_row: int) -> torch.Tensor:
    """y[run_rows[i]] += scanned.flat[run_pos[i]]: each real run's total at
    its end slot, added into its row."""
    y = torch.zeros(n_row, dtype=scanned.dtype, device=scanned.device)
    y.index_add_(0, run_rows, scanned.reshape(-1).index_select(0, run_pos))
    return y
