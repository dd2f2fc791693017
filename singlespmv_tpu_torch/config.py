"""Runtime configuration.

The reference's flag registry is entirely compile-time ``-D`` defines
(singleSpMV's Makefile:10-21, defaults singleSpMV's src/param.h:1-21):
architecture (CPU|MIC|GPU), format (OPT_*), kernel variant (SIMPLE|OPTIMIZED),
SEGMENT_WIDTH / PADDING / N_BLOCK / ALIGNMENT / INDEX_32/64, and instrumentation
(VERIFY / PROFILING / MEASURE_STEP_TIME).  The same registry is a runtime
dataclass with identical parameter names: a copy of ``singlespmv_tpu/config.py``,
so one set of fields configures both packages.

bfloat16 needs no ``ml_dtypes`` here: ``np_dtype`` is the host type of the
values (float32 for bfloat16, whose values the host carries rounded; see
``core/dtypes.py``) and ``torch_dtype`` the device's; ``core.dtypes.
value_size`` gives the bytes of one value there.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .core import dtypes


@dataclasses.dataclass(frozen=True)
class Config:
    # --- format selection (reference: OPT_* defines, Makefile:12) ---
    format: str = "csr"             # coo|csr|ell|jds|dia|ss|css|csr5|dense|bcoo
    variant: str = "optimized"      # simple|optimized (reference: SIMPLE|OPTIMIZED)

    # --- layout / tuning parameters (reference: param.h) ---
    segment_width: int = 2048       # SS/CSS stream tile width, in elements (SEGMENT_WIDTH)
    n_block: int = 1                # CSS column blocking factor (N_BLOCK)
    padding: bool = True            # pad streams/rows to hardware tiles (PADDING)
    index_bits: int = 32            # INDEX_32 / INDEX_64
    omega: int = 128                # CSR5 tile lanes (ω); TPU lane count
    sigma: int = 16                 # CSR5 tile depth (σ); 0 = auto-tune from nnz/row
    row_block: int = 8              # CSR row-block height (rows per tile)
    lane_width: int = 128           # hardware lane width (TPU: 128)
    bkt_cap_pct: float = 90.0       # bkt bucket-depth cap percentile (spill→ghosts)
    bkt_group_cols: int = 0         # bkt col-blocks packed per group (0 = auto)
    bkt_balance: bool = True        # bkt lane-preserving row balance permutation
    bkt_row_group: int = 128        # bkt rows per bucket (128 | 1024 grouped mode)

    auto_exclude: tuple = ()        # auto planner: formats to skip (driver
    #                                 retry path after a device OOM/crash)
    spmm_b: int = 0                 # auto planner: plan for SpMM with a
    #                                 B-column panel (0 = plan for SpMV).
    #                                 A dense panel amortizes the sparse
    #                                 index streams, flipping block-structured
    #                                 matrices to the MXU formats (bsr/dense).

    # --- numerics ---
    dtype: str = "float32"          # value dtype on device: float32|float64|bfloat16

    # --- instrumentation (reference: VERIFY / PROFILING / MEASURE_STEP_TIME) ---
    verify: bool = True
    profiling: bool = False
    measure_step_time: bool = False

    # --- harness (reference: main.cpp:58-102) ---
    calibrate_seconds: float = 1.0  # double loop count until a trial takes this long
    n_trials: int = 10              # best-of-N timing
    max_loop: int = 1 << 20

    # --- parallel ---
    mesh_shape: Optional[tuple] = None  # e.g. (("row", 4), ("col", 2)); None = single chip

    @property
    def np_dtype(self):
        return dtypes.host_dtype(self.dtype)

    @property
    def torch_dtype(self):
        return dtypes.torch_dtype(self.dtype)

    @property
    def index_dtype(self):
        return np.int32 if self.index_bits == 32 else np.int64

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


DEFAULT = Config()
