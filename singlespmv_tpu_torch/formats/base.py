"""Format plugin layer: the registry and op contract of
``singlespmv_tpu/formats/base.py``.

Every format is a module registered by name that exposes

    convert(coo: COOMatrix, cfg: Config) -> state     # host layout, CPU tensors
    spmv(state, x: torch.Tensor) -> torch.Tensor      # on the state's device
    spmm(state, X: torch.Tensor) -> torch.Tensor      # optional: Y = A @ X
    phases(state) -> dict[str, fn] | None             # optional: the split
                                                      # the driver profiles
    report_fields(state, cfg) -> dict                 # format-specific report keys
    traffic_bytes(state, cfg) -> int                  # roofline traffic model
    to_coo(state) -> COOMatrix                        # inverse conversion

``spmm_fn`` returns a format's ``spmm`` where it has one, else a loop of its
``spmv`` over the columns of X (``column_loop``), the port's stand-in for the
reference's ``jax.vmap``.  X is (n_col, B) and Y (n_row, B).

States are frozen dataclasses of torch tensors (``TensorState``); ``convert``
returns them on the CPU and ``state.to(device)`` moves them.  Values are
float32, float64 or bfloat16 (``check_dtype``); bfloat16 states hold
``torch.bfloat16`` tensors, and their spmv and spmm accumulate in float32
and round each y, and each column of Y, once (``core/dtypes.py``): a
format that adds parts (a peel, a nested or residual engine) adds them in
the accumulator type, through ``acc_spmv`` and ``acc_spmm``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..config import Config
from ..core.dtypes import value_size
from ..core import dtypes
from ..core.types import COOMatrix

_REGISTRY: Dict[str, Any] = {}
VALUE_DTYPES = dtypes.VALUE_TYPES


def check_dtype(fmt: str, dtype) -> None:
    """Refuses a value type the port has no kernels for; ``dtype`` is a
    config string or a torch dtype."""
    name = dtypes.name_of(dtype)
    if name not in VALUE_DTYPES:
        raise NotImplementedError(
            f"{fmt}: {', '.join(VALUE_DTYPES)} are ported to the GPU, "
            f"{name} is not")


def register_format(name: str, module) -> None:
    _REGISTRY[name] = module


def get_format(name: str):
    from . import _ensure_loaded

    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown format {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def available_formats():
    from . import _ensure_loaded

    _ensure_loaded()
    return sorted(_REGISTRY)


class TensorState:
    """Base of the frozen dataclass states: ``to(device)`` returns a copy
    whose tensor fields, nested states and tuples of either (ellg's
    passes) live on ``device``."""

    def to(self, device) -> "TensorState":
        def move(v):
            if isinstance(v, (torch.Tensor, TensorState)):
                return v.to(device)
            if isinstance(v, tuple) and v and all(
                    isinstance(a, (torch.Tensor, TensorState)) for a in v):
                return tuple(a.to(device) for a in v)
            return v

        return dataclasses.replace(self, **{
            f.name: move(getattr(self, f.name))
            for f in dataclasses.fields(self)})


def state_from_arrays(cls, arrays: dict, fmt: str, values: str = "val"):
    """A state of dataclass ``cls`` from the fields of the reference's state
    of format ``fmt``, given as numpy arrays and scalars: arrays become
    tensors (bool flags uint8, the reference's ``ml_dtypes`` bfloat16 as
    ``torch.bfloat16``), fields of the reference that ``cls`` lacks are not
    read, and fields of ``cls`` that the reference lacks keep their
    defaults.  Checks the value type of field ``values``."""
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in arrays:
            continue
        v = arrays[f.name]
        if isinstance(v, np.ndarray) and v.ndim:
            v = dtypes.from_numpy(np.array(
                v, dtype=np.uint8 if v.dtype == np.bool_ else v.dtype))
        kw[f.name] = v
    state = cls(**kw)
    check_dtype(fmt, getattr(state, values).dtype)
    return state


def convert(coo: COOMatrix, cfg: Config):
    return get_format(cfg.format).convert(coo, cfg)


def spmv_fn(cfg: Config) -> Callable:
    return get_format(cfg.format).spmv


def phases_fn(cfg: Config) -> Optional[Callable]:
    """The format's ``phases`` (name → fn(state, input), each phase's input
    the previous one's output), or None where it has none."""
    return getattr(get_format(cfg.format), "phases", None)


def acc_spmv(mod) -> Callable:
    """The spmv of format module ``mod`` in the accumulator type (float32
    for bfloat16 values), for a format that adds it to other parts before
    it rounds y once: the module's ``spmv_acc`` where it has one, else its
    ``spmv`` widened."""
    fn = getattr(mod, "spmv_acc", None)
    return fn if fn is not None else (
        lambda state, x: dtypes.acc(mod.spmv(state, x)))


def column_loop(spmv: Callable, state, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X by one ``spmv`` per column of X (n_col, B): (n_row, B) of
    the type ``spmv`` returns (``acc_spmv``'s: the accumulator type)."""
    return torch.stack([spmv(state, x) for x in X.t().contiguous()], dim=1)


def acc_spmm(mod) -> Callable:
    """The spmm of format module ``mod`` in the accumulator type (float32
    for bfloat16 values), for a format that adds it to other parts before
    it rounds Y once: the module's ``spmm_acc`` where it has one, else the
    column loop of ``acc_spmv``."""
    fn = getattr(mod, "spmm_acc", None)
    if fn is not None:
        return fn
    spmv = acc_spmv(mod)
    return lambda state, X: column_loop(spmv, state, X)


def module_spmm(mod) -> Callable:
    """The ``spmm`` of format module ``mod``, or ``acc_spmm``'s column loop
    rounded once to X's type."""
    native = getattr(mod, "spmm", None)
    if native is not None:
        return native
    spmm = acc_spmm(mod)
    return lambda state, X: spmm(state, X).to(X.dtype)


def spmm_fn(cfg: Config) -> Callable:
    """SpMM, Y = A @ X with X (n_col, B): the format's ``spmm`` where it has
    one, else the column loop of its ``spmv``
    (``singlespmv_tpu/formats/base.py:90``), at every value type; each
    column of Y is summed in the accumulator type and rounded once."""
    return module_spmm(get_format(cfg.format))


def to_coo(state, cfg: Config) -> COOMatrix:
    return get_format(cfg.format).to_coo(state)


def adds_per_row(state, cfg: Config) -> np.ndarray:
    """(n_row,) k_i of ``core/oracle.py:reorder_bound`` for a state of
    format ``cfg.format``: the totals whose order of addition into y_i is
    free on the card.  The format's own count where it has one (the run
    ends of slab's, xch's and bkt's routes, and hyb's and auto's through
    their engines), else nnz_i."""
    fn = getattr(get_format(cfg.format), "adds_per_row", None)
    if fn is not None:
        return fn(state)
    return to_coo(state, cfg).row_lengths()


def report_fields(state, cfg: Config) -> dict:
    fn = getattr(get_format(cfg.format), "report_fields", None)
    return fn(state, cfg) if fn else {}


def traffic_bytes(state, cfg: Config) -> int:
    fn = getattr(get_format(cfg.format), "traffic_bytes", None)
    if fn:
        return int(fn(state, cfg))
    # default CSR-style traffic model, as in the reference
    m, nnz = state.n_row, state.nnz
    isz = 4 if cfg.index_bits == 32 else 8
    vsz = value_size(cfg.dtype)
    return (m + 1 + nnz) * isz + (2 * nnz + m) * vsz
