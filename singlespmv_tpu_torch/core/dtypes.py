"""Value types of the port, on the host and on the device, without
``ml_dtypes``.

A value type is named by the config's string: float32, float64 or bfloat16.
numpy has no bfloat16 of its own (the reference takes it from ``ml_dtypes``,
which the machine with the card does not have), so the host carries bfloat16
values as float32 arrays already rounded to bfloat16 (``host_dtype``,
``round_values``), and a state's tensors hold them as ``torch.bfloat16``
(``value_tensor``).  Rounding is round-to-nearest-even, float64 → float32 →
bfloat16, by torch on the CPU.

Arithmetic on bfloat16 values accumulates in float32 (``acc_dtype``,
``acc``): products and sums are taken in float32 and y is rounded once, at
the end, to the value type.
"""
from __future__ import annotations

import numpy as np
import torch

VALUE_TYPES = ("float32", "float64", "bfloat16")
_TORCH = {"float32": torch.float32, "float64": torch.float64,
          "bfloat16": torch.bfloat16}
_ITEMSIZE = {"float32": 4, "float64": 8, "bfloat16": 2}


def name_of(dtype) -> str:
    """The value type's name, from a config string, a torch dtype or a
    numpy dtype (the reference's ``ml_dtypes`` bfloat16 among them)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return getattr(dtype, "name", None) or getattr(
        dtype, "__name__", None) or str(dtype)


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype that holds values of type ``dtype`` on the device."""
    return _TORCH[name_of(dtype)]


def host_dtype(dtype) -> np.dtype:
    """The numpy dtype of host arrays of values: float32 for bfloat16."""
    name = name_of(dtype)
    return np.dtype(np.float32 if name == "bfloat16" else name)


def value_size(dtype) -> int:
    """Bytes of one value of type ``dtype`` on the device."""
    return _ITEMSIZE[name_of(dtype)]


def acc_dtype(dtype) -> torch.dtype:
    """The accumulator type of values of type ``dtype``: float32 for
    bfloat16, the type itself otherwise."""
    t = torch_dtype(dtype)
    return torch.float32 if t == torch.bfloat16 else t


def acc(t: torch.Tensor) -> torch.Tensor:
    """``t`` in its accumulator type (bfloat16 widened to float32)."""
    return t.float() if t.dtype == torch.bfloat16 else t


def round_values(a, dtype) -> np.ndarray:
    """Host values of type ``dtype``: ``a`` cast to ``host_dtype``, and at
    bfloat16 rounded to the nearest bfloat16 (ties to even)."""
    out = np.asarray(a, dtype=host_dtype(dtype))
    if name_of(dtype) == "bfloat16":
        out = torch.from_numpy(np.ascontiguousarray(out)).to(
            torch.bfloat16).float().numpy()
    return out


def value_tensor(a, dtype) -> torch.Tensor:
    """A CPU tensor of type ``dtype`` from host values ``a`` (rounded where
    they are not already)."""
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=host_dtype(dtype)))
    return t.to(torch_dtype(dtype))


def from_numpy(a: np.ndarray) -> torch.Tensor:
    """``torch.from_numpy`` that also takes the reference's ``ml_dtypes``
    bfloat16 arrays (found by name, without importing ml_dtypes): their bits
    are viewed as uint16, then as ``torch.bfloat16``."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def to_host(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as a numpy array on the host: bfloat16 comes back
    as float32 (exactly)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
