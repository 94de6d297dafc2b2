"""Base vocabulary: the framework error type and dtype maps.

Counterpart of ``incubator_mxnet_tpu/base.py``. The port names dtypes the
way MXNet does ("float32", "bfloat16", ...) at its public surface and maps
them onto ``torch.dtype`` inside.
"""
from __future__ import annotations

import numpy as _np
import torch

__all__ = ["MXNetError", "MXTPUError", "DTYPE_NAMES", "dtype_torch",
           "dtype_name"]


class MXNetError(RuntimeError):
    """Framework error type (reference: python/mxnet/base.py:75 MXNetError)."""


MXTPUError = MXNetError

# MXNet dtype name -> torch dtype. bfloat16 is first-class, as in the JAX
# package; numpy has no bfloat16, so numpy conversions go through float32
# (values) or int16 (raw bits, see ndarray/utils.py).
DTYPE_NAMES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "uint8": torch.uint8,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "bool": torch.bool,
}
_TORCH_NAMES = {v: k for k, v in DTYPE_NAMES.items()}


def dtype_torch(dtype) -> torch.dtype:
    """Normalize a dtype spec (MXNet name, numpy dtype/type, torch dtype)
    to a ``torch.dtype``; None means float32 (MXNet's default)."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else _np.dtype(dtype).name
    if name not in DTYPE_NAMES:
        raise MXNetError(f"dtype {dtype!r} is not supported by the port "
                         f"(known: {sorted(DTYPE_NAMES)})")
    return DTYPE_NAMES[name]


def dtype_name(dtype) -> str:
    """Canonical MXNet name of a dtype."""
    return _TORCH_NAMES[dtype_torch(dtype)]
