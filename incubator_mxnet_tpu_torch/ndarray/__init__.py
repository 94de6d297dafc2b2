"""``mx.nd`` namespace: NDArray + every registered operator as a function.

Counterpart of ``incubator_mxnet_tpu/ndarray/__init__.py``: ops resolve
lazily through module ``__getattr__`` (``mx.nd.FullyConnected(...)``).
"""
from __future__ import annotations

from .ndarray import NDArray, array, zeros
from .utils import load, load_frombuffer, save, save_bytes
from . import random

# trigger op registration
from ..ops import registry as _registry
from ..ops import tensor_ops as _tensor_ops  # noqa: F401
from ..ops import nn_ops as _nn_ops  # noqa: F401
from ..ops import optimizer_ops as _optimizer_ops  # noqa: F401


def _make_wrapper(opdef):
    def wrapper(*args, **kwargs):
        return _registry.apply_op(opdef, *args, **kwargs)

    wrapper.__name__ = opdef.name
    wrapper.__doc__ = opdef.fn.__doc__
    return wrapper


def __getattr__(name):
    if name in _registry.OPS:
        w = _make_wrapper(_registry.OPS.get(name))
        globals()[name] = w  # cache
        return w
    raise AttributeError(f"module 'nd' has no attribute {name!r}")


def __dir__():
    return sorted(set(list(globals()) + _registry.OPS.keys()))
