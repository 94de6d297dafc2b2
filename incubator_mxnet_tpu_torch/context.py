"""Device contexts: ``mx.gpu()`` / ``mx.cpu()`` and the default-context stack.

Counterpart of ``incubator_mxnet_tpu/context.py``. A Context is a named
view onto a ``torch.device``. The default context is ``gpu(0)``: with no
card, using it raises; it never falls back to the CPU. Callers that want
the CPU say so (``ctx=mx.cpu()`` or ``with mx.cpu():``).
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "current_context", "num_gpus"]

_TORCH_TYPE = {"cpu": "cpu", "gpu": "cuda"}


class _TLS(threading.local):
    def __init__(self):
        super().__init__()
        self.stack = []


_tls = _TLS()


class Context:
    """Device context; constructing one never touches hardware."""

    def __init__(self, device_type, device_id: int = 0):
        if isinstance(device_type, Context):
            device_type, device_id = device_type.device_typename, device_type.device_id
        if device_type not in _TORCH_TYPE:
            raise MXNetError(f"unknown device type {device_type!r} "
                             f"(the port knows {sorted(_TORCH_TYPE)})")
        self.device_typename = device_type
        self.device_id = int(device_id)

    @property
    def torch_device(self) -> torch.device:
        if self.device_typename == "cpu":
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise MXNetError(
                f"{self} needs a CUDA device and torch sees none; pass "
                "ctx=mx.cpu() (or use `with mx.cpu():`) to run on the CPU")
        if self.device_id >= torch.cuda.device_count():
            raise MXNetError(f"{self} out of range; "
                             f"{torch.cuda.device_count()} device(s) present")
        return torch.device("cuda", self.device_id)

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_typename == other.device_typename
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_typename, self.device_id))

    def __repr__(self):
        return f"{self.device_typename}({self.device_id})"

    __str__ = __repr__

    def __enter__(self):
        _tls.stack.append(self)
        return self

    def __exit__(self, *exc):
        _tls.stack.pop()

    @classmethod
    def from_torch(cls, device: torch.device) -> "Context":
        if device.type == "cuda":
            return cls("gpu", device.index or 0)
        return cls("cpu", 0)


def cpu(device_id: int = 0) -> Context:
    return Context("cpu", device_id)


def gpu(device_id: int = 0) -> Context:
    return Context("gpu", device_id)


def num_gpus() -> int:
    return torch.cuda.device_count()


def current_context() -> Context:
    """Innermost ``with ctx:`` scope, else ``gpu(0)``."""
    return _tls.stack[-1] if _tls.stack else gpu(0)
