"""NDArray: the framework's tensor type, backed by ``torch.Tensor``.

Counterpart of ``incubator_mxnet_tpu/ndarray/ndarray.py``. A torch tensor
is already an asynchronous, device-resident buffer, so the NDArray is a
thin holder: arithmetic goes through the op registry (``nd.*``), and
MXNet's mutation model (``a[:] = x``) writes the tensor in place.

Autograd: ``attach_grad`` makes the tensor a torch leaf with a gradient
buffer (``autograd.py``); writes in place run under torch's grad mode only
while recording, so a recorded array keeps its history and a leaf that
requires grad can still be set outside ``record()``.
"""
from __future__ import annotations

import numpy as _np
import torch

from .. import autograd
from ..base import MXNetError, dtype_name, dtype_torch
from ..context import Context, current_context

__all__ = ["NDArray", "array", "zeros"]


def _to_tensor(data, dtype=None):
    """Host data -> CPU tensor; python lists/scalars default to float32."""
    if isinstance(data, _np.ndarray) and data.dtype.name == "bfloat16":
        # ml_dtypes bfloat16 (the JAX package's numpy dtype): same bits
        bits = torch.from_numpy(data.view(_np.int16).copy())
        t = bits.view(torch.bfloat16)
    elif isinstance(data, (_np.ndarray, _np.generic)):
        t = torch.from_numpy(_np.array(data, copy=True))
    else:
        t = torch.as_tensor(data)
    return t if dtype is None else t.to(dtype_torch(dtype))


class NDArray:
    """n-dimensional array on a device (cpu/gpu)."""

    __slots__ = ("_data", "_grad", "_grad_req", "__weakref__")

    def __init__(self, data, ctx: Context | None = None, dtype=None):
        if isinstance(data, NDArray):
            data = data._data
        if not isinstance(data, torch.Tensor):
            data = _to_tensor(data, dtype)
        elif dtype is not None:
            data = data.to(dtype_torch(dtype))
        if ctx is not None:
            data = data.to(ctx.torch_device)
        self._data = data
        self._grad = None
        self._grad_req = "null"

    # ---- basic properties -------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return dtype_name(self._data.dtype)

    @property
    def size(self):
        return self._data.numel()

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def context(self) -> Context:
        return Context.from_torch(self._data.device)

    ctx = context

    @property
    def grad(self):
        """The gradient buffer (None until attach_grad)."""
        return self._grad

    # ---- autograd ---------------------------------------------------------
    def attach_grad(self, grad_req="write", stype=None):
        """Make this array a recorded variable with a zero gradient buffer
        (reference ndarray.py attach_grad); dense storage only."""
        if stype not in (None, "default"):
            raise MXNetError(f"grad stype {stype!r} is not ported")
        autograd._mark(self, NDArray(torch.zeros_like(self._data)), grad_req)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        autograd.backward([self], None if out_grad is None else [out_grad],
                          retain_graph=retain_graph, train_mode=train_mode)

    def detach(self):
        return NDArray(self._data.detach())

    def zero_grad(self):
        if self._grad is not None:
            self._grad._data = torch.zeros_like(self._grad._data)

    def _write_grad_mode(self):
        """Grad mode for an in-place write into this array: recorded under
        record() unless the array is a leaf that requires grad, whose
        value is set, not computed."""
        t = self._data
        return torch.set_grad_enabled(autograd.is_recording() and not (
            t.requires_grad and t.is_leaf))

    # ---- host transfer ----------------------------------------------------
    def asnumpy(self) -> _np.ndarray:
        """Blocking copy to host. bfloat16 values come back as float32
        (numpy has no bfloat16; the conversion is exact)."""
        t = self._data.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    def astorch(self) -> torch.Tensor:
        """The underlying tensor (no copy)."""
        return self._data

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a

    # ---- shape / dtype / device movement ---------------------------------
    def astype(self, dtype, copy=True):
        from ..ops.registry import invoke
        return invoke("cast", self, dtype=dtype_name(dtype))

    def reshape(self, *shape, **kwargs):
        from ..ops.registry import invoke
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return invoke("reshape", self, shape=shape)

    def flatten(self):
        from ..ops.registry import invoke
        return invoke("flatten", self)

    def as_in_context(self, ctx: Context):
        """Copy only when crossing devices."""
        if ctx == self.context:
            return self
        return self.copyto(ctx)

    as_in_ctx = as_in_context

    def copyto(self, other):
        if isinstance(other, Context):
            return NDArray(self._data.to(other.torch_device, copy=True))
        if isinstance(other, NDArray):
            with other._write_grad_mode():
                other._data.copy_(self._data)
            return other
        raise MXNetError(f"copyto: unsupported target {type(other)}")

    # ---- indexing ---------------------------------------------------------
    def __getitem__(self, key):
        if isinstance(key, NDArray):
            key = key._data
        with torch.set_grad_enabled(autograd.is_recording()):
            return NDArray(self._data[key])

    def __setitem__(self, key, value):
        if isinstance(key, NDArray):
            key = key._data
        if isinstance(value, NDArray):
            value = value._data
        if isinstance(value, torch.Tensor):
            value = value.to(device=self._data.device, dtype=self._data.dtype)
        elif not isinstance(value, (int, float, bool)):
            value = _to_tensor(value).to(device=self._data.device,
                                         dtype=self._data.dtype)
        with self._write_grad_mode():
            self._data[key] = value

    def __hash__(self):
        return id(self)

    def __repr__(self):
        return (f"\n{self.asnumpy()}\n<NDArray "
                f"{'x'.join(map(str, self.shape))} @{self.context}>")

    # ---- arithmetic (registry ops, as in the JAX package) -----------------
    def _binop(self, name, other, reverse=False):
        from ..ops.registry import invoke
        if isinstance(other, NDArray):
            a, b = (other, self) if reverse else (self, other)
            return invoke("broadcast_" + name, a, b)
        return invoke(f"_{'r' if reverse else ''}{name}_scalar", self,
                      scalar=float(other))

    def __add__(self, other):
        return self._binop("add", other)

    def __radd__(self, other):
        return self._binop("add", other, reverse=True)

    def __sub__(self, other):
        return self._binop("sub", other)

    def __rsub__(self, other):
        return self._binop("sub", other, reverse=True)

    def __mul__(self, other):
        return self._binop("mul", other)

    def __rmul__(self, other):
        return self._binop("mul", other, reverse=True)

    def __truediv__(self, other):
        return self._binop("div", other)

    def __rtruediv__(self, other):
        return self._binop("div", other, reverse=True)

    def __neg__(self):
        from ..ops.registry import invoke
        return invoke("negative", self)


# ---- factory functions ----------------------------------------------------

def array(obj, ctx=None, dtype=None):
    """NDArray from any array-like on ``ctx`` (default: the current
    context). MXNet semantics: python lists/scalars become float32; numpy
    arrays keep their dtype."""
    if dtype is None and isinstance(obj, (list, tuple, int, float)):
        dtype = "float32"
    return NDArray(obj, ctx=ctx or current_context(), dtype=dtype)


def zeros(shape, ctx=None, dtype=None):
    dev = (ctx or current_context()).torch_device
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return NDArray(torch.zeros(shape, dtype=dtype_torch(dtype), device=dev))
