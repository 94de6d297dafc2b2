"""Gluon Parameter / ParameterDict with deferred initialization.

Counterpart of ``incubator_mxnet_tpu/gluon/parameter.py``. A Parameter owns
one NDArray (one ``torch.Tensor``) on one device. Unless its grad_req is
'null', that array is an attached autograd variable (``attach_grad``): a
torch leaf that requires grad, with a gradient buffer that ``backward``
writes or adds into. ``set_data`` writes the value in place where it can,
so the leaf and its buffer survive.
"""
from __future__ import annotations

from collections import OrderedDict

import torch

from .. import autograd, initializer
from ..base import MXNetError, dtype_torch
from ..context import Context, current_context
from ..ndarray import NDArray
from ..ndarray import ndarray as _nd

__all__ = ["Parameter", "ParameterDict", "DeferredInitializationError"]


class DeferredInitializationError(MXNetError):
    """Parameter accessed before its shape was known."""


def _shape_known(shape):
    return shape is not None and all(int(s) > 0 for s in shape)


def _one_ctx(ctx):
    if isinstance(ctx, (list, tuple)):
        return ctx[0] if ctx else None
    return ctx


class Parameter:
    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True):
        self.name = name
        self._grad_req = grad_req if differentiable else "null"
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self._data = None
        self._deferred_init = None  # (init, ctx, default_init)

    def __repr__(self):
        return f"Parameter {self.name} (shape={self.shape}, dtype={self.dtype})"

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        self._grad_req = req
        if self._data is not None:
            self._attach()

    def _attach(self):
        """Give the data array the gradient buffer its grad_req asks for."""
        if self._grad_req == "null":
            autograd._mark(self._data, None, "null")
        else:
            self._data.attach_grad(self._grad_req)

    # -- init ---------------------------------------------------------------
    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        """Allocate + fill; with the shape unknown, stash a deferred init
        that runs at the first forward."""
        default_init = default_init or initializer.Uniform()
        if self._data is not None and not force_reinit:
            return
        if not _shape_known(self.shape):
            if not self.allow_deferred_init:
                raise DeferredInitializationError(
                    f"Parameter {self.name} has unknown shape {self.shape} "
                    f"and allow_deferred_init=False")
            self._deferred_init = (init, _one_ctx(ctx), default_init)
            return
        self._finish_init(init, _one_ctx(ctx), default_init)

    def _finish_init(self, init, ctx, default_init):
        arr = _nd.zeros(self.shape, ctx=ctx or current_context(),
                        dtype=self.dtype)
        filler = init or self.init or default_init
        if isinstance(filler, str):
            filler = initializer.create(filler)
        with autograd.pause():
            filler(initializer.InitDesc(self.name), arr)
        self._data = arr
        self._deferred_init = None
        self._attach()

    def _finish_deferred_init(self):
        if self._deferred_init is None:
            raise DeferredInitializationError(
                f"Parameter {self.name} was not initialized (call "
                f".initialize() or net.initialize())")
        if not _shape_known(self.shape):
            raise DeferredInitializationError(
                f"Parameter {self.name} shape still unknown: {self.shape}")
        init, ctx, default_init = self._deferred_init
        self._finish_init(init, ctx, default_init)

    def _infer_shape(self, partial_shape):
        """Fill unknown (0) dims from an inferred shape, then finish a
        pending deferred init."""
        if self.shape is None:
            self.shape = tuple(partial_shape)
        else:
            new = []
            for have, got in zip(self.shape, partial_shape):
                if have and int(have) > 0:
                    if int(got) > 0 and int(got) != int(have):
                        raise MXNetError(
                            f"{self.name}: inferred shape {partial_shape} "
                            f"incompatible with declared {self.shape}")
                    new.append(have)
                else:
                    new.append(got)
            self.shape = tuple(new)
        if self._deferred_init is not None and _shape_known(self.shape):
            self._finish_deferred_init()

    # -- access -------------------------------------------------------------
    def data(self, ctx=None):
        if self._data is None:
            if self._deferred_init is not None:
                raise DeferredInitializationError(
                    f"Parameter {self.name} deferred-initialized; run a "
                    f"forward pass (or set shape) first")
            raise MXNetError(f"Parameter {self.name} not initialized; call "
                             f".initialize()")
        return self._data

    def list_data(self):
        return [self.data()]

    def list_ctx(self):
        return [self.data().context] if self._data is not None else []

    def grad(self, ctx=None):
        d = self.data()
        if d._grad is None:
            raise MXNetError(f"Parameter {self.name} has grad_req='null'")
        return d._grad

    def list_grad(self):
        return [self.grad()]

    def zero_grad(self):
        if self._data is not None and self._data._grad is not None:
            self._data.zero_grad()

    def set_data(self, data, ctx: Context | None = None):
        """Set the value, cast to this parameter's dtype, in place when the
        shape matches. It stays on the parameter's device; a parameter
        without data takes ``ctx``, else its deferred-init context, else
        the current context."""
        src = data if isinstance(data, NDArray) else NDArray(data)
        if self._data is not None:
            device = self._data._data.device
        else:
            pending = self._deferred_init[1] if self._deferred_init else None
            device = (ctx or pending or current_context()).torch_device
            self.shape = src.shape
            self._deferred_init = None
        tensor = src._data.detach().to(device=device,
                                       dtype=dtype_torch(self.dtype))
        if self._data is not None and self._data.shape == tuple(tensor.shape):
            with torch.no_grad():
                self._data._data.copy_(tensor)
            return
        if self._data is None:
            self._data = NDArray(tensor)
        else:
            self._data._data = tensor
        self._attach()

    def cast(self, dtype):
        self.dtype = dtype
        if self._data is not None:
            with autograd.pause():
                self._data = self._data.astype(dtype)
            self._attach()


class ParameterDict:
    """Prefix-scoped name -> Parameter mapping."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = OrderedDict()
        self._shared = shared

    @property
    def prefix(self):
        return self._prefix

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def __iter__(self):
        return iter(self._params)

    def __getitem__(self, key):
        return self._params[key]

    def __contains__(self, key):
        return key in self._params

    def __len__(self):
        return len(self._params)

    def __repr__(self):
        body = "\n".join(f"  {v}" for v in self._params.values())
        return f"ParameterDict '{self._prefix}' (\n{body}\n)"

    def get(self, name, **kwargs):
        """Create-or-retrieve ``prefix + name``."""
        full = self._prefix + name
        if full in self._params:
            return self._params[full]
        if self._shared is not None and full in self._shared:
            self._params[full] = self._shared[full]
            return self._params[full]
        param = Parameter(full, **kwargs)
        self._params[full] = param
        return param

    def update(self, other):
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise MXNetError(f"duplicate parameter {k}")
            self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        init = init or initializer.Uniform()
        for p in self.values():
            p.initialize(None, ctx, init, force_reinit=force_reinit)

    def zero_grad(self):
        for p in self.values():
            p.zero_grad()

    def setattr(self, name, value):
        """Set an attribute (e.g. grad_req, lr_mult) on every parameter."""
        for p in self.values():
            setattr(p, name, value)
