"""Gluon Block / HybridBlock on ``torch.nn.Module``.

Counterpart of ``incubator_mxnet_tpu/gluon/block.py``. A Block is an
``nn.Module``: child blocks are its submodules (``_children`` is the
module's ``_modules`` dict, so Gluon's structured names and torch's agree),
``__call__`` runs torch's forward hooks, whose signatures match Gluon's.
Gluon ``Parameter``s hold the tensors and are tracked in ``_reg_params``.

``hybridize()`` records the flag and runs eagerly; capturing the forward
into a CUDA graph comes later. ``export`` waits for the symbol layer.
"""
from __future__ import annotations

import re
import threading

import torch

from .. import nd
from ..base import MXNetError
from .parameter import DeferredInitializationError, Parameter, ParameterDict

__all__ = ["Block", "HybridBlock"]


class _NameCounter:
    _lock = threading.Lock()
    _counts: dict[str, int] = {}

    @classmethod
    def next(cls, alias):
        with cls._lock:
            i = cls._counts.get(alias, 0)
            cls._counts[alias] = i + 1
        return f"{alias}{i}_"


class Block(torch.nn.Module):
    """Base building block (reference gluon/block.py:131)."""

    def __init__(self, prefix=None, params=None):
        super().__init__()
        self._prefix = (prefix if prefix is not None
                        else _NameCounter.next(self._alias()))
        self._params = ParameterDict(self._prefix, shared=params)
        self._reg_params = {}

    def _alias(self):
        return type(self).__name__.lower()

    @property
    def _children(self):
        return self._modules

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._prefix[:-1] if self._prefix.endswith("_") else self._prefix

    @property
    def params(self):
        return self._params

    def __setattr__(self, name, value):
        if isinstance(value, Parameter):
            self.__dict__["_reg_params"][name] = value
        super().__setattr__(name, value)

    def register_child(self, block, name=None):
        self.add_module(name or str(len(self._modules)), block)

    def collect_params(self, select=None) -> ParameterDict:
        """All parameters of self + descendants."""
        ret = ParameterDict(self._params.prefix)
        if select is None:
            ret.update(self._params)
        else:
            pat = re.compile(select)
            ret.update({k: v for k, v in self._params.items()
                        if pat.match(k)})
        for child in self._children.values():
            ret.update(child.collect_params(select))
        return ret

    def _collect_params_with_prefix(self, prefix=""):
        if prefix:
            prefix += "."
        ret = {prefix + k: v for k, v in self._reg_params.items()}
        for name, child in self._children.items():
            ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        self.collect_params().initialize(init, ctx, verbose, force_reinit)

    def save_parameters(self, filename, deduplicate=False):
        """Structured-name save (reference gluon/block.py:319)."""
        params = self._collect_params_with_prefix()
        nd.save(filename, {k: p.data() for k, p in params.items()
                           if p._data is not None})

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current"):
        """Load a structured-name file (reference gluon/block.py:361)."""
        loaded = nd.load(filename)
        if not isinstance(loaded, dict):
            raise MXNetError("not a parameter dict file")
        self.load_dict(loaded, ctx, allow_missing, ignore_extra,
                       source=filename)

    def load_dict(self, loaded, ctx=None, allow_missing=False,
                  ignore_extra=False, source="dict"):
        """Set parameters from a {name: NDArray} dict. Parameters without
        data are created on ``ctx`` (default: their initialize() context,
        else the current context); others keep their device."""
        params = self._collect_params_with_prefix()
        for name, p in params.items():
            if name in loaded:
                p._infer_shape(loaded[name].shape)
                p.set_data(loaded[name], ctx=ctx)
            elif not allow_missing:
                raise MXNetError(f"parameter {name} missing in {source}")
        if not ignore_extra:
            extra = set(loaded) - set(params)
            if extra:
                raise MXNetError(f"extra params in {source}: {sorted(extra)}")

    def cast(self, dtype):
        for child in self._children.values():
            child.cast(dtype)
        for p in self._reg_params.values():
            p.cast(dtype)

    def hybridize(self, active=True, **kwargs):
        for child in self._children.values():
            child.hybridize(active, **kwargs)

    def forward(self, *args, **kwargs):
        raise NotImplementedError


class HybridBlock(Block):
    """Block with a ``hybrid_forward(F, x, **params)`` body."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False

    def hybridize(self, active=True, static_alloc=False, static_shape=False,
                  **kwargs):
        """Records the flag; the forward stays eager in this release."""
        self._active = active
        super().hybridize(active=active)

    def infer_shape(self, *args):
        """Hook for leaf layers to resolve deferred parameter shapes from
        the first input."""
        raise DeferredInitializationError(
            f"{type(self).__name__} has uninitialized parameters with unknown "
            f"shape; implement infer_shape() or give explicit shapes")

    def _eager_forward(self, *args):
        try:
            params = {k: p.data() for k, p in self._reg_params.items()}
        except DeferredInitializationError:
            self._finish_deferred(*args)
            params = {k: p.data() for k, p in self._reg_params.items()}
        return self.hybrid_forward(nd, *args, **params)

    def _finish_deferred(self, *args):
        self.infer_shape(*args)
        for p in self._reg_params.values():
            if p._deferred_init is not None:
                p._finish_deferred_init()

    def forward(self, *args):
        return self._eager_forward(*args)

    def hybrid_forward(self, F, *args, **kwargs):
        raise NotImplementedError
