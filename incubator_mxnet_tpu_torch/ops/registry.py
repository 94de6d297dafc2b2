"""Operator registry + eager dispatch.

Counterpart of ``incubator_mxnet_tpu/ops/registry.py``. An op is one
function of torch tensors (positional) and python parameters (keyword).
PyTorch runs eagerly, so dispatch is a direct call: unwrap the NDArrays,
inject the training flag into train-aware ops, call, wrap the outputs.

Recording: each op runs with torch's grad mode on exactly while
``autograd.record()`` is active, so torch's graph is the tape. Ops
registered ``nondiff=True`` (the optimizer updates) always run under
``torch.no_grad()``.
"""
from __future__ import annotations

import torch

from .. import autograd
from ..base import MXNetError

__all__ = ["OpDef", "register", "get_op", "invoke", "apply_op", "OPS"]


class _Registry:
    """Name -> OpDef with aliases and a case-insensitive fallback."""

    def __init__(self):
        self._map = {}
        self._lower = {}

    def add(self, op, names):
        for n in names:
            self._map[n] = op
            self._lower.setdefault(n.lower(), op)

    def get(self, name):
        if name in self._map:
            return self._map[name]
        if name.lower() in self._lower:
            return self._lower[name.lower()]
        raise MXNetError(f"operator {name!r} is not registered in the port")

    def __contains__(self, name):
        return name in self._map or name.lower() in self._lower

    def keys(self):
        return sorted(self._map)


OPS = _Registry()


class OpDef:
    """One registered operator. ``train_aware`` ops (BatchNorm and the
    fused BN ops) get ``training=`` from the autograd train-mode flag when
    the caller did not pass it; ``nondiff`` ops are never recorded."""

    def __init__(self, name, fn, aliases=(), train_aware=False,
                 nondiff=False):
        self.name = name
        self.fn = fn
        self.aliases = aliases
        self.train_aware = train_aware
        self.nondiff = nondiff

    def __call__(self, *args, **kwargs):
        return apply_op(self, *args, **kwargs)

    def __repr__(self):
        return f"<Op {self.name}>"


def register(name=None, aliases=(), train_aware=False, nondiff=False):
    """Decorator: ``@register()`` on ``def op_name(x, y, *, param): ...``."""

    def _do(fn):
        opname = name or fn.__name__
        op = OpDef(opname, fn, aliases=aliases, train_aware=train_aware,
                   nondiff=nondiff)
        OPS.add(op, (opname,) + tuple(aliases))
        return op

    return _do


def get_op(name) -> OpDef:
    return OPS.get(name)


def apply_op(op: OpDef, *args, **params):
    """Eager invoke: unwrap NDArrays -> run the torch fn -> wrap outputs."""
    from ..ndarray import NDArray

    arrs = [a._data if isinstance(a, NDArray) else a for a in args]
    if op.train_aware and params.get("training") is None:
        params["training"] = autograd.is_training()
    with torch.set_grad_enabled(autograd.is_recording() and not op.nondiff):
        res = op.fn(*arrs, **params)
    multi = isinstance(res, (tuple, list))
    outs = [NDArray(r) for r in (res if multi else (res,))]
    return outs if multi else outs[0]


def invoke(name, *args, **kwargs):
    return apply_op(get_op(name), *args, **kwargs)
