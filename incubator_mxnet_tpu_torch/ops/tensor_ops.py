"""Tensor operators the ported paths use: elementwise arithmetic and
unary math, relu, cast, reshape, flatten, the reductions sum/mean, pick,
and softmax/log_softmax (which the JAX package registers in nn_ops).

Counterpart of the matching registrations in
``incubator_mxnet_tpu/ops/tensor_ops.py`` (same names and aliases).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import dtype_torch
from .registry import register


def _binop(name, fn, aliases=()):
    register(name=name, aliases=aliases)(lambda lhs, rhs, _f=fn: _f(lhs, rhs))


_binop("broadcast_add", torch.add, aliases=("elemwise_add", "_plus", "_add"))
_binop("broadcast_sub", torch.sub, aliases=("elemwise_sub", "_minus", "_sub"))
_binop("broadcast_mul", torch.mul, aliases=("elemwise_mul",))
_binop("broadcast_div", torch.div, aliases=("elemwise_div",))


def _scalar_ops():
    # the scalar takes the data's dtype first, as in the JAX package
    pairs = {"add": torch.add, "sub": torch.sub, "mul": torch.mul,
             "div": torch.div}
    for n, f in pairs.items():
        register(name=f"_{n}_scalar",
                 aliases=("_plus_scalar",) if n == "add" else ())(
            lambda data, *, scalar, _f=f: _f(
                data, torch.tensor(scalar, dtype=data.dtype,
                                   device=data.device)))
        register(name=f"_r{n}_scalar")(
            lambda data, *, scalar, _f=f: _f(
                torch.tensor(scalar, dtype=data.dtype, device=data.device),
                data))


_scalar_ops()


@register()
def negative(data):
    return torch.neg(data)


@register()
def relu(data):
    return torch.relu(data)


def _unary(name, fn):
    register(name=name)(lambda data, _f=fn: _f(data))


_unary("abs", torch.abs)
_unary("square", torch.square)
_unary("exp", torch.exp)
_unary("log", torch.log)


# ---- reductions ------------------------------------------------------------

def _reduce_axes(data, axis, exclude):
    """MXNet reduce-axis spec -> torch dims (None = every axis)."""
    if axis is None:
        return None
    axes = (int(axis),) if isinstance(axis, int) else tuple(int(a)
                                                             for a in axis)
    axes = tuple(a % data.dim() for a in axes)
    if exclude:
        axes = tuple(i for i in range(data.dim()) if i not in axes)
    return axes


def _reduce(name, fn, aliases=()):
    @register(name=name, aliases=aliases)
    def _op(data, *, axis=None, keepdims=False, exclude=False, _f=fn):
        dims = _reduce_axes(data, axis, exclude)
        if dims is None:
            out = _f(data)
            return out.reshape((1,) * data.dim()) if keepdims else out
        if not dims:                # torch reads dim=() as "every axis"
            return data
        return _f(data, dim=dims, keepdim=keepdims)


_reduce("sum", torch.sum, aliases=("sum_axis",))
_reduce("mean", torch.mean)


@register(name="pick")
def pick(data, index, *, axis=-1, keepdims=False, mode="clip"):
    """data[..., index, ...] along ``axis``; indices are clipped into
    range (the JAX package's only mode)."""
    ax = axis % data.dim()
    idx = torch.clamp(index.to(torch.int64), 0, data.shape[ax] - 1)
    out = torch.gather(data, ax, idx.unsqueeze(ax))
    return out if keepdims else out.squeeze(ax)


def _softmax_input(data, temperature):
    return data / temperature if temperature else data


@register(name="softmax")
def softmax(data, *, axis=-1, temperature=None, dtype=None):
    out = F.softmax(_softmax_input(data, temperature), dim=axis)
    return out.to(dtype_torch(dtype)) if dtype else out


@register(name="log_softmax")
def log_softmax(data, *, axis=-1, temperature=None, dtype=None):
    out = F.log_softmax(_softmax_input(data, temperature), dim=axis)
    return out.to(dtype_torch(dtype)) if dtype else out


@register(name="cast", aliases=("Cast",))
def cast(data, *, dtype):
    return data.to(dtype_torch(dtype))


@register(name="reshape", aliases=("Reshape",))
def reshape(data, *, shape):
    return torch.reshape(data, tuple(shape))


@register(name="flatten", aliases=("Flatten",))
def flatten(data):
    return torch.reshape(data, (data.shape[0], -1))
