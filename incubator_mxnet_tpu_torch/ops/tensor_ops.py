"""Tensor operators the ported path uses: elementwise arithmetic, relu,
cast, reshape and flatten.

Counterpart of the matching registrations in
``incubator_mxnet_tpu/ops/tensor_ops.py`` (same names and aliases).
"""
from __future__ import annotations

import torch

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


@register(name="cast", aliases=("Cast",))
def cast(data, *, dtype):
    return data.to(dtype_torch(dtype))


@register(name="reshape", aliases=("Reshape",))
def reshape(data, *, shape):
    return torch.reshape(data, tuple(shape))


@register(name="flatten", aliases=("Flatten",))
def flatten(data):
    return torch.reshape(data, (data.shape[0], -1))
