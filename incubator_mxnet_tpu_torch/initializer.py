"""Weight initializers: Zero, One, Uniform (the default), Xavier.

Counterpart of ``incubator_mxnet_tpu/initializer.py``. Random draws come
from an explicit CPU ``torch.Generator`` (``generator=``, else the default
of ``ndarray.random``) and are then copied to the array's device, so a
seed gives the same weights on the CPU and on the card.
"""
from __future__ import annotations

import math

import torch

from .base import MXNetError
from .ndarray import random as _random

__all__ = ["Initializer", "InitDesc", "Zero", "One", "Uniform", "Xavier",
           "register", "create"]

_REG = {}


def register(cls, name=None):
    _REG[(name or cls.__name__).lower()] = cls
    return cls


class InitDesc(str):
    """Parameter name + attrs hint passed to initializers."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


class Initializer:
    """Base initializer; ``__call__(name, arr)`` fills ``arr`` in place,
    dispatching on the parameter-name suffix as MXNet does."""

    def __init__(self, generator=None, **kwargs):
        self._kwargs = kwargs
        self._generator = generator

    @property
    def generator(self) -> torch.Generator:
        return self._generator or _random.default_generator()

    def __call__(self, name, arr):
        if not isinstance(name, InitDesc):
            name = InitDesc(name)
        init = name.attrs.get("__init__", "")
        if init:
            create(init)._init_weight(name, arr)
        elif name.endswith("weight"):
            self._init_weight(name, arr)
        elif name.endswith("bias"):
            self._init_bias(name, arr)
        elif name.endswith("gamma"):
            self._init_gamma(name, arr)
        elif name.endswith("beta"):
            self._init_beta(name, arr)
        elif name.endswith("running_mean") or name.endswith("moving_mean"):
            self._init_zero(name, arr)
        elif name.endswith("running_var") or name.endswith("moving_var"):
            self._init_one(name, arr)
        else:
            self._init_default(name, arr)

    def _init_weight(self, name, arr):
        raise NotImplementedError

    def _init_bias(self, name, arr):
        arr[:] = 0.0

    def _init_gamma(self, name, arr):
        arr[:] = 1.0

    def _init_beta(self, name, arr):
        arr[:] = 0.0

    def _init_zero(self, name, arr):
        arr[:] = 0.0

    def _init_one(self, name, arr):
        arr[:] = 1.0

    def _init_default(self, name, arr):
        self._init_weight(name, arr)

    def _uniform(self, arr, low, high):
        draw = torch.empty(arr.shape, dtype=torch.float32)
        arr[:] = draw.uniform_(low, high, generator=self.generator)

    def _normal(self, arr, std):
        draw = torch.empty(arr.shape, dtype=torch.float32)
        arr[:] = draw.normal_(0.0, std, generator=self.generator)

    def __repr__(self):
        return f"{type(self).__name__}({self._kwargs})"


class Zero(Initializer):
    def _init_weight(self, name, arr):
        arr[:] = 0.0


class One(Initializer):
    def _init_weight(self, name, arr):
        arr[:] = 1.0


class Uniform(Initializer):
    def __init__(self, scale=0.07, generator=None):
        super().__init__(generator, scale=scale)
        self.scale = scale

    def _init_weight(self, name, arr):
        self._uniform(arr, -self.scale, self.scale)


class Xavier(Initializer):
    """Reference initializer.py Xavier(rnd_type, factor_type, magnitude)."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3,
                 generator=None):
        super().__init__(generator, rnd_type=rnd_type,
                         factor_type=factor_type, magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        shape = arr.shape
        if len(shape) < 2:
            raise MXNetError(f"Xavier requires ndim>=2, got {shape} for {name}")
        hw_scale = math.prod(shape[2:]) if len(shape) > 2 else 1.0
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}[self.factor_type]
        scale = math.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            self._uniform(arr, -scale, scale)
        else:
            self._normal(arr, scale)


for _cls in (Zero, One, Uniform, Xavier):
    register(_cls)
register(Zero, "zeros")
register(One, "ones")


def create(name, **kwargs):
    if isinstance(name, Initializer):
        return name
    try:
        cls = _REG[name.lower()]
    except KeyError:
        raise MXNetError(f"initializer {name!r} is not registered "
                         f"(known: {sorted(_REG)})") from None
    return cls(**kwargs)
