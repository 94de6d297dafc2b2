"""Environment-variable registry: the subset of ``incubator_mxnet_tpu/util.py``
``ENV_VARS`` that the ported path reads, with the same knob names, defaults
and parsing rules. Every knob is read only through getenv_bool/getenv_str.
"""
from __future__ import annotations

import collections
import os

from .base import MXNetError

__all__ = ["ENV_VARS", "EnvSpec", "getenv_bool", "getenv_str"]

EnvSpec = collections.namedtuple("EnvSpec", ["default", "kind", "doc"])

ENV_VARS = collections.OrderedDict([
    ("MXTPU_FUSED_BLOCK", EnvSpec(True, "bool",
     "Route gluon ResNet residual units through the fused "
     "conv+BN(+add)+ReLU ops (hand CUDA kernels on the card, their plain "
     "twins on the CPU). Off restores the layer-by-layer oracle path.")),
    ("MXTPU_FP32_MATMUL", EnvSpec("strict", "str",
     "fp32 matmul/conv precision: 'strict' (MXNet semantics, fp32 "
     "accumulate, TF32 off), 'fast' (TF32 allowed), or 'fastest' "
     "(bf16 matmul passes allowed).")),
])

_FALSY = frozenset(("", "0", "false", "off", "no"))


def _spec(name):
    try:
        return ENV_VARS[name]
    except KeyError:
        raise MXNetError(
            f"environment variable {name!r} is not declared in "
            f"util.ENV_VARS; add it there with a default and doc") from None


def getenv_bool(name):
    """Declared-default bool read; '', '0', 'false', 'off', 'no' (any
    case) are False, everything else set is True."""
    spec = _spec(name)
    raw = os.environ.get(name)
    if raw is None:
        return spec.default
    return raw.strip().lower() not in _FALSY


def getenv_str(name):
    """Declared-default string read of an ENV_VARS entry."""
    spec = _spec(name)
    raw = os.environ.get(name)
    return spec.default if raw is None else raw
