"""Environment-variable registry: the subset of ``incubator_mxnet_tpu/util.py``
``ENV_VARS`` that the ported path reads, with the same knob names, defaults
and parsing rules. Every knob is read only through getenv_bool/getenv_str.
"""
from __future__ import annotations

import collections
import os

from .base import MXNetError

__all__ = ["ENV_VARS", "EnvSpec", "getenv_bool", "getenv_int", "getenv_str"]

EnvSpec = collections.namedtuple("EnvSpec", ["default", "kind", "doc"])

ENV_VARS = collections.OrderedDict([
    ("MXNET_OPTIMIZER_AGGREGATION_SIZE", EnvSpec(4, "int",
     "Max parameters fused into one multi-tensor optimizer dispatch by "
     "gluon.Trainer; <=1 restores per-tensor updates.")),
    ("MXTPU_CONV_BWD_KERNEL", EnvSpec("patch", "str",
     "Conv backward kernel formulation: 'patch' (default) or 'taps'. The "
     "two are TPU formulations of one function; the port has one CUDA "
     "kernel for it, so on the card this knob has no effect.")),
    ("MXTPU_FUSED_CONV_BWD", EnvSpec(False, "bool",
     "Route 3x3 stride-1 pad-1 convolutions through the conv3x3 autograd "
     "Function, whose backward is the hand fused dx+dW kernel on the card "
     "(its plain twin on the CPU). Off: PyTorch's own conv backward.")),
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


def getenv_int(name):
    """Declared-default int read; an unparseable value falls back to the
    default."""
    spec = _spec(name)
    raw = os.environ.get(name)
    if raw is None:
        return spec.default
    try:
        return int(raw)
    except ValueError:
        return spec.default


def getenv_str(name):
    """Declared-default string read of an ENV_VARS entry."""
    spec = _spec(name)
    raw = os.environ.get(name)
    return spec.default if raw is None else raw
