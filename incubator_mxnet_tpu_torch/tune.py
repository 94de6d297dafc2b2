"""Hand-kernel dispatch: ``tuned_call(name, plain, *args, **kw)``.

Counterpart of ``incubator_mxnet_tpu/tune.py``, whose call sites in
``ops/nn_ops.py`` it keeps. The JAX package races every Pallas candidate
against the XLA composition and may demote a kernel that loses; that race
is NOT ported. Here the rule is fixed:

* tensors on the CPU run ``plain``, the kernel's pure-PyTorch twin;
* tensors on a CUDA device run the registered hand kernel, or raise.

Nothing picks the plain version on the card, so a run on the card either
went through the kernels or failed.
"""
from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["register_kernel", "tuned_call", "kernels"]

_kernels = {}   # name -> callable launching the hand kernel


def register_kernel(name, launcher):
    """Register (or replace) the hand kernel behind tuned name ``name``."""
    _kernels[name] = launcher
    return launcher


def kernels():
    """{tuned name: registered kernel wrapper}."""
    return dict(_kernels)


def _device(args):
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    raise MXNetError("tuned_call needs at least one tensor argument")


def tuned_call(name, plain, *args, **kwargs):
    if _device(args).type == "cpu":
        return plain(*args, **kwargs)
    kernel = _kernels.get(name)
    if kernel is None:
        raise MXNetError(f"no hand kernel is registered for {name!r}; the "
                         "port never runs the plain version on the card")
    return kernel(*args, **kwargs)
