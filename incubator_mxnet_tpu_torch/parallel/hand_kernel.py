"""The wrapper around each hand CUDA kernel: twin on the CPU, kernel on
the card, a launch counter, and autograd.

``HandKernel(name, launch, plain)`` runs ``plain`` (the kernel's pure
PyTorch twin) for tensors on the CPU and ``launch`` for tensors on a CUDA
device, counting each launch in ``launches``; ``launch`` raises on
anything its kernel does not take. When a gradient is needed the call goes
through ``KernelFunction``, a ``torch.autograd.Function`` whose forward is
that same dispatch and whose backward is the autograd of the twin,
recomputed from the saved inputs, as the JAX package's custom_vjp
backward is the vjp of its XLA reference. So the CPU tests run the same
Function as the card, and a gradient never stops at a kernel.

Also here: the checks and error reporting the ctypes launchers share.
"""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from ..base import MXNetError

__all__ = ["HandKernel", "KernelFunction", "DTYPE_CODE", "check",
           "check_data", "raise_on"]

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
I32_MAX = 2 ** 31 - 1


def check(cond, what):
    if not cond:
        raise MXNetError(what)


def check_data(name, t, dtype=None):
    check(isinstance(t, torch.Tensor) and t.is_cuda,
          f"{name}: expected a CUDA tensor, got {getattr(t, 'device', t)}")
    check(t.dtype in DTYPE_CODE if dtype is None else t.dtype == dtype,
          f"{name}: dtype {t.dtype} not taken by the kernel")
    check(t.is_contiguous(), f"{name}: kernel takes contiguous tensors")
    check(t.numel() <= I32_MAX, f"{name}: more than 2^31-1 elements")


def raise_on(lib, err, what):
    """Raise if a launcher returned a CUDA error code."""
    if err:
        msg = lib.mx_cuda_error_string(err).decode()
        raise MXNetError(f"{what} launch failed: CUDA error {err} ({msg})")


def _needs_grad(args):
    return torch.is_grad_enabled() and any(
        isinstance(a, torch.Tensor) and a.requires_grad for a in args)


class HandKernel:
    """The wrapper of one hand kernel: twin on the CPU, kernel on the card.

    ``plain`` is the twin with the wrapper's own signature; ``launches``
    counts successful kernel launches and nothing else.
    """

    def __init__(self, name, launch, plain):
        self.name = name
        self._launch = launch
        self.plain = plain
        self.launches = 0

    def dispatch(self, *args, **kwargs):
        """The twin for CPU tensors, else one counted kernel launch."""
        if args[0].device.type == "cpu":
            return self.plain(*args, **kwargs)
        out = self._launch(*args, **kwargs)
        self.launches += 1
        return out

    def __call__(self, *args, **kwargs):
        if _needs_grad(args):
            return KernelFunction.apply(self, kwargs, *args)
        return self.dispatch(*args, **kwargs)

    def __repr__(self):
        return f"<HandKernel {self.name} launches={self.launches}>"


class KernelFunction(torch.autograd.Function):
    """Forward: ``kern.dispatch``. Backward: the vjp of ``kern.plain``
    recomputed from the saved inputs (not differentiable twice)."""

    @staticmethod
    def forward(ctx, kern, kwargs, *args):
        ctx.kern, ctx.kwargs = kern, kwargs
        ctx.save_for_backward(*args)
        return kern.dispatch(*args, **kwargs)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        need = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            leaves = [a.detach().requires_grad_(n)
                      for a, n in zip(ctx.saved_tensors, need)]
            out = ctx.kern.plain(*leaves, **ctx.kwargs)
            grads = iter(torch.autograd.grad(
                out, [x for x, n in zip(leaves, need) if n], grad_out))
        return (None, None) + tuple(next(grads) if n else None
                                    for n in need)
