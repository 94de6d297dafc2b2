"""Fused backward of a 3x3 stride-1 pad-1 convolution: the hand CUDA
kernel for Hopper (``csrc/conv_backward.cu``), its plain PyTorch twin, the
wrapper that launches it, and the ``conv3x3`` autograd Function that puts
it on the training path.

Counterpart of ``incubator_mxnet_tpu/parallel/conv_backward.py``
(``conv3x3_bwd_fused``, ``fused_eligible``, ``conv3x3_custom``). As there,
the route is opt-in: ``MXTPU_FUSED_CONV_BWD`` (default off) admits a 3x3
s1 p1 conv into ``conv3x3_custom``, whose forward is ``F.conv2d`` and whose
backward is the fused dx+dW kernel; off, the conv's backward is PyTorch's
(cuDNN on the card). ``MXTPU_CONV_BWD_KERNEL=patch|taps`` picks between two
TPU formulations of one function; the port has one kernel, so the knob
has no effect here.

Kernel note (one H100 SXM: 3.35 TB/s HBM, 67 TFLOP/s fp32 FMA):

* ``conv3x3`` -> ``mx_conv3x3_bwd``, replaces ``_patch_kernel`` and
  ``_bwd_kernel`` (entry ``conv3x3_bwd_fused``). Bound by fp32 operations:
  dx and dW are each 2*N*H*W*O*I*9 FLOPs, 14.80 GFLOP per call at every
  ResNet-50 batch-32 shape, 0.2209 ms at the SIMT fp32 rate (strict fp32
  rules out TF32 tensor cores); bytes (x, go, dx, W, dW) are under 4 us of
  that. The TPU kernel stages zero-padded copies of x and go in VMEM and
  runs the taps as MXU matmuls over a sequential batch grid that carries
  dW in scratch. On the card blocks run in parallel with no carried
  state, so dx is an implicit GEMM over output pixels (go gathered in
  place, padding a predicate, the weight read flipped and transposed in
  place), and dW is a GEMM over the N*H*W pixels split into chunks so its
  small tile grid still fills 132 SMs, then a second pass sums the chunks
  in a fixed order: deterministic, no float atomics. One wrapper call is
  one counted launch; it issues three device kernels (dx, dW partials,
  reduce). A single pass over go for both gradients, wgmma and TMA are
  later work.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ..util import getenv_bool
from .hand_kernel import (DTYPE_CODE, HandKernel, I32_MAX, check, check_data,
                          raise_on)

__all__ = ["conv3x3_plain", "conv3x3_bwd_reference", "conv3x3_bwd",
           "conv3x3_custom", "conv3x3", "fused_eligible", "build"]

_SOURCE = "conv_backward"


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def conv3x3_plain(x, w):
    """The 3x3 s1 p1 NCHW conv, cast to the data dtype; its backward is
    PyTorch's."""
    return F.conv2d(x, w, padding=1).to(x.dtype)


def conv3x3_bwd_reference(x, w, go):
    """(dx, dW) of conv3x3_plain at grad_out ``go``, summed in float64 and
    cast to x's and w's dtypes: the twin of the hand kernel. float64,
    because dW sums N*H*W products (100,352 at ResNet-50 batch 32) and
    cuDNN's fp32 backward is not accurate to 1e-5 of max|dW| there."""
    xd, wd, gd = x.double(), w.double(), go.double()
    dx = torch.nn.grad.conv2d_input(xd.shape, wd, gd, padding=1)
    dw = torch.nn.grad.conv2d_weight(xd, wd.shape, gd, padding=1)
    return dx.to(x.dtype), dw.to(w.dtype)


def fused_eligible(data_shape, w_shape, kernel, stride, dilate, pad,
                   num_group):
    """3x3 stride-1 pad-1 ungrouped 2D conv, with MXTPU_FUSED_CONV_BWD on
    (the JAX package's gate and default)."""
    if not getenv_bool("MXTPU_FUSED_CONV_BWD"):
        return False
    return (len(kernel) == 2 and tuple(kernel) == (3, 3)
            and tuple(stride) == (1, 1) and tuple(dilate) == (1, 1)
            and tuple(pad) == (1, 1) and num_group == 1
            and len(data_shape) == 4)


# ---------------------------------------------------------------------------
# kernel launch (CUDA tensors only)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib():
    from .. import _cuda
    lib = _cuda.library(_SOURCE)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mx_conv3x3_bwd_splits.argtypes = [i] * 5
    lib.mx_conv3x3_bwd_splits.restype = i
    # x, w, go, dx, dw, workspace, workspace elements; n, ci, h, w, co,
    # dtype; stream
    lib.mx_conv3x3_bwd.argtypes = [p] * 6 + [ll] + [i] * 6 + [p]
    lib.mx_conv3x3_bwd.restype = i
    lib.mx_cuda_error_string.argtypes = [i]
    lib.mx_cuda_error_string.restype = ctypes.c_char_p
    return lib


def build():
    """Compile and load the kernel now (else at its first launch)."""
    _lib()


def _launch_bwd(x, w, go):
    check_data("x", x)
    check_data("w", w, x.dtype)
    check_data("go", go, x.dtype)
    check(x.dim() == 4 and x.numel() > 0,
          f"x: expected non-empty NCHW, got {tuple(x.shape)}")
    n, ci, h, wd = x.shape
    co = w.shape[0]
    check(tuple(w.shape) == (co, ci, 3, 3) and w.device == x.device,
          f"w: expected ({co}, {ci}, 3, 3) on {x.device}, got "
          f"{tuple(w.shape)} on {w.device}")
    check(tuple(go.shape) == (n, co, h, wd) and go.device == x.device,
          f"go: expected {(n, co, h, wd)} on {x.device}, got "
          f"{tuple(go.shape)} on {go.device}")
    lib = _lib()
    splits = lib.mx_conv3x3_bwd_splits(n, ci, h, wd, co)
    check(splits > 0 and splits * co * ci * 9 <= I32_MAX,
          f"no dW split for {tuple(x.shape)} x {tuple(w.shape)}")
    dx = torch.empty_like(x)
    dw = torch.empty_like(w)
    ws = torch.empty(splits * co * ci * 9, dtype=torch.float32,
                     device=x.device)
    with torch.cuda.device(x.device):
        err = lib.mx_conv3x3_bwd(
            x.data_ptr(), w.data_ptr(), go.data_ptr(), dx.data_ptr(),
            dw.data_ptr(), ws.data_ptr(), ws.numel(), n, ci, h, wd, co,
            DTYPE_CODE[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    raise_on(lib, err, "conv3x3 backward")
    return dx, dw


conv3x3_bwd = HandKernel("conv3x3", _launch_bwd, conv3x3_bwd_reference)


# ---------------------------------------------------------------------------
# the conv3x3 Function and its tuned entry
# ---------------------------------------------------------------------------

class _Conv3x3Function(torch.autograd.Function):
    """Forward conv3x3_plain; backward the conv3x3_bwd wrapper (the hand
    kernel on the card, its twin on the CPU)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return conv3x3_plain(x, w)

    @staticmethod
    @once_differentiable
    def backward(ctx, go):
        x, w = ctx.saved_tensors
        dx, dw = conv3x3_bwd(x, w, go.to(x.dtype).contiguous())
        return (dx if ctx.needs_input_grad[0] else None,
                dw if ctx.needs_input_grad[1] else None)


def conv3x3_custom(x, w):
    """3x3 s1 p1 conv whose gradient is the fused dx+dW kernel."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _Conv3x3Function.apply(x, w)
    return conv3x3_plain(x, w)


class _TunedConv3x3:
    """What ``tune`` holds under ``conv3x3``: the Function for the card,
    ``plain`` (PyTorch's conv and backward) for a run through the twins,
    and the backward kernel's launch count."""

    name = "conv3x3"
    plain = staticmethod(conv3x3_plain)

    def __call__(self, x, w):
        return conv3x3_custom(x, w)

    @property
    def launches(self):
        return conv3x3_bwd.launches

    def __repr__(self):
        return f"<conv3x3 launches={self.launches}>"


conv3x3 = _TunedConv3x3()


def register_kernels():
    """Register the tuned entry (runs at import; idempotent)."""
    from .. import tune
    tune.register_kernel("conv3x3", conv3x3)


register_kernels()
