"""Fused conv+BN+ReLU forward and BN-apply(+add)(+ReLU) epilogue: hand
CUDA kernels for Hopper, their plain PyTorch twins, and the wrappers that
launch them (``csrc/fused_conv.cu``, built by ``_cuda``). Each wrapper is a
``hand_kernel.HandKernel``: differentiable, with the autograd of its twin
as the backward, as the JAX package's ``_make_bn_act`` and
``_make_conv_bn_relu`` custom_vjp wrappers use the vjp of their XLA
references.

Counterpart of ``incubator_mxnet_tpu/parallel/fused_conv.py``. Numerics
replicate ``ops/nn_ops.py`` in order: f32 accumulate, cast to the data
dtype, re-promote to f32 for scale/bias, cast back, then residual add and
ReLU in the data dtype. Each wrapper runs its twin for tensors on the CPU
and launches its kernel for tensors on a CUDA device, raising on anything
the kernel does not take. It counts its launches in ``launches``.

Kernel notes (one H100 SXM: 3.35 TB/s HBM, 67 TFLOP/s fp32 FMA):

* ``bn_apply`` / ``bn_act`` / ``bn_add_act`` -> ``mx_bn_epilogue``, replaces
  ``_epi_kernel`` and ``_epi_res_kernel``. A pure elementwise pass, bound by
  bytes: z read once, the residual read once, the output written once. The
  TPU kernel views the tensor as (N*H*W, C) rows, which costs an NHWC
  transpose on each side; on the card the kernel walks the NCHW tensor
  flat in 16-byte vectors, keeps a running channel index (one division per
  vector), and reads the per-channel scale/bias through the read-only
  cache, so it moves only the bytes the bound counts.
* ``conv_bn_relu`` -> ``mx_conv_bn_relu``, replaces ``_conv_taps_kernel``
  and ``_conv_patch_kernel`` (two TPU formulations of one function). Bound
  by fp32 operations at ResNet-50 shapes: 2*N*H*W*CO*C*k^2 FLOPs at the
  card's SIMT fp32 rate, since strict fp32 rules out TF32 tensor cores. The
  TPU kernel builds a padded copy or an im2col matrix in VMEM; on the card
  it is an implicit GEMM: each block computes a BM x BN tile (output
  pixels x channels), gathers its input patches straight from the NCHW
  tensor (padding is a predicate, never a copy), keeps 8x8 fp32
  accumulators per thread in registers, double-buffers BK=8 slices in
  shared memory, and applies cast -> scale/bias -> cast -> ReLU in
  registers before its single store, so the conv output never reaches
  device memory unfused. Tile sizes follow the shape (csrc comments).
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .hand_kernel import (DTYPE_CODE, I32_MAX, HandKernel, check,
                          check_data, raise_on)

__all__ = ["bn_act_reference", "conv_bn_relu_reference", "HandKernel",
           "conv_bn_relu", "bn_act", "bn_add_act", "bn_apply",
           "register_kernels", "build"]

_SOURCE = "fused_conv"


# ---------------------------------------------------------------------------
# plain twins (the JAX package's reference functions, in PyTorch)
# ---------------------------------------------------------------------------

def bn_act_reference(z, scale, bias, residual=None, relu=True):
    """The unfused BN-apply chain plus the optional residual add and ReLU,
    rounding to the data dtype BEFORE the add."""
    shape = (1, -1) + (1,) * (z.dim() - 2)
    out = (z * scale.reshape(shape) + bias.reshape(shape)).to(z.dtype)
    if residual is not None:
        out = out + residual
    return torch.relu(out) if relu else out


def conv_bn_relu_reference(x, w, scale, bias, k, pad_lo, pad_hi):
    """Stride-1 NCHW conv (fp32 accumulate, then cast to the data dtype)
    followed by bn_act_reference."""
    pad_lo, pad_hi = tuple(pad_lo), tuple(pad_hi)
    if pad_lo == pad_hi:
        z = F.conv2d(x, w, padding=pad_lo)
    else:
        z = F.conv2d(F.pad(x, (pad_lo[1], pad_hi[1], pad_lo[0], pad_hi[0])),
                     w)
    return bn_act_reference(z.to(x.dtype), scale, bias)


# ---------------------------------------------------------------------------
# kernel launch (CUDA tensors only)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib():
    from .. import _cuda
    lib = _cuda.library(_SOURCE)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mx_bn_epilogue.argtypes = [p, p, p, p, p, ll, i, i, i, i, i, p]
    lib.mx_bn_epilogue.restype = i
    # x, w, scale, bias, out; n, c, h, w, co, k, plo_h, plo_w, dtype; stream
    lib.mx_conv_bn_relu.argtypes = [p, p, p, p, p] + [i] * 9 + [p]
    lib.mx_conv_bn_relu.restype = i
    lib.mx_cuda_error_string.argtypes = [i]
    lib.mx_cuda_error_string.restype = ctypes.c_char_p
    return lib


def build():
    """Compile and load the kernels now (else at their first launch)."""
    _lib()


def _per_channel(name, t, c, device):
    t = t.to(torch.float32).contiguous()
    check(t.device == device and t.numel() == c,
          f"{name}: expected {c} values on {device}, got {tuple(t.shape)} "
          f"on {t.device}")
    return t


def _launch_epilogue(z, scale, bias, residual, relu):
    check_data("z", z)
    check(z.dim() == 4 and z.numel() > 0, f"z: expected non-empty NCHW, "
          f"got {tuple(z.shape)}")
    n, c, h, w = z.shape
    scale = _per_channel("scale", scale, c, z.device)
    bias = _per_channel("bias", bias, c, z.device)
    ptrs = [z]
    if residual is not None:
        check_data("residual", residual, z.dtype)
        check(residual.shape == z.shape and residual.device == z.device,
              "residual: must match z in shape and device")
        ptrs.append(residual)
    out = torch.empty_like(z)
    vec = 16 // z.element_size()
    if z.numel() % vec or any(t.data_ptr() % 16 for t in ptrs + [out]):
        vec = 1
    lib = _lib()
    with torch.cuda.device(z.device):
        err = lib.mx_bn_epilogue(
            z.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            None if residual is None else residual.data_ptr(),
            out.data_ptr(), z.numel(), h * w, c, DTYPE_CODE[z.dtype],
            int(relu), vec, torch.cuda.current_stream(z.device).cuda_stream)
    raise_on(lib, err, "bn epilogue")
    return out


def _launch_conv(x, w, scale, bias, *, k, pad_lo, pad_hi):
    check_data("x", x)
    check_data("w", w, x.dtype)
    check(x.dim() == 4 and x.numel() > 0, f"x: expected non-empty NCHW, got "
          f"{tuple(x.shape)}")
    n, c, h, wd = x.shape
    co = w.shape[0]
    check(tuple(w.shape) == (co, c, k, k) and w.device == x.device,
          f"w: expected ({co}, {c}, {k}, {k}) on {x.device}, got "
          f"{tuple(w.shape)} on {w.device}")
    pad_lo, pad_hi = tuple(pad_lo), tuple(pad_hi)
    check(all(lo >= 0 and hi >= 0 and lo + hi == k - 1
              for lo, hi in zip(pad_lo, pad_hi)),
          f"pads {pad_lo}/{pad_hi}: the kernel takes stride-1 same-size "
          f"convs only (pad_lo + pad_hi == k - 1)")
    check(n * co * h * wd <= I32_MAX, "output: more than 2^31-1 elements")
    scale = _per_channel("scale", scale, co, x.device)
    bias = _per_channel("bias", bias, co, x.device)
    out = torch.empty((n, co, h, wd), dtype=x.dtype, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.mx_conv_bn_relu(
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            out.data_ptr(), n, c, h, wd, co, k, pad_lo[0], pad_lo[1],
            DTYPE_CODE[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    raise_on(lib, err, "conv_bn_relu")
    return out


conv_bn_relu = HandKernel("conv_bn_relu", _launch_conv,
                          conv_bn_relu_reference)
bn_apply = HandKernel(
    "bn_apply",
    lambda z, scale, bias: _launch_epilogue(z, scale, bias, None, False),
    functools.partial(bn_act_reference, relu=False))
bn_act = HandKernel(
    "bn_act",
    lambda z, scale, bias: _launch_epilogue(z, scale, bias, None, True),
    functools.partial(bn_act_reference, relu=True))
bn_add_act = HandKernel(
    "bn_add_act",
    lambda z, scale, bias, residual: _launch_epilogue(z, scale, bias,
                                                      residual, True),
    lambda z, scale, bias, residual: bn_act_reference(z, scale, bias,
                                                      residual, relu=True))


def register_kernels():
    """Register the wrappers with tune (runs at import; idempotent)."""
    from .. import tune
    for kern in (conv_bn_relu, bn_act, bn_add_act, bn_apply):
        tune.register_kernel(kern.name, kern)


register_kernels()
