"""Neural-network operators of the ResNet paths: FullyConnected,
Convolution, Pooling, BatchNorm, FusedBNAddReLU, FusedConvBNReLU and
Activation, in inference and in training (batch statistics).

Counterpart of ``incubator_mxnet_tpu/ops/nn_ops.py`` (same op names,
parameters and (out, mean, var) contracts). Where the JAX package leaves
work to XLA the port leaves it to PyTorch (cuDNN/cuBLAS, TF32 off under
the default "strict" fp32 mode); where it dispatches a tuned Pallas kernel
(``tune.tuned_call``) the port dispatches its hand CUDA kernel. Each hand
kernel is a ``torch.autograd.Function``, so gradients flow through it.

Not on these paths, so not here: the space-to-depth stem rewrite (the JAX
package takes it only on a TPU backend).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .. import tune
from .registry import register


# --------------------------------------------------------------------------
# FullyConnected
# --------------------------------------------------------------------------

@register(name="FullyConnected", aliases=("fully_connected",))
def fully_connected(data, weight, bias=None, *, num_hidden=0, no_bias=False,
                    flatten=True):
    x = data
    if flatten and x.dim() > 2:
        x = torch.reshape(x, (x.shape[0], -1))
    return F.linear(x, weight, None if no_bias else bias)


# --------------------------------------------------------------------------
# Convolution
# --------------------------------------------------------------------------

def _tup(v, n, default):
    if v is None or (hasattr(v, "__len__") and len(v) == 0):
        return (default,) * n
    if isinstance(v, int):
        return (v,) * n
    return tuple(int(x) for x in v)


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _conv_core(data, weight, kernel, stride, dilate, pad, num_group):
    """Convolution dispatch shared by the Convolution op and the fused
    conv+BN+ReLU paths: a 3x3 s1 p1 conv that ``fused_eligible`` admits
    (behind MXTPU_FUSED_CONV_BWD) goes through the tuned ``conv3x3``
    Function, whose backward is the hand dx+dW kernel; every other conv
    is PyTorch's."""
    kernel = tuple(int(k) for k in kernel)
    from ..parallel import conv_backward
    if conv_backward.fused_eligible(tuple(data.shape), tuple(weight.shape),
                                    kernel, stride, dilate, pad, num_group):
        return tune.tuned_call("conv3x3", conv_backward.conv3x3_custom, data,
                               weight)
    return _CONV[len(kernel)](data, weight, stride=stride, padding=pad,
                              dilation=dilate, groups=num_group)


@register(name="Convolution", aliases=("convolution", "Convolution_v1"))
def convolution(data, weight, bias=None, *, kernel, stride=(), dilate=(),
                pad=(), num_filter=0, num_group=1, workspace=1024,
                no_bias=False, cudnn_tune=None, cudnn_off=False, layout=None):
    nd_ = len(kernel)
    stride = _tup(stride, nd_, 1)
    dilate = _tup(dilate, nd_, 1)
    pad = _tup(pad, nd_, 0)
    out = _conv_core(data, weight, kernel, stride, dilate, pad, num_group)
    if bias is not None and not no_bias:
        out = out + torch.reshape(bias, (1, -1) + (1,) * nd_)
    return out.to(data.dtype)


# --------------------------------------------------------------------------
# Pooling
# --------------------------------------------------------------------------

@register(name="Pooling", aliases=("pooling", "Pooling_v1"))
def pooling(data, *, kernel=(), pool_type="max", global_pool=False, stride=(),
            pad=(), pooling_convention="valid", count_include_pad=True,
            cudnn_off=False, p_value=2, layout=None):
    nd_ = data.dim() - 2
    if global_pool:
        if pool_type == "max":
            return torch.amax(data, dim=tuple(range(2, data.dim())),
                              keepdim=True)
        if pool_type in ("avg", "sum"):
            s = torch.sum(data, dim=tuple(range(2, data.dim())),
                          keepdim=True)
            if pool_type == "sum":
                return s
            return (s / math.prod(data.shape[2:])).to(data.dtype)
        raise MXNetError(f"pool_type {pool_type!r} is not ported")
    kernel = _tup(kernel, nd_, 1)
    stride = _tup(stride, nd_, 1)
    pad = _tup(pad, nd_, 0)
    ceil = pooling_convention == "full"
    if pool_type == "max":
        fn = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}[nd_]
        return fn(data, kernel, stride, pad, ceil_mode=ceil)
    if pool_type == "avg":
        fn = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}[nd_]
        return fn(data, kernel, stride, pad, ceil_mode=ceil,
                  count_include_pad=count_include_pad)
    raise MXNetError(f"pool_type {pool_type!r} is not ported")


# --------------------------------------------------------------------------
# Normalization
# --------------------------------------------------------------------------

def _bn_batch_stats(data, red):
    """Batch (mean, var) in f32 over the reduce axes ``red``, in one pass:
    sum and sum of squares of the data shifted by a per-channel estimate
    taken from the first slice of the reduce dims, which keeps
    E[x^2] - E[x]^2 from cancelling when |mean| >> std. A 0-size batch
    takes the plain reductions (NaN statistics, no crash)."""
    n = math.prod(data.shape[i] for i in red)
    if n == 0:
        d = data.to(torch.float32)
        mean = torch.mean(d, dim=red, keepdim=True)
        return (mean.reshape(-1),
                torch.mean(torch.square(d - mean), dim=red))
    first = data.narrow(red[0], 0, 1)
    c = torch.mean(first.to(torch.float32), dim=red, keepdim=True)
    shifted = data.to(torch.float32) - c
    s1 = torch.sum(shifted, dim=red)
    s2 = torch.sum(torch.square(shifted), dim=red)
    dmean = s1 / n
    mean = c.reshape(-1) + dmean
    var = torch.clamp_min(s2 / n - torch.square(dmean), 0.0)
    return mean, var


def _batch_or_moving_stats(data, ax, moving_mean, moving_var, training,
                           use_global_stats):
    """The statistics a BatchNorm applies: batch statistics in training
    (unless use_global_stats), else the moving ones."""
    if training and not use_global_stats:
        red = tuple(i for i in range(data.dim()) if i != ax)
        mean, var = _bn_batch_stats(data, red)
        return mean.to(moving_mean.dtype), var.to(moving_var.dtype)
    return moving_mean, moving_var


def _bn_scale_bias(gamma, beta, mean, var, eps, fix_gamma):
    """BN recomposed as one multiply-add epilogue (per-channel scale/bias)."""
    g = torch.ones_like(gamma) if fix_gamma else gamma
    scale = g * torch.rsqrt(var.to(torch.float32) + eps)
    bias = beta - mean * scale
    return scale, bias


def _bn_apply_plain(data, scale, bias):
    from ..parallel.fused_conv import bn_act_reference
    return bn_act_reference(data, scale, bias, relu=False)


def _bn_act_plain(data, scale, bias):
    from ..parallel.fused_conv import bn_act_reference
    return bn_act_reference(data, scale, bias, relu=True)


def _bn_add_act_plain(data, scale, bias, residual):
    from ..parallel.fused_conv import bn_act_reference
    return bn_act_reference(data, scale, bias, residual, relu=True)


def _conv_bn_relu_plain(data, weight, scale, bias, *, k, pad_lo, pad_hi):
    from ..parallel.fused_conv import conv_bn_relu_reference
    return conv_bn_relu_reference(data, weight, scale, bias, k, pad_lo,
                                  pad_hi)


def _bn_apply(data, scale, bias, ax):
    """The BN scale/bias apply; the hand kernel on the NCHW fast path."""
    if ax == 1 and data.dim() == 4:
        from ..parallel import fused_conv  # noqa: F401 — registers kernels
        return tune.tuned_call("bn_apply", _bn_apply_plain, data, scale,
                               bias)
    shape = [1] * data.dim()
    shape[ax] = data.shape[ax]
    return (data * torch.reshape(scale, shape)
            + torch.reshape(bias, shape)).to(data.dtype)


@register(name="BatchNorm", aliases=("batch_norm", "BatchNorm_v1"),
          train_aware=True)
def batch_norm(data, gamma, beta, moving_mean, moving_var, *, eps=1e-3,
               momentum=0.9, fix_gamma=True, use_global_stats=False,
               output_mean_var=False, axis=1, cudnn_off=False,
               training=False):
    """Returns (out, mean, var) like the JAX op: the batch statistics in
    training, the moving ones otherwise. The Gluon layer owns the
    running-stat update."""
    ax = axis % data.dim()
    mean, var = _batch_or_moving_stats(data, ax, moving_mean, moving_var,
                                       training, use_global_stats)
    scale, bias = _bn_scale_bias(gamma, beta, mean, var, eps, fix_gamma)
    return (_bn_apply(data, scale, bias, ax), mean, var)


@register(name="FusedBNAddReLU", aliases=("fused_bn_add_relu",),
          train_aware=True)
def fused_bn_add_relu(data, gamma, beta, moving_mean, moving_var,
                      residual=None, *, eps=1e-3, momentum=0.9,
                      fix_gamma=True, use_global_stats=False, axis=1,
                      training=False):
    """BatchNorm + optional residual add + ReLU as one op; the BN output is
    rounded to the data dtype BEFORE the residual add and ReLU."""
    ax = axis % data.dim()
    mean, var = _batch_or_moving_stats(data, ax, moving_mean, moving_var,
                                       training, use_global_stats)
    scale, bias = _bn_scale_bias(gamma, beta, mean, var, eps, fix_gamma)
    if ax == 1 and data.dim() == 4:
        from ..parallel import fused_conv  # noqa: F401 — registers kernels
        if residual is None:
            out = tune.tuned_call("bn_act", _bn_act_plain, data, scale, bias)
        else:
            out = tune.tuned_call("bn_add_act", _bn_add_act_plain, data,
                                  scale, bias, residual)
    else:
        out = _bn_apply(data, scale, bias, ax)
        if residual is not None:
            out = out + residual
        out = torch.relu(out)
    return (out, mean, var)


def _conv_bn_relu_infer(data, weight, scale, bias, kernel, stride, dilate,
                        pad, num_group, residual):
    """Inference fused-forward dispatch: one fused kernel when the conv is
    stride-1 same-size with an odd square kernel; anything else is the
    plain conv plus the epilogue kernel."""
    k = kernel[0] if kernel else 0
    if (residual is None and len(kernel) == 2 and kernel == (k, k)
            and k % 2 == 1 and stride == (1, 1) and dilate == (1, 1)
            and pad == (k // 2,) * 2 and num_group == 1 and data.dim() == 4):
        return tune.tuned_call("conv_bn_relu", _conv_bn_relu_plain, data,
                               weight, scale, bias, k=k,
                               pad_lo=(k // 2,) * 2, pad_hi=(k // 2,) * 2)
    z = _conv_core(data, weight, kernel, stride, dilate, pad,
                   num_group).to(data.dtype)
    if residual is None:
        return tune.tuned_call("bn_act", _bn_act_plain, z, scale, bias)
    return tune.tuned_call("bn_add_act", _bn_add_act_plain, z, scale, bias,
                           residual)


@register(name="FusedConvBNReLU", aliases=("fused_conv_bn_relu",),
          train_aware=True)
def fused_conv_bn_relu(data, weight, gamma, beta, moving_mean, moving_var,
                       residual=None, *, kernel, stride=(), dilate=(),
                       pad=(), num_filter=0, num_group=1, eps=1e-3,
                       momentum=0.9, fix_gamma=True, use_global_stats=False,
                       training=False):
    """Convolution + BatchNorm + (optional residual add) + ReLU as one op.
    Inference (or use_global_stats) folds the moving stats into a
    per-channel scale/bias and dispatches the fused forward kernel;
    training materializes the conv output for the batch statistics and
    fuses the epilogue only. Returns (out, mean, var)."""
    nd_ = len(kernel)
    kernel = tuple(int(x) for x in kernel)
    stride = _tup(stride, nd_, 1)
    dilate = _tup(dilate, nd_, 1)
    pad = _tup(pad, nd_, 0)
    from ..parallel import fused_conv  # noqa: F401 — registers the kernels
    if not training or use_global_stats:
        scale, bias = _bn_scale_bias(gamma, beta, moving_mean, moving_var,
                                     eps, fix_gamma)
        out = _conv_bn_relu_infer(data, weight, scale, bias, kernel, stride,
                                  dilate, pad, num_group, residual)
        return (out, moving_mean, moving_var)
    z = _conv_core(data, weight, kernel, stride, dilate, pad,
                   num_group).to(data.dtype)
    mean, var = _batch_or_moving_stats(z, 1, moving_mean, moving_var, True,
                                       False)
    scale, bias = _bn_scale_bias(gamma, beta, mean, var, eps, fix_gamma)
    if residual is None:
        out = tune.tuned_call("bn_act", _bn_act_plain, z, scale, bias)
    else:
        out = tune.tuned_call("bn_add_act", _bn_add_act_plain, z, scale,
                              bias, residual)
    return (out, mean, var)


# --------------------------------------------------------------------------
# Activations
# --------------------------------------------------------------------------

_ACTS = {"relu": torch.relu, "sigmoid": torch.sigmoid, "tanh": torch.tanh,
         "softrelu": F.softplus,
         "softsign": lambda x: x / (1 + torch.abs(x))}


@register(name="Activation", aliases=("activation",))
def activation(data, *, act_type):
    if act_type not in _ACTS:
        raise MXNetError(f"unknown act_type {act_type}")
    return _ACTS[act_type](data)
