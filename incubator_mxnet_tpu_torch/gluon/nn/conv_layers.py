"""Gluon convolution / pooling layers: Conv2D, MaxPool2D, GlobalAvgPool2D.

Counterpart of the same classes in
``incubator_mxnet_tpu/gluon/nn/conv_layers.py``.
"""
from __future__ import annotations

from ..block import HybridBlock

__all__ = ["Conv2D", "MaxPool2D", "GlobalAvgPool2D"]


def _tup(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


class _Conv(HybridBlock):
    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", **kwargs):
        super().__init__(**kwargs)
        ndim = len(kernel_size)
        self._channels = channels
        self._in_channels = in_channels
        self._kernel = kernel_size
        self._strides = _tup(strides, ndim)
        self._padding = _tup(padding, ndim)
        self._dilation = _tup(dilation, ndim)
        self._groups = groups
        self.act_type = activation
        wshape = (channels, in_channels // groups if in_channels else 0) + \
            tuple(kernel_size)
        self.weight = self.params.get("weight", shape=wshape,
                                      init=weight_initializer,
                                      allow_deferred_init=True)
        if use_bias:
            self.bias = self.params.get("bias", shape=(channels,),
                                        init=bias_initializer,
                                        allow_deferred_init=True)
        else:
            self.bias = None

    def infer_shape(self, x, *args):
        ci = int(x.shape[1])
        self.weight._infer_shape((self._channels, ci // self._groups) +
                                 tuple(self._kernel))

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.Convolution(x, weight, bias, kernel=self._kernel,
                            stride=self._strides, dilate=self._dilation,
                            pad=self._padding, num_filter=self._channels,
                            num_group=self._groups, no_bias=bias is None)
        if self.act_type:
            out = F.Activation(out, act_type=self.act_type)
        return out


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", **kwargs):
        super().__init__(channels, _tup(kernel_size, 2), strides, padding,
                         dilation, groups, layout, **kwargs)


class _Pooling(HybridBlock):
    def __init__(self, pool_size, strides, padding, global_pool, pool_type,
                 ceil_mode=False, count_include_pad=True, ndim=2, **kwargs):
        super().__init__(**kwargs)
        self._ndim = ndim
        self._kernel = pool_size
        self._stride = strides if strides is not None else pool_size
        self._pad = padding
        self._global = global_pool
        self._pool_type = pool_type
        self._convention = "full" if ceil_mode else "valid"
        self._count_include_pad = count_include_pad

    def hybrid_forward(self, F, x):
        ndim = self._ndim
        return F.Pooling(x, kernel=_tup(self._kernel, ndim),
                         stride=_tup(self._stride, ndim),
                         pad=_tup(self._pad, ndim), pool_type=self._pool_type,
                         global_pool=self._global,
                         pooling_convention=self._convention,
                         count_include_pad=self._count_include_pad)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        super().__init__(pool_size, strides, padding, False, "max", ceil_mode,
                         ndim=2, **kwargs)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), None, 0, True, "avg", ndim=2, **kwargs)
