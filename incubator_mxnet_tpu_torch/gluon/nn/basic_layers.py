"""Gluon basic layers: HybridSequential, Dense, BatchNorm, Activation,
Flatten.

Counterpart of the same classes in
``incubator_mxnet_tpu/gluon/nn/basic_layers.py``.
"""
from __future__ import annotations

from ... import autograd
from ..block import HybridBlock

__all__ = ["HybridSequential", "Dense", "BatchNorm", "Flatten", "Activation"]


class HybridSequential(HybridBlock):
    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, *blocks):
        for b in blocks:
            self.register_child(b)

    def _eager_forward(self, x, *args):
        for block in self._children.values():
            x = block(x, *args)
            args = ()
        return x

    def hybrid_forward(self, F, x, *args):
        return self._eager_forward(x, *args)

    def __getitem__(self, key):
        layers = list(self._children.values())[key]
        if isinstance(layers, list):
            net = type(self)(prefix=self._prefix)
            net.add(*layers)
            return net
        return layers

    def __len__(self):
        return len(self._children)

    def __iter__(self):
        return iter(self._children.values())


class Dense(HybridBlock):
    """FullyConnected layer."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, **kwargs):
        super().__init__(**kwargs)
        self._units = units
        self._flatten = flatten
        self.act_type = activation
        self.weight = self.params.get("weight", shape=(units, in_units),
                                      init=weight_initializer, dtype=dtype,
                                      allow_deferred_init=True)
        if use_bias:
            self.bias = self.params.get("bias", shape=(units,),
                                        init=bias_initializer, dtype=dtype,
                                        allow_deferred_init=True)
        else:
            self.bias = None

    def infer_shape(self, x, *args):
        in_units = (int(x.size // x.shape[0]) if self._flatten
                    else int(x.shape[-1]))
        self.weight._infer_shape((self._units, in_units))

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.FullyConnected(x, weight, bias, num_hidden=self._units,
                               no_bias=bias is None, flatten=self._flatten)
        if self.act_type:
            out = F.Activation(out, act_type=self.act_type)
        return out


class BatchNorm(HybridBlock):
    """BatchNorm: batch statistics and the running-stat update in training
    (``autograd.is_training()``), the running statistics otherwise."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._momentum = momentum
        self._epsilon = epsilon
        self._center = center
        self._scale = scale
        self._use_global_stats = use_global_stats
        ch = in_channels
        self.gamma = self.params.get("gamma", shape=(ch,),
                                     init=gamma_initializer,
                                     allow_deferred_init=True,
                                     differentiable=scale)
        self.beta = self.params.get("beta", shape=(ch,),
                                    init=beta_initializer,
                                    allow_deferred_init=True,
                                    differentiable=center)
        self.running_mean = self.params.get("running_mean", shape=(ch,),
                                            init=running_mean_initializer,
                                            allow_deferred_init=True,
                                            differentiable=False)
        self.running_var = self.params.get("running_var", shape=(ch,),
                                           init=running_variance_initializer,
                                           allow_deferred_init=True,
                                           differentiable=False)

    def infer_shape(self, x, *args):
        ch = int(x.shape[self._axis])
        for p in (self.gamma, self.beta, self.running_mean, self.running_var):
            p._infer_shape((ch,))

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        training = autograd.is_training() and not self._use_global_stats
        out, mean, var = F.BatchNorm(
            x, gamma, beta, running_mean, running_var, eps=self._epsilon,
            momentum=self._momentum, fix_gamma=not self._scale,
            use_global_stats=self._use_global_stats, axis=self._axis,
            training=training)
        if training:
            self._update_running_stats(running_mean, running_var, mean, var)
        return out

    def _update_running_stats(self, running_mean, running_var, mean, var):
        """The training-mode update, outside the recorded graph: running =
        running * momentum + batch * (1 - momentum), written in place."""
        with autograd.pause():
            m = self._momentum
            self.running_mean.set_data(running_mean * m + mean * (1 - m))
            self.running_var.set_data(running_var * m + var * (1 - m))


class Flatten(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.flatten(x)


class Activation(HybridBlock):
    def __init__(self, activation, **kwargs):
        self._act_type = activation
        super().__init__(**kwargs)

    def _alias(self):
        return self._act_type

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type)
