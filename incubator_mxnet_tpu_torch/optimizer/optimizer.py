"""Optimizers: the ``Optimizer`` base, SGD and NAG, the registry, and the
``Updater``.

Counterpart of ``incubator_mxnet_tpu/optimizer/optimizer.py``. Every update
is one registered update op (``ops/optimizer_ops.py``); a Trainer bucket
goes through ``Optimizer.update_multi``, which runs it as one multi-tensor
update when every parameter maps to the same op (``_fused_spec``). Weights
are updated in place, so a weight stays the same autograd leaf. The JAX
package's other optimizers, multi-precision states and the Updater's state
serialization are not ported yet: creating one of those optimizers raises.
"""
from __future__ import annotations

import torch

from .. import nd
from ..base import MXNetError
from ..ops.registry import invoke

__all__ = ["Optimizer", "SGD", "NAG", "create", "register", "Updater",
           "get_updater"]

_REG = {}
# the JAX package's optimizers this port does not carry yet
_NOT_PORTED = ("signum", "signsgd", "ftml", "sgld", "adam", "adagrad",
               "rmsprop", "adadelta", "ftrl", "adamax", "nadam", "dcasgd",
               "lbsgd", "adamw", "test")


def register(cls):
    _REG[cls.__name__.lower()] = cls
    return cls


def create(name, **kwargs):
    if isinstance(name, Optimizer):
        return name
    key = name.lower()
    if key in _REG:
        return _REG[key](**kwargs)
    if key in _NOT_PORTED:
        raise MXNetError(f"optimizer {name!r} is not ported yet (ROADMAP "
                         f"queue A); the port has {sorted(_REG)}")
    raise MXNetError(f"unknown optimizer {name!r}")


def _write(weight, new):
    """Write an update into a weight in place (it may be an autograd
    leaf)."""
    with torch.no_grad():
        weight._data.copy_(new._data)


class Optimizer:
    """Base optimizer (reference optimizer.py:47): lr and wd with per-index
    multipliers, rescale_grad, clip_gradient, per-index update counts."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.multi_precision = multi_precision
        self.idx2name = dict(param_idx2name or {})
        self.param_dict = param_dict or {}
        self.lr_mult = {}
        self.wd_mult = {}

    @staticmethod
    def create_optimizer(name, **kwargs):
        return create(name, **kwargs)

    def create_state(self, index, weight):
        return None

    def create_state_multi_precision(self, index, weight):
        if self.multi_precision and weight.dtype in ("float16", "bfloat16"):
            raise MXNetError("multi-precision optimizer states are not "
                             "ported yet (ROADMAP queue A)")
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def update_multi_precision(self, index, weight, grad, state):
        self.update(index, weight, grad, state)

    def _fused_spec(self, index, weight, state):
        """This param's update as one call of a registered single-tensor
        op: (op_name, state_arrays, static_kwargs, {"lr", "wd"}), or None
        to opt out of bucketing. Called once before the update counts
        commit (must not raise on unseen indices) and once after."""
        return None

    def update_multi(self, indices, weights, grads, states):
        """Update a bucket: one multi-tensor update when every param maps
        to the same op, else one update per param. Returns the number of
        update dispatches issued."""
        from ..ops.optimizer_ops import fused_apply
        if len(indices) > 1 and fused_apply(self, indices, weights, grads,
                                            states):
            return 1
        for i, w, g, s in zip(indices, weights, grads, states):
            self.update_multi_precision(i, w, g, s)
        return len(indices)

    def set_learning_rate(self, lr):
        self.lr = lr

    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = dict(args_wd_mult)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self.num_update,
                              self._index_update_count[index])

    def _get_lr(self, index):
        lr = (self.lr_scheduler(self.num_update) if self.lr_scheduler
              else self.lr)
        if index in self.param_dict:
            lr *= self.param_dict[index].lr_mult
        elif index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.param_dict:
            wd *= self.param_dict[index].wd_mult
        elif index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd

    def _clip(self):
        return self.clip_gradient if self.clip_gradient is not None else -1.0


@register
class SGD(Optimizer):
    """SGD, with momentum when momentum != 0 (sgd_update /
    sgd_mom_update)."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        if self.momentum != 0.0:
            return nd.zeros(weight.shape, ctx=weight.context,
                            dtype=weight.dtype)
        return None

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        if state is not None:
            w_new, m_new = invoke("sgd_mom_update", weight, grad, state,
                                  lr=lr, momentum=self.momentum, wd=wd,
                                  rescale_grad=self.rescale_grad,
                                  clip_gradient=self._clip())
            state._data = m_new._data
        else:
            w_new = invoke("sgd_update", weight, grad, lr=lr, wd=wd,
                           rescale_grad=self.rescale_grad,
                           clip_gradient=self._clip())
        _write(weight, w_new)

    def _fused_spec(self, index, weight, state):
        dyn = {"lr": self._get_lr(index), "wd": self._get_wd(index)}
        if state is not None:
            return ("sgd_mom_update", [state],
                    {"momentum": self.momentum,
                     "clip_gradient": self._clip()}, dyn)
        return ("sgd_update", [], {"clip_gradient": self._clip()}, dyn)


@register
class NAG(Optimizer):
    """Nesterov momentum SGD (nag_mom_update; plain SGD at momentum 0)."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum != 0.0:
            return nd.zeros(weight.shape, ctx=weight.context,
                            dtype=weight.dtype)
        return None

    def update(self, index, weight, grad, state):
        if state is None:
            SGD.update(self, index, weight, grad, None)
            return
        self._update_count(index)
        w_new, m_new = invoke("nag_mom_update", weight, grad, state,
                              lr=self._get_lr(index), momentum=self.momentum,
                              wd=self._get_wd(index),
                              rescale_grad=self.rescale_grad,
                              clip_gradient=self._clip())
        state._data = m_new._data
        _write(weight, w_new)

    def _fused_spec(self, index, weight, state):
        dyn = {"lr": self._get_lr(index), "wd": self._get_wd(index)}
        if state is None:
            return ("sgd_update", [], {"clip_gradient": self._clip()}, dyn)
        return ("nag_mom_update", [state],
                {"momentum": self.momentum,
                 "clip_gradient": self._clip()}, dyn)


class Updater:
    """Applies an optimizer with per-index state (reference optimizer.py
    Updater)."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states = {}

    def __call__(self, index, grad, weight):
        """One update, or a bucket in the list form (lists of indices,
        grads, weights). Returns the number of update dispatches."""
        if isinstance(index, (list, tuple)):
            for i, w in zip(index, weight):
                if i not in self.states:
                    self.states[i] = \
                        self.optimizer.create_state_multi_precision(i, w)
            return self.optimizer.update_multi(
                list(index), list(weight), list(grad),
                [self.states[i] for i in index])
        if index not in self.states:
            self.states[index] = self.optimizer.create_state_multi_precision(
                index, weight)
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.states[index])
        return 1


def get_updater(optimizer):
    return Updater(optimizer)
