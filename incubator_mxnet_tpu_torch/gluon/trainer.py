"""Gluon Trainer on one device.

Counterpart of ``incubator_mxnet_tpu/gluon/trainer.py`` for kvstore None,
'local' or 'device': gradients already sit on the one device, so
``allreduce_grads`` has nothing to reduce. ``step`` sets rescale_grad =
scale / batch_size and runs the aggregated optimizer step: live parameters
bucketed by (dtype, grad_req) into groups of up to the aggregation size,
one multi-tensor update per bucket (``_last_step_dispatches`` counts them).
Not ported yet: the 'dist*' kvstores (slice 6), optimizer-state save/load
and the profiler spans and counters around the step.
"""
from __future__ import annotations

from .. import optimizer as opt
from ..base import MXNetError
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]

_LOCAL_KVSTORES = ("None", "local", "device")


def _aggregation_size():
    """Per-bucket parameter count: engine.bulk(n) / set_bulk_size(n) when
    set, else MXNET_OPTIMIZER_AGGREGATION_SIZE; <= 1 updates one
    parameter at a time."""
    from .. import engine
    from ..util import getenv_int
    n = engine.bulk_size()
    if n > 0:
        return n
    return getenv_int("MXNET_OPTIMIZER_AGGREGATION_SIZE")


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, (dict, ParameterDict)):
            params = [params[k] for k in sorted(params.keys())]
        if not isinstance(params, (list, tuple)):
            raise MXNetError("params must be a ParameterDict/dict/list")
        if kvstore is not None and str(kvstore) not in _LOCAL_KVSTORES:
            raise MXNetError(f"kvstore {kvstore!r} is not ported (slice 6); "
                             f"the port trains on one device (kvstore None, "
                             f"'local' or 'device')")
        self._params = []
        for p in params:
            if not isinstance(p, Parameter):
                raise MXNetError(f"expected Parameter, got {type(p)}")
            self._params.append(p)
        optimizer_params = optimizer_params or {}
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        self._init_optimizer(optimizer, optimizer_params)
        self._last_step_dispatches = 0

    def _init_optimizer(self, optimizer, optimizer_params):
        param_dict = dict(enumerate(self._params))
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params and set(optimizer_params) - {"rescale_grad"}:
                raise MXNetError("optimizer_params must be None when "
                                 "optimizer is an Optimizer instance")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt.create(optimizer, param_dict=param_dict,
                                         **optimizer_params)
        self._updaters = [opt.get_updater(self._optimizer)]

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def step(self, batch_size, ignore_stale_grad=False):
        """allreduce_grads + the optimizer update, with rescale_grad =
        scale / batch_size (reference trainer.py step)."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self.allreduce_grads()
        self._update(ignore_stale_grad)

    def allreduce_grads(self):
        """Nothing to reduce on one device."""

    def update(self, batch_size, ignore_stale_grad=False):
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        updater = self._updaters[0]
        live = []
        for i, p in enumerate(self._params):
            if p.grad_req == "null":
                continue
            if p._data is None:
                if ignore_stale_grad:
                    continue
                raise MXNetError(f"parameter {p.name} not initialized")
            live.append((i, p))
        agg = _aggregation_size()
        dispatches = 0
        if agg <= 1:
            for i, p in live:
                dispatches += updater(i, p.grad(), p.data())
        else:
            groups = {}     # (dtype, grad_req) -> [(i, grad, weight)]
            for i, p in live:
                w = p.data()
                groups.setdefault((w.dtype, p.grad_req), []).append(
                    (i, p.grad(), w))
            for members in groups.values():
                for s in range(0, len(members), agg):
                    chunk = members[s:s + agg]
                    dispatches += updater([m[0] for m in chunk],
                                          [m[1] for m in chunk],
                                          [m[2] for m in chunk])
        self._last_step_dispatches = dispatches
