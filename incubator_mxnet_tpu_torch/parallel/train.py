"""TrainStep: a Gluon net's whole training step behind one call.

Counterpart of ``incubator_mxnet_tpu/parallel/train.py`` ``TrainStep`` on
one device. The JAX package compiles forward, backward, the optimizer
update and the BatchNorm running-stat writes into one XLA program; the
port runs the same step eagerly: it keeps its own copies of the
parameters and optimizer state, swaps them into the net for the forward
(so the BatchNorm layers' running-stat writes land in its copies), takes
the gradients with ``torch.autograd.grad`` and applies the registered
update ops in place. ``sync()`` writes the parameters back into the Gluon
Parameters.

``loss_fn(outputs, label)`` takes and returns torch tensors (a scalar
loss), as the JAX package's takes and returns jax arrays.

Not ported yet (ROADMAP queue A): ``mesh``, ``param_rules`` /
``param_spec_fn``, a compute ``dtype``, ``run_epoch`` and checkpoints, the
optimizers other than sgd/nag/adam, and capturing the step in a CUDA graph.
"""
from __future__ import annotations

import torch

from .. import autograd
from ..base import MXNetError
from ..ndarray.ndarray import NDArray
from ..ops import optimizer_ops as _oo

__all__ = ["TrainStep"]

_JAX_ONLY_OPTIMIZERS = ("rmsprop", "signum", "adamw")


def _not_ported(what):
    return MXNetError(f"TrainStep {what} is not ported yet (ROADMAP "
                      f"queue A)")


def _make_update_rule(opt_name, lr, momentum, wd, opt_kwargs):
    """(state_init, update) for an optimizer name, on the registered update
    ops. Every optimizer_params key must be consumed; leftovers raise.

    state_init(param) -> tuple of state tensors
    update(w, g, states, t) -> (new_w, new_states); t is the 1-based step.
    """
    kw = dict(opt_kwargs)
    common = dict(rescale_grad=float(kw.pop("rescale_grad", 1.0)),
                  clip_gradient=float(kw.pop("clip_gradient", -1.0)))

    def _done(rule):
        if kw:
            raise MXNetError(f"TrainStep optimizer {opt_name!r}: unknown "
                             f"optimizer_params {sorted(kw)}")
        return rule

    if opt_name == "sgd" and not momentum:
        return _done((lambda v: (),
                      lambda w, g, st, t: (_oo.sgd_update.fn(
                          w, g, lr=lr, wd=wd, **common), ())))
    if opt_name in ("sgd", "nag"):
        op = _oo.sgd_mom_update if opt_name == "sgd" else _oo.nag_mom_update

        def upd(w, g, st, t, _op=op):
            w2, m2 = _op.fn(w, g, st[0], lr=lr, momentum=momentum, wd=wd,
                            **common)
            return w2, (m2,)
        return _done((lambda v: (torch.zeros_like(v),), upd))
    if opt_name == "adam":
        b1 = float(kw.pop("beta1", 0.9))
        b2 = float(kw.pop("beta2", 0.999))
        eps = float(kw.pop("epsilon", 1e-8))

        def upd(w, g, st, t):
            # the bias correction in float32, as jnp.power on a float32 t;
            # a 0-d CPU tensor, which CUDA ops take as a scalar (no copy)
            tt = torch.tensor(float(t), dtype=torch.float32)
            alpha = lr * torch.sqrt(1 - torch.pow(b2, tt)) / \
                (1 - torch.pow(b1, tt))
            w2, m2, v2 = _oo.adam_update.fn(w, g, st[0], st[1], lr=alpha,
                                            beta1=b1, beta2=b2, epsilon=eps,
                                            wd=wd, **common)
            return w2, (m2, v2)
        return _done((lambda v: (torch.zeros_like(v), torch.zeros_like(v)),
                      upd))
    if opt_name in _JAX_ONLY_OPTIMIZERS:
        raise _not_ported(f"optimizer {opt_name!r}")
    raise MXNetError(f"TrainStep optimizer {opt_name!r} unsupported; one of "
                     "sgd/nag/adam (or use Trainer)")


class TrainStep:
    """One training step of ``net`` under ``loss_fn``:

        step = TrainStep(net, loss_fn, optimizer="sgd",
                         optimizer_params={...}, example_inputs=[x, y])
        loss = step(x_batch, y_batch)
        losses = step.run_steps(n, x_batch, y_batch)
    """

    def __init__(self, net, loss_fn, optimizer="sgd", optimizer_params=None,
                 mesh=None, example_inputs=None, param_spec_fn=None,
                 param_rules=None, data_axis="dp", dtype=None, donate=True):
        if example_inputs is None:
            raise MXNetError("TrainStep needs example_inputs")
        if mesh is not None:
            raise _not_ported("mesh (multi-device)")
        if param_rules is not None or param_spec_fn is not None:
            raise _not_ported("param_rules / param_spec_fn")
        if dtype is not None:
            raise _not_ported("compute dtype")
        self.net = net
        self.mesh = None
        self._loss_fn = loss_fn
        opt_kwargs = dict(optimizer_params or {})
        lr = float(opt_kwargs.pop("learning_rate", 0.01))
        momentum = float(opt_kwargs.pop("momentum", 0.0))
        wd = float(opt_kwargs.pop("wd", 0.0))
        state_init, self._update = _make_update_rule(
            optimizer, lr, momentum, wd, opt_kwargs)

        plist = net.collect_params()
        if any(p._data is None for p in plist.values()):
            # finish deferred init with one forward that writes no state
            with autograd.pause(train_mode=False):
                net(*[self._wrap(x) for x in example_inputs[:1]])
        self._param_list = [plist[k] for k in sorted(plist.keys())]
        self._diff = [p.name for p in self._param_list
                      if p.grad_req != "null"]
        self.params = {p.name: p.data()._data.detach().clone()
                       .requires_grad_(p.grad_req != "null")
                       for p in self._param_list}
        self.opt_state = {k: state_init(self.params[k]) for k in self._diff}
        self._step_count = 0

    @staticmethod
    def _wrap(x):
        return x if isinstance(x, NDArray) else NDArray(x)

    def _device_batch(self, batch):
        device = next(iter(self.params.values())).device
        return [(b._data if isinstance(b, NDArray) else torch.as_tensor(b))
                .to(device) for b in batch]

    def _step(self, *batch):
        inputs, label = batch[:-1], batch[-1]
        held = [p._data._data for p in self._param_list]
        for p in self._param_list:
            p._data._data = self.params[p.name]
        try:
            with autograd.record(train_mode=True):
                out = self.net(*[NDArray(t) for t in inputs])
            if isinstance(out, (list, tuple)):
                out = out[0]
            with torch.enable_grad():
                loss = self._loss_fn(out._data, label)
                wrt = [self.params[k] for k in self._diff]
                grads = torch.autograd.grad(loss, wrt, allow_unused=True)
        finally:
            for p, t in zip(self._param_list, held):
                p._data._data = t
        t = self._step_count + 1
        with torch.no_grad():
            for k, g in zip(self._diff, grads):
                w = self.params[k]
                if g is None:           # a parameter the loss does not use
                    g = torch.zeros_like(w)
                w_new, self.opt_state[k] = self._update(
                    w, g.to(w.dtype), self.opt_state[k], t)
                w.copy_(w_new)
        self._step_count += 1
        return loss.detach()

    def __call__(self, *batch):
        """One step on ``batch`` = (inputs..., label); returns the loss
        (a torch scalar) of the parameters before the update."""
        return self._step(*self._device_batch(batch))

    def run_steps(self, n, *batch):
        """``n`` steps on one batch; returns the per-step losses as an
        NDArray of shape (n,)."""
        arrs = self._device_batch(batch)
        return NDArray(torch.stack([self._step(*arrs) for _ in range(n)]))

    def run_epoch(self, *args, **kwargs):
        raise _not_ported("run_epoch")

    def save_checkpoint(self, *args, **kwargs):
        raise _not_ported("checkpoints")

    def load_checkpoint(self, *args, **kwargs):
        raise _not_ported("checkpoints")

    def sync(self):
        """Write the step's parameters back into the Gluon Parameters (in
        place: each stays the same autograd leaf)."""
        with torch.no_grad():
            for p in self._param_list:
                p._data._data.copy_(self.params[p.name])
