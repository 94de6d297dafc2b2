"""Optimizer update operators: sgd_update, sgd_mom_update, nag_mom_update,
adam_update and the multi-tensor multi_sgd_update / multi_sgd_mom_update, plus
``fused_apply``, which runs a Trainer bucket as one multi-tensor update.

Counterpart of the same ops in ``incubator_mxnet_tpu/ops/optimizer_ops.py``.
The JAX package leaves them to XLA, outside any Pallas kernel, so here they
are plain PyTorch ops (``torch._foreach_*`` for the multi forms). Every op
is ``nondiff`` (never recorded), returns new tensors, and keeps the JAX
package's order of arithmetic: rescale, clip, weight decay, momentum.
``fused_apply`` writes the results back in place: a weight stays the same
torch leaf, so its gradient hook and buffer survive the step.
"""
from __future__ import annotations

import torch

from .registry import get_op, register

__all__ = ["fused_apply"]


def _rescaled(grad, weight, rescale_grad, clip_gradient, wd):
    g = grad * rescale_grad
    if clip_gradient >= 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g + wd * weight


@register(name="sgd_update", nondiff=True)
def sgd_update(weight, grad, *, lr, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0, lazy_update=True):
    g = _rescaled(grad, weight, rescale_grad, clip_gradient, wd)
    return weight - lr * g


@register(name="sgd_mom_update", nondiff=True)
def sgd_mom_update(weight, grad, mom, *, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    g = _rescaled(grad, weight, rescale_grad, clip_gradient, wd)
    mom_new = momentum * mom - lr * g
    return (weight + mom_new, mom_new)


@register(name="nag_mom_update", nondiff=True)
def nag_mom_update(weight, grad, mom, *, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    g = _rescaled(grad, weight, rescale_grad, clip_gradient, wd)
    mom_new = momentum * mom + g
    return (weight - lr * (g + momentum * mom_new), mom_new)


@register(name="adam_update", nondiff=True)
def adam_update(weight, grad, mean, var, *, lr, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                lazy_update=True):
    """Adam with the step's bias correction folded into ``lr`` (a float or
    a 0-d tensor); returns (weight, mean, var)."""
    g = _rescaled(grad, weight, rescale_grad, clip_gradient, wd)
    m = beta1 * mean + (1 - beta1) * g
    v = beta2 * var + (1 - beta2) * torch.square(g)
    return (weight - lr * m / (torch.sqrt(v) + epsilon), m, v)


def _multi_rescaled(weights, grads, wds, rescale_grad, clip_gradient):
    g = torch._foreach_mul(grads, rescale_grad)
    if clip_gradient >= 0:
        g = torch._foreach_clamp_min(g, -clip_gradient)
        g = torch._foreach_clamp_max(g, clip_gradient)
    return torch._foreach_add(g, torch._foreach_mul(weights, list(wds)))


@register(name="multi_sgd_update", nondiff=True)
def multi_sgd_update(*args, lrs, wds, rescale_grad=1.0, clip_gradient=-1.0,
                     num_weights=1):
    """Multi-weight SGD: args = [w0, g0, w1, g1, ...] -> (w0', w1', ...)."""
    ws, gs = list(args[0::2]), list(args[1::2])
    g = _multi_rescaled(ws, gs, wds[:num_weights], rescale_grad,
                        clip_gradient)
    return tuple(torch._foreach_sub(
        ws, torch._foreach_mul(g, list(lrs[:num_weights]))))


@register(name="multi_sgd_mom_update", nondiff=True)
def multi_sgd_mom_update(*args, lrs, wds, momentum=0.0, rescale_grad=1.0,
                         clip_gradient=-1.0, num_weights=1):
    """Multi-weight SGD with momentum: args = [w0, g0, m0, w1, ...] ->
    (w0', m0', w1', m1', ...)."""
    ws, gs, ms = list(args[0::3]), list(args[1::3]), list(args[2::3])
    g = _multi_rescaled(ws, gs, wds[:num_weights], rescale_grad,
                        clip_gradient)
    m_new = torch._foreach_sub(torch._foreach_mul(ms, momentum),
                               torch._foreach_mul(g, list(lrs[:num_weights])))
    w_new = torch._foreach_add(ws, m_new)
    return tuple(t for pair in zip(w_new, m_new) for t in pair)


# single-tensor op -> its multi-tensor form (the rest loop the single op)
_MULTI = {"sgd_update": "multi_sgd_update",
          "sgd_mom_update": "multi_sgd_mom_update"}


def _probe_bucket(optimizer, indices, weights, grads, states):
    """Every param of the bucket must map to the same (op, static kwargs)
    and share the first weight's dtype; returns that pair or None, without
    touching the optimizer's step counters."""
    common = None
    for i, w, g, s in zip(indices, weights, grads, states):
        if w.dtype != weights[0].dtype:
            return None
        spec = optimizer._fused_spec(i, w, s)
        if spec is None:
            return None
        key = (spec[0], tuple(sorted(spec[2].items())))
        if common is None:
            common = key
        elif common != key:
            return None
    return common


def fused_apply(optimizer, indices, weights, grads, states):
    """Apply ``optimizer`` to a whole bucket as one multi-tensor update.
    Returns False (having done nothing) when the bucket does not fuse."""
    common = _probe_bucket(optimizer, indices, weights, grads, states)
    if common is None:
        return False
    op_name, static_items = common
    static = dict(static_items)
    for i in indices:
        optimizer._update_count(i)
    specs = [optimizer._fused_spec(i, w, s)
             for i, w, s in zip(indices, weights, states)]
    state_rows = [spec[1] for spec in specs]
    lrs = [spec[3]["lr"] for spec in specs]
    wds = [spec[3]["wd"] for spec in specs]
    rescale = optimizer.rescale_grad
    with torch.no_grad():
        if op_name in _MULTI:
            flat = []
            for w, g, st in zip(weights, grads, state_rows):
                flat += [w._data, g._data] + [a._data for a in st]
            out = get_op(_MULTI[op_name]).fn(
                *flat, lrs=lrs, wds=wds, rescale_grad=rescale,
                num_weights=len(indices), **static)
        else:
            fn = get_op(op_name).fn
            out = []
            for w, g, st, lr, wd in zip(weights, grads, state_rows, lrs, wds):
                res = fn(w._data, g._data, *[a._data for a in st], lr=lr,
                         wd=wd, rescale_grad=rescale, **static)
                out += list(res) if isinstance(res, tuple) else [res]
        per = 1 + len(state_rows[0])
        for j, (w, st) in enumerate(zip(weights, state_rows)):
            w._data.copy_(out[per * j])
            for k, a in enumerate(st):
                a._data = out[per * j + 1 + k]
    return True
