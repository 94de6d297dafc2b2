"""Gluon losses: Loss, L1Loss, L2Loss, SoftmaxCrossEntropyLoss.

Counterpart of the same classes in ``incubator_mxnet_tpu/gluon/loss.py``:
each loss implements ``_unreduced`` (the per-element loss) and the base
class applies the constructor weight, the per-call sample weight and the
mean over every non-batch axis. The other losses of the JAX package are
not ported yet.
"""
from __future__ import annotations

from .block import HybridBlock

__all__ = ["Loss", "L1Loss", "L2Loss", "SoftmaxCrossEntropyLoss",
           "SoftmaxCELoss"]


def _match(label, pred):
    """View the label with the prediction's shape."""
    return label.reshape(pred.shape)


class Loss(HybridBlock):
    """Base: subclasses implement _unreduced(F, pred, label)."""

    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def _finish(self, F, loss, sample_weight, reduce=True):
        if sample_weight is not None:
            loss = F.broadcast_mul(loss, sample_weight)
        if self._weight is not None:
            loss = loss * self._weight
        if reduce:
            loss = F.mean(loss, axis=self._batch_axis, exclude=True)
        return loss

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        return self._finish(F, self._unreduced(F, pred, label), sample_weight)

    def _unreduced(self, F, pred, label):
        raise NotImplementedError


class L1Loss(Loss):
    """mean |pred - label|."""

    def _unreduced(self, F, pred, label):
        return F.abs(pred - _match(label, pred))


class L2Loss(Loss):
    """mean (pred - label)^2 / 2 (the reference's 1/2 convention)."""

    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def _unreduced(self, F, pred, label):
        return F.square(pred - _match(label, pred)) * 0.5


class SoftmaxCrossEntropyLoss(Loss):
    """Cross entropy over an axis; sparse integer labels by default, dense
    label distributions with sparse_label=False, log-probabilities as pred
    with from_logits=True."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def _unreduced(self, F, pred, label):
        logp = pred if self._from_logits else F.log_softmax(pred,
                                                            axis=self._axis)
        if self._sparse_label:
            return -F.pick(logp, label, axis=self._axis, keepdims=True)
        return -F.sum(logp * _match(label, logp), axis=self._axis,
                      keepdims=True)


SoftmaxCELoss = SoftmaxCrossEntropyLoss
