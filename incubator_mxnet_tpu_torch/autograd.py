"""Autograd mode state.

Counterpart of ``incubator_mxnet_tpu/autograd.py``, cut to what the
inference path reads: the thread-local training flag and the scopes that
set it. Recording a tape and running backward belong to the training
slice; until then they raise instead of silently doing nothing.
"""
from __future__ import annotations

import threading

from .base import MXNetError

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_training",
           "set_training", "backward"]

_NOT_PORTED = ("autograd recording and backward are not ported yet; the "
               "port runs inference only")


class _TLS(threading.local):
    def __init__(self):
        super().__init__()
        self.training = False


_tls = _TLS()


def is_training() -> bool:
    return _tls.training


def set_training(flag: bool) -> bool:
    prev, _tls.training = _tls.training, bool(flag)
    return prev


class _ModeScope:
    def __init__(self, training):
        self._train = training

    def __enter__(self):
        self._prev = set_training(self._train)
        return self

    def __exit__(self, *exc):
        _tls.training = self._prev


def record(train_mode: bool = True):
    raise MXNetError(_NOT_PORTED)


def pause(train_mode: bool = False):
    """Reference python/mxnet/autograd.py:146: stop recording (a no-op
    here, nothing records) and set the training flag."""
    return _ModeScope(train_mode)


def train_mode():
    return _ModeScope(True)


def predict_mode():
    return _ModeScope(False)


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    raise MXNetError(_NOT_PORTED)
