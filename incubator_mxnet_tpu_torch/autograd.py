"""Autograd: record/pause/backward/grad on ``torch.autograd``.

Counterpart of ``incubator_mxnet_tpu/autograd.py``. The JAX package keeps
its own tape of vjp closures; here torch's graph is the tape:

* ``record()`` sets a thread-local flag; the op registry runs every op
  with torch's grad mode equal to that flag (``ops/registry.py``), so ops
  outside ``record()`` build no graph, as in MXNet.
* ``NDArray.attach_grad`` makes the array's tensor a torch leaf that
  requires grad and gives it a gradient buffer plus a ``grad_req``.
* ``backward`` runs ``torch.autograd.backward``. A hook on each attached
  leaf moves the gradient torch accumulated into ``.grad`` into the
  array's buffer by its ``grad_req``: ``write`` overwrites, ``add``
  accumulates, ``null`` gets nothing. torch's ``.grad`` is cleared each
  time, so torch's own accumulation never leaks into the ``write`` case.
* ``grad`` is ``torch.autograd.grad``: it returns the gradients and leaves
  the buffers alone.

A custom ``autograd.Function`` is not ported yet and raises.
"""
from __future__ import annotations

import threading
import weakref

import torch

from .base import MXNetError

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "mark_variables",
           "backward", "grad", "Function"]


class _TLS(threading.local):
    def __init__(self):
        super().__init__()
        self.recording = False
        self.training = False


_tls = _TLS()


def is_recording() -> bool:
    return _tls.recording


def is_training() -> bool:
    return _tls.training


def set_recording(flag: bool) -> bool:
    prev, _tls.recording = _tls.recording, bool(flag)
    return prev


def set_training(flag: bool) -> bool:
    prev, _tls.training = _tls.training, bool(flag)
    return prev


class _RecordScope:
    """Sets the recording and/or training flag (None leaves one alone) and
    restores both on exit, exception or not."""

    def __init__(self, recording, training):
        self._rec, self._train = recording, training

    def __enter__(self):
        self._prev = (_tls.recording, _tls.training)
        if self._rec is not None:
            _tls.recording = self._rec
        if self._train is not None:
            _tls.training = self._train
        return self

    def __exit__(self, *exc):
        _tls.recording, _tls.training = self._prev


def record(train_mode: bool = True):
    """``with autograd.record():`` (reference python/mxnet/autograd.py:122)."""
    return _RecordScope(True, train_mode)


def pause(train_mode: bool = False):
    """Stop recording inside a record scope (reference autograd.py:146)."""
    return _RecordScope(False, train_mode)


def train_mode():
    return _RecordScope(None, True)


def predict_mode():
    return _RecordScope(None, False)


def _grad_hook(ref):
    """Post-accumulate hook of an attached leaf: move torch's ``.grad``
    into the array's buffer by its grad_req."""
    def hook(tensor):
        g, tensor.grad = tensor.grad, None
        arr = ref()
        if arr is None or g is None or arr._grad is None:
            return
        buf = arr._grad
        if arr._grad_req == "add":
            buf._data = buf._data + g
        elif arr._grad_req == "write":
            buf._data = g if g.dtype == buf._data.dtype else \
                g.to(buf._data.dtype)
    return hook


def _mark(arr, grad_buf, grad_req):
    """Make ``arr`` a fresh torch leaf with ``grad_buf`` as its gradient
    buffer. With a buffer the leaf requires grad, whatever the grad_req
    (a 'null' buffer is recorded through but never written, as in the JAX
    package); without one (a 'null' Parameter) it does not."""
    if grad_req not in ("write", "add", "null"):
        raise MXNetError(f"grad_req must be write/add/null, got {grad_req!r}")
    t = arr._data.detach()
    if grad_buf is not None:
        if not t.is_floating_point():
            raise MXNetError(f"cannot attach a gradient to a {t.dtype} array")
        t.requires_grad_(True)
        t.register_post_accumulate_grad_hook(_grad_hook(weakref.ref(arr)))
    arr._data = t
    arr._grad = grad_buf
    arr._grad_req = grad_req


def mark_variables(variables, gradients, grad_reqs="write"):
    """Reference python/mxnet/autograd.py:197."""
    from .ndarray import NDArray
    if isinstance(variables, NDArray):
        variables, gradients = [variables], [gradients]
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        _mark(v, g, req)


def _heads(heads, head_grads):
    """(head tensors, their gradients) for the heads that carry a graph;
    a head without head_grad takes ones, scalar or not."""
    from .ndarray import NDArray
    if isinstance(heads, NDArray):
        heads = [heads]
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif isinstance(head_grads, NDArray):
        head_grads = [head_grads]
    tensors, grads = [], []
    for h, hg in zip(heads, head_grads):
        t = h._data
        if not t.requires_grad:
            continue
        tensors.append(t)
        grads.append(torch.ones_like(t) if hg is None
                     else hg._data.to(device=t.device, dtype=t.dtype))
    if not tensors:
        raise MXNetError("backward() called on arrays with no recorded graph")
    return tensors, grads


def backward(heads, head_grads=None, retain_graph=False, train_mode=True,
             create_graph=False):
    """Gradients of ``heads`` into the buffers of the attached arrays they
    depend on, by each array's grad_req (reference autograd.py:246)."""
    tensors, grads = _heads(heads, head_grads)
    torch.autograd.backward(tensors, grads,
                            retain_graph=retain_graph or create_graph,
                            create_graph=create_graph)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Gradients of ``heads`` with respect to ``variables``, returned and
    not written to any buffer (reference autograd.py:273). With
    create_graph=True they carry their own graph and can be
    differentiated again."""
    from .ndarray import NDArray
    single = isinstance(variables, NDArray)
    if single:
        variables = [variables]
    tensors, grads = _heads(heads, head_grads)
    inputs = [v._data for v in variables]
    for v, t in zip(variables, inputs):
        if not t.requires_grad:
            raise MXNetError("grad(): a variable is neither attached "
                             "(attach_grad) nor computed under record()")
    outs = torch.autograd.grad(
        tensors, inputs, grads,
        retain_graph=bool(retain_graph) or create_graph,
        create_graph=create_graph, allow_unused=True)
    res = [NDArray(g if g is not None else torch.zeros_like(t))
           for g, t in zip(outs, inputs)]
    return res[0] if single else res


class Function:
    """Custom differentiable function (reference autograd.py:368). Not
    ported yet: subclasses raise when constructed."""

    def __init__(self, *args, **kwargs):
        raise MXNetError("autograd.Function is not ported yet (ROADMAP "
                         "queue A)")
