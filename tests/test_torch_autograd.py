"""The port's autograd (``incubator_mxnet_tpu_torch/autograd.py`` on
torch.autograd) against the JAX package's tape, on identical numpy inputs,
on the CPU: the record/pause/train flags, attach_grad with grad_req write,
add and null over two backward passes, non-scalar heads and head
gradients, mark_variables, and higher-order gradients through
grad(create_graph=True).

Tolerance: 1e-6 relative and absolute. Both sides run the same fp32
elementwise arithmetic; only the order of a few sums can differ.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx

TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pair(a):
    return jmx.nd.array(a), tmx.nd.array(a, ctx=tmx.cpu())


def _same(j, t):
    np.testing.assert_allclose(t.asnumpy(), np.asarray(j.asnumpy()),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("mx", [jmx, tmx], ids=["jax", "torch"])
def test_record_pause_flags_nest_and_restore(mx):
    ag = mx.autograd
    assert not ag.is_recording() and not ag.is_training()
    with ag.record():
        assert ag.is_recording() and ag.is_training()
        with ag.pause():
            assert not ag.is_recording() and not ag.is_training()
            with ag.train_mode():
                assert ag.is_training() and not ag.is_recording()
        assert ag.is_recording() and ag.is_training()
    with ag.record(train_mode=False):
        assert ag.is_recording() and not ag.is_training()
    with pytest.raises(ValueError):
        with ag.record():
            raise ValueError("inside record")
    assert not ag.is_recording() and not ag.is_training()
    assert ag.set_recording(True) is False
    assert ag.set_recording(False) is True


def _two_passes(mx, x_np, w_np, req_x, req_w):
    x, w = mx.nd.array(x_np), mx.nd.array(w_np)
    if mx is tmx:
        x, w = x.as_in_context(tmx.cpu()), w.as_in_context(tmx.cpu())
    x.attach_grad(req_x)
    w.attach_grad(req_w)
    for scale in (1.0, 3.0):
        with mx.autograd.record():
            y = mx.nd.Activation(x * w, act_type="tanh") * scale + x
        y.backward()
    return x.grad, w.grad


@pytest.mark.parametrize("req_x,req_w", [("write", "write"), ("add", "write"),
                                         ("add", "null"), ("null", "add")])
def test_grad_req_over_two_backward_passes(req_x, req_w):
    r = np.random.RandomState(0)
    x_np = r.standard_normal((3, 4)).astype(np.float32)
    w_np = r.standard_normal((3, 4)).astype(np.float32)
    with tmx.cpu():
        jg = _two_passes(jmx, x_np, w_np, req_x, req_w)
        tg = _two_passes(tmx, x_np, w_np, req_x, req_w)
    for j, t, req in zip(jg, tg, (req_x, req_w)):
        _same(j, t)
        if req == "null":
            assert not np.any(t.asnumpy())


def test_non_scalar_head_and_head_grads():
    r = np.random.RandomState(1)
    a = r.standard_normal((2, 5)).astype(np.float32)
    hg = r.standard_normal((2, 5)).astype(np.float32)
    for head_grad in (None, hg):
        (ja, ta) = _pair(a)
        outs = []
        for mx, x in ((jmx, ja), (tmx, ta)):
            x.attach_grad()
            with mx.autograd.record():
                y = mx.nd.exp(x) * x
            y.backward(None if head_grad is None else
                       mx.nd.array(head_grad, ctx=x.context))
            outs.append(x.grad)
        _same(*outs)


def test_mark_variables_and_grad_leave_buffers_alone():
    r = np.random.RandomState(2)
    a = r.standard_normal((4,)).astype(np.float32)
    outs = []
    for mx in (jmx, tmx):
        ctx = tmx.cpu() if mx is tmx else None
        x = mx.nd.array(a, ctx=ctx)
        buf = mx.nd.array(np.full(4, 7.0, np.float32), ctx=ctx)
        mx.autograd.mark_variables([x], [buf], "add")
        with mx.autograd.record():
            y = x * x * x
        g = mx.autograd.grad(y, [x])[0]
        assert np.all(buf.asnumpy() == 7.0)          # grad() wrote nothing
        with mx.autograd.record():
            y = x * x * x
        y.backward()
        outs.append((g, x.grad))
    for j, t in zip(*outs):
        _same(j, t)


def _second_derivative(mx, a):
    x = mx.nd.array(a, ctx=tmx.cpu() if mx is tmx else None)
    x.attach_grad()
    with mx.autograd.record():
        y = mx.nd.Activation(x, act_type="sigmoid") * x * x
        (dy,) = mx.autograd.grad(y, [x], create_graph=True)
        z = dy * mx.nd.exp(x)
    z.backward()
    return dy, x.grad


def test_higher_order_grad_with_create_graph():
    a = np.linspace(-2.0, 2.0, 7).astype(np.float32)
    for j, t in zip(_second_derivative(jmx, a), _second_derivative(tmx, a)):
        _same(j, t)


def test_ops_outside_record_build_no_graph():
    with tmx.cpu():
        x = tmx.nd.array([1.0, 2.0])
        x.attach_grad()
        y = x * 2.0
        assert not y.astorch().requires_grad
        with tmx.autograd.record():
            with tmx.autograd.pause():
                z = x * 2.0
            w = x * 2.0
        assert not z.astorch().requires_grad and w.astorch().requires_grad
        with pytest.raises(tmx.MXNetError, match="no recorded graph"):
            y.backward()
        x[:] = 5.0                       # setting a leaf outside record
        np.testing.assert_array_equal(x.asnumpy(), [5.0, 5.0])
        assert x.astorch().requires_grad
