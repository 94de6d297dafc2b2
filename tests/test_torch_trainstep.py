"""The port's ``parallel.TrainStep`` against the JAX package's, and against
the port's own record/backward/Trainer.step loop, on identical numpy
inputs and weights, on the CPU, for a small HybridSequential (Conv2D,
BatchNorm, Activation, Dense) trained with SGD momentum.

Tolerance: per-step losses and final weights (BatchNorm running
statistics included) within 1e-5 of the largest magnitude in each, against
the JAX package (short fp32 sums in another order); against the port's own
Trainer loop 1e-6 (the same ops, with the 1/batch scaling of the gradient
applied at the head instead of in the update: exact for a power-of-two
batch).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu.parallel import TrainStep as JTrainStep
from incubator_mxnet_tpu_torch.convert import load_jax_params
from incubator_mxnet_tpu_torch.parallel import TrainStep

TOL = 1e-5
_OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _net(mx):
    nn = mx.gluon.nn
    net = nn.HybridSequential()
    net.add(nn.Conv2D(4, 3, padding=1, in_channels=3),
            nn.BatchNorm(in_channels=4), nn.Activation("relu"),
            nn.Dense(5, in_units=4 * 6 * 6))
    return net


def _setup():
    r = np.random.RandomState(0)
    x = r.standard_normal((4, 3, 6, 6)).astype(np.float32)
    y = r.randint(0, 5, 4).astype(np.float32)
    net = _net(tmx)
    net.initialize(tmx.init.Xavier(
        generator=torch.Generator().manual_seed(0)), ctx=tmx.cpu())
    arrays = {k: p.data().asnumpy()
              for k, p in net._collect_params_with_prefix().items()}
    return arrays, x, y


def _jax_loss(out, label):
    logp = jax.nn.log_softmax(out, axis=-1)
    return -jnp.mean(jnp.take_along_axis(
        logp, label.astype(jnp.int32)[:, None], axis=1))


def _torch_loss(out, label):
    logp = torch.log_softmax(out, dim=-1)
    return -logp.gather(1, label.long()[:, None]).mean()


def _port_net(arrays):
    net = _net(tmx)
    load_jax_params(net, arrays, ctx=tmx.cpu())
    return net


def _state(net):
    return {k: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


def _close(port, ref, tol):
    scale = max(float(np.abs(a).max()) for a in ref.values())
    assert port.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(port[k], np.asarray(ref[k], np.float32),
                                   rtol=tol, atol=tol * scale, err_msg=k)


def test_run_steps_matches_jax_trainstep():
    arrays, x, y = _setup()
    jnet = _net(jmx)
    for k, p in jnet._collect_params_with_prefix().items():
        p.set_data(jmx.nd.array(arrays[k]))
    jstep = JTrainStep(jnet, _jax_loss, optimizer="sgd",
                       optimizer_params=dict(_OPT),
                       example_inputs=[jmx.nd.array(x)])
    jl = np.asarray(jstep.run_steps(2, jnp.asarray(x), jnp.asarray(y))
                    .asnumpy())
    jstep.sync()
    tnet = _port_net(arrays)
    tstep = TrainStep(tnet, _torch_loss, optimizer="sgd",
                      optimizer_params=dict(_OPT),
                      example_inputs=[tmx.nd.array(x, ctx=tmx.cpu())])
    before = _state(tnet)
    tl = tstep.run_steps(2, tmx.nd.array(x, ctx=tmx.cpu()),
                         tmx.nd.array(y, ctx=tmx.cpu())).asnumpy()
    _close(_state(tnet), before, 0.0)           # untouched until sync()
    tstep.sync()
    assert tl.shape == (2,) and tl[1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=TOL, atol=TOL)
    _close(_state(tnet), {k: p.data().asnumpy() for k, p in
                          jnet._collect_params_with_prefix().items()}, TOL)


def test_trainstep_matches_the_trainer_loop():
    arrays, x, y = _setup()
    step_net = _port_net(arrays)
    step = TrainStep(step_net, _torch_loss, optimizer="sgd",
                     optimizer_params=dict(_OPT),
                     example_inputs=[tmx.nd.array(x, ctx=tmx.cpu())])
    step_losses = [float(step(x, y)) for _ in range(3)]
    step.sync()
    net = _port_net(arrays)
    trainer = tmx.gluon.Trainer(net.collect_params(), "sgd", dict(_OPT))
    loss = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for _ in range(3):
        with tmx.autograd.record():
            L = loss(net(tmx.nd.array(x, ctx=tmx.cpu())),
                     tmx.nd.array(y, ctx=tmx.cpu()))
        L.backward()
        trainer.step(4)
        losses.append(float(L.asnumpy().mean()))
    np.testing.assert_allclose(step_losses, losses, rtol=1e-6, atol=1e-6)
    _close(_state(step_net), _state(net), 1e-6)


@pytest.mark.parametrize("kwargs,match", [
    ({"mesh": object()}, "not ported"),
    ({"dtype": "bfloat16"}, "not ported"),
    ({"param_rules": []}, "not ported"),
    ({"optimizer": "rmsprop"}, "not ported"),
    ({"optimizer": "lbfgs"}, "unsupported"),
    ({"optimizer_params": {"learning_rate": 0.1, "momentun": 0.9}},
     "unknown optimizer_params"),
    ({"example_inputs": None}, "needs example_inputs"),
])
def test_trainstep_refuses_what_is_not_ported(kwargs, match):
    arrays, x, _ = _setup()
    args = dict(optimizer="sgd", optimizer_params=dict(_OPT),
                example_inputs=[tmx.nd.array(x, ctx=tmx.cpu())])
    args.update(kwargs)
    with pytest.raises(tmx.MXNetError, match=match):
        TrainStep(_port_net(arrays), _torch_loss, **args)
    step = TrainStep(_port_net(arrays), _torch_loss,
                     example_inputs=[tmx.nd.array(x, ctx=tmx.cpu())])
    with pytest.raises(tmx.MXNetError, match="not ported"):
        step.run_epoch([])
