"""The port's training surface against the JAX package's, on identical
numpy inputs and weights, on the CPU: the losses, the optimizer update
ops, and gluon.Trainer over whole training steps (autograd.record /
backward / Trainer.step) of a small MLP, a narrow BottleneckV1 net and
ResNet-50 v1. The JAX side runs its defaults (MXTPU_FUSED_CONV_BWD off);
the port runs with the knob off and on (ResNet-50: on), which on the CPU
routes every 3x3 s1 conv through the conv3x3 autograd Function and its
twin backward.

Tolerances (each check states which):
* losses, update ops, MLP and BottleneckV1 trajectories: 1e-5 relative
  (to max|reference| per array): short fp32 sums in another order;
* ResNet-50 (batch 2, 3x64x64, 2 steps): the step-1 losses within 2e-4
  relative (a train-mode forward through 53 BatchNorms); after 2 steps the
  parameter updates of the two packages agree to 0.25 in relative L2 over
  the whole net, the momenta (which carry the whole step-2 gradient) to
  0.5, and every parameter's update points the same way (cosine >= 0.5).
  Over four seeds of weights and input these measured 2.2e-5-6.0e-5,
  0.062-0.100, 0.140-0.228 and a smallest cosine of 0.746-0.850: each
  upper bound is at least twice the worst, the cosine bound well under
  the lowest. Looser than the other cases, because a randomly initialised
  ResNet-50 trained at batch 2 is sensitive to float32 rounding itself:
  the summation order of its convolutions alone moves some parameters'
  gradients by percents. At 3x32x32 the last stage's batch statistics run
  over 2 values per channel and turn BatchNorm into a sign function, so
  the two packages' logits there differ by O(1).
"""
import functools

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu.gluon.model_zoo import vision as jvision
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.convert import load_jax_params
from incubator_mxnet_tpu_torch.gluon.model_zoo import vision as tvision

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(a):
    return np.asarray(a.asnumpy(), np.float32)


def _close(port, ref, tol=TOL):
    port, ref = _np(port), _np(ref)
    assert port.shape == ref.shape
    np.testing.assert_allclose(port, ref, rtol=tol,
                               atol=tol * max(float(np.abs(ref).max()), 1e-6))


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------

def _loss_case(kind):
    r = np.random.RandomState(0)
    pred = r.standard_normal((4, 5)).astype(np.float32)
    if kind == "sparse":
        return "SoftmaxCrossEntropyLoss", {}, pred, \
            np.array([0, 3, 4, 1], np.float32)
    if kind == "dense":
        lab = r.rand(4, 5).astype(np.float32)
        return "SoftmaxCrossEntropyLoss", {"sparse_label": False}, pred, \
            lab / lab.sum(1, keepdims=True)
    if kind == "from_logits":
        logp = pred - np.log(np.exp(pred).sum(1, keepdims=True))
        return "SoftmaxCrossEntropyLoss", {"from_logits": True}, logp, \
            np.array([2, 2, 0, 4], np.float32)
    return kind, {"weight": 0.5}, pred, r.standard_normal((4, 5)).astype(
        np.float32)


@pytest.mark.parametrize("kind", ["sparse", "dense", "from_logits", "L1Loss",
                                  "L2Loss"])
def test_loss_values_and_gradients(kind):
    name, kw, pred, label = _loss_case(kind)
    sw = np.array([[1.0], [0.5], [2.0], [0.0]], np.float32)
    outs = []
    for mx, ctx in ((jmx, None), (tmx, tmx.cpu())):
        p = mx.nd.array(pred, ctx=ctx)
        p.attach_grad()
        loss = getattr(mx.gluon.loss, name)(**kw)
        with mx.autograd.record():
            L = loss(p, mx.nd.array(label, ctx=ctx),
                     mx.nd.array(sw, ctx=ctx))
        L.backward()
        outs.append((L, p.grad))
    for j, t in zip(*outs):
        _close(t, j)


def test_loss_on_one_dimensional_predictions():
    """Per-sample losses of (N,) predictions: the mean over no remaining
    axis leaves them as they are."""
    r = np.random.RandomState(5)
    pred, label = r.standard_normal((2, 6)).astype(np.float32)
    outs = [mx.gluon.loss.L2Loss()(
        mx.nd.array(pred, ctx=ctx), mx.nd.array(label, ctx=ctx))
        for mx, ctx in ((jmx, None), (tmx, tmx.cpu()))]
    assert outs[1].shape == (6,)
    _close(outs[1], outs[0])


# --------------------------------------------------------------------------
# optimizer update ops
# --------------------------------------------------------------------------

_HYPER = {"lr": 0.1, "wd": 0.01, "rescale_grad": 0.5, "clip_gradient": 0.6}


@pytest.mark.parametrize("op", ["sgd_update", "sgd_mom_update",
                                "nag_mom_update", "multi_sgd_update",
                                "multi_sgd_mom_update"])
def test_optimizer_ops(op):
    r = np.random.RandomState(1)
    arrays = [r.standard_normal((3, 4)).astype(np.float32) for _ in range(3)]
    if op.startswith("multi"):
        per = 3 if "mom" in op else 2
        arrays = [r.standard_normal((2, 3)).astype(np.float32)
                  for _ in range(2 * per)]
        kw = {"lrs": [0.1, 0.05], "wds": [0.01, 0.0], "rescale_grad": 0.5,
              "clip_gradient": 0.6, "num_weights": 2}
    else:
        arrays = arrays[:3 if "mom" in op else 2]
        kw = dict(_HYPER)
    if "mom" in op:
        kw["momentum"] = 0.9
    jout = getattr(jmx.nd, op)(*[jmx.nd.array(a) for a in arrays], **kw)
    tout = getattr(tmx.nd, op)(*[tmx.nd.array(a, ctx=tmx.cpu())
                                 for a in arrays], **kw)
    as_list = lambda o: o if isinstance(o, (list, tuple)) else [o]  # noqa
    assert len(as_list(jout)) == len(as_list(tout))
    for j, t in zip(as_list(jout), as_list(tout)):
        _close(t, j)


# --------------------------------------------------------------------------
# Trainer over whole steps
# --------------------------------------------------------------------------

def _xavier(seed):
    """A Xavier initializer with its own generator: the weights do not
    depend on what else ran in the process."""
    return tmx.init.Xavier(generator=torch.Generator().manual_seed(seed))


def _same_state(port, ref):
    """{name: array} states equal within TOL of the largest magnitude in
    the state (a gradient that is zero in exact arithmetic, like a Dense
    bias followed by BatchNorm, leaves rounding noise in its momentum)."""
    assert port.keys() == ref.keys()
    scale = max(float(np.abs(a).max()) for a in ref.values())
    for k in ref:
        np.testing.assert_allclose(port[k], ref[k], rtol=TOL,
                                   atol=TOL * scale, err_msg=k)


def _weights(net):
    return {k: _np(p.data()) for k, p in
            net._collect_params_with_prefix().items()}


def _load(net, arrays, mx):
    """The same weights into a net of either package."""
    if mx is tmx:
        load_jax_params(net, arrays, ctx=tmx.cpu())
        return
    for k, p in net._collect_params_with_prefix().items():
        p.set_data(jmx.nd.array(arrays[k]))


def _train(mx, net, x, y, steps, optimizer, opt_params, batch):
    """``steps`` record/backward/Trainer.step steps; returns the per-step
    losses, the trainer and the momentum states by structured name."""
    ctx = tmx.cpu() if mx is tmx else None
    loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = mx.gluon.Trainer(net.collect_params(), optimizer,
                               dict(opt_params))
    losses = []
    for _ in range(steps):
        with mx.autograd.record():
            L = loss(net(mx.nd.array(x, ctx=ctx)), mx.nd.array(y, ctx=ctx))
        L.backward()
        trainer.step(batch)
        losses.append(_np(L))
    index = {id(p): i for i, p in enumerate(trainer._params)}
    states = trainer._updaters[0].states
    moms = {k: _np(states[index[id(p)]])
            for k, p in net._collect_params_with_prefix().items()
            if id(p) in index and states.get(index[id(p)]) is not None}
    return losses, trainer, moms


def _mlp(mx):
    nn = mx.gluon.nn
    net = nn.HybridSequential()
    net.add(nn.Dense(8, in_units=6), nn.BatchNorm(in_channels=8),
            nn.Activation("relu"), nn.Dense(4, in_units=8))
    return net


@functools.lru_cache(maxsize=None)
def _mlp_data():
    r = np.random.RandomState(2)
    net = _mlp(tmx)
    net.initialize(_xavier(2), ctx=tmx.cpu())
    return ({k: _np(p.data())
             for k, p in net._collect_params_with_prefix().items()},
            r.standard_normal((8, 6)).astype(np.float32),
            r.randint(0, 4, 8).astype(np.float32))


@pytest.mark.parametrize("optimizer", ["sgd", "nag"])
@pytest.mark.parametrize("agg", ["1", "4", "bulk2"])
def test_trainer_mlp_and_dispatches(monkeypatch, optimizer, agg):
    """Two steps of an MLP with SGD or NAG momentum and weight decay: the
    same losses, weights, momenta and running statistics (1e-5), and the
    same number of update dispatches per step, with
    MXNET_OPTIMIZER_AGGREGATION_SIZE 1 and 4 and under engine.bulk(2)."""
    arrays, x, y = _mlp_data()
    monkeypatch.setenv("MXNET_OPTIMIZER_AGGREGATION_SIZE",
                       agg if agg != "bulk2" else "4")
    opt = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}
    runs = []
    for mx in (jmx, tmx):
        net = _mlp(mx)
        _load(net, arrays, mx)
        bulk = 2 if agg == "bulk2" else 0
        with mx.engine.bulk(bulk):
            losses, trainer, moms = _train(mx, net, x, y, 2, optimizer, opt,
                                           8)
        runs.append((losses, _weights(net), moms,
                     trainer._last_step_dispatches))
    (jl, jw, jm, jd), (tl, tw, tm, td) = runs
    assert td == jd
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
    assert tw.keys() == jw.keys() and tm.keys() == jm.keys()
    _same_state(tw, jw)
    _same_state(tm, jm)


def _bottleneck(mx, vision):
    nn = mx.gluon.nn
    net = nn.HybridSequential()
    net.add(vision.BottleneckV1(16, 2, downsample=True, in_channels=8),
            nn.GlobalAvgPool2D(), nn.Flatten(), nn.Dense(10, in_units=16))
    return net


@functools.lru_cache(maxsize=None)
def _bottleneck_data():
    r = np.random.RandomState(3)
    x = r.standard_normal((4, 8, 8, 8)).astype(np.float32)
    net = _bottleneck(tmx, tvision)
    net.initialize(_xavier(3), ctx=tmx.cpu())
    net(tmx.nd.array(x, ctx=tmx.cpu()))
    return _weights(net), x, r.randint(0, 10, 4).astype(np.float32)


_OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}


@functools.lru_cache(maxsize=None)
def _jax_bottleneck_run(fused):
    arrays, x, y = _bottleneck_data()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MXTPU_FUSED_BLOCK", fused)
        net = _bottleneck(jmx, jvision)
        _load(net, arrays, jmx)
        losses, _, moms = _train(jmx, net, x, y, 2, "sgd", _OPT, 4)
    return losses, _weights(net), moms


@pytest.mark.parametrize("fused", ["1", "0"])
@pytest.mark.parametrize("knob", ["0", "1"])
def test_trainer_bottleneck(monkeypatch, fused, knob):
    """Two SGD-momentum steps of a narrow BottleneckV1 net (projection
    shortcut, stride 2, BatchNorm in training): losses, weights, momenta
    and running statistics within 1e-5 of the JAX package, with the fused
    residual blocks on and off and the conv3x3 route off and on."""
    jl, jw, jm = _jax_bottleneck_run(fused)
    arrays, x, y = _bottleneck_data()
    monkeypatch.setenv("MXTPU_FUSED_BLOCK", fused)
    monkeypatch.setenv("MXTPU_FUSED_CONV_BWD", knob)
    net = _bottleneck(tmx, tvision)
    _load(net, arrays, tmx)
    tl, _, tm = _train(tmx, net, x, y, 2, "sgd", _OPT, 4)
    tw = _weights(net)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
    _same_state(tw, jw)
    _same_state(tm, jm)


def _rel_l2(a, b):
    num = sum(float(np.sum((a[k] - b[k]).astype(np.float64) ** 2))
              for k in a)
    den = sum(float(np.sum(b[k].astype(np.float64) ** 2)) for k in a)
    return (num / den) ** 0.5


def test_resnet50_v1_training(monkeypatch):
    """resnet50_v1(classes=10), fused blocks on, batch 2 at 3x64x64, two
    SGD-momentum steps against the JAX package (tolerances in the module
    docstring), with the port's 3x3 convs through the conv3x3 Function
    (the knob-off route is the BottleneckV1 cases')."""
    monkeypatch.setenv("MXTPU_FUSED_BLOCK", "1")
    r = np.random.RandomState(4)
    x = r.standard_normal((2, 3, 64, 64)).astype(np.float32)
    y = np.array([3.0, 7.0], np.float32)
    opt = {"learning_rate": 0.01, "momentum": 0.9}
    net = tvision.resnet50_v1(classes=10)
    net.initialize(_xavier(4), ctx=tmx.cpu())
    net(tmx.nd.array(x, ctx=tmx.cpu()))
    w0 = _weights(net)
    jnet = jvision.resnet50_v1(classes=10)
    _load(jnet, w0, jmx)
    jl, _, jm = _train(jmx, jnet, x, y, 2, "sgd", opt, 2)
    jw = _weights(jnet)
    j_upd = {k: jw[k] - w0[k] for k in w0}
    monkeypatch.setenv("MXTPU_FUSED_CONV_BWD", "1")
    net = tvision.resnet50_v1(classes=10)
    _load(net, w0, tmx)
    tl, _, tm = _train(tmx, net, x, y, 2, "sgd", opt, 2)
    tw = _weights(net)
    np.testing.assert_allclose(tl[0], jl[0], rtol=2e-4, atol=2e-4)
    assert all(np.isfinite(v).all() for v in tl)
    t_upd = {k: tw[k] - w0[k] for k in w0}
    assert _rel_l2(t_upd, j_upd) <= 0.25
    assert _rel_l2(tm, jm) <= 0.5
    for k in w0:
        a, b = t_upd[k].ravel(), j_upd[k].ravel()
        cos = float(a @ b) / (np.linalg.norm(a) * np.linalg.norm(b))
        assert cos >= 0.5, (k, cos)
