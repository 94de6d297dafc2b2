"""ResNet v1 in the port against the JAX package with the same weights,
carried across with ``convert.load_jax_params`` (as a numpy dict and as a
``.params`` file the JAX package wrote), in eval mode on the CPU, with the
fused residual blocks on and off on both sides.

Tolerance: max|port - jax| <= 1e-4 * max|jax| (plus 1e-4 relative per
element): convolution summation order differs between XLA and PyTorch and
compounds over 50 layers; BatchNorm statistics are non-trivial so the
folded scale/bias path is exercised.
"""
import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu.gluon.model_zoo import vision as jvision
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.convert import load_jax_params
from incubator_mxnet_tpu_torch.gluon.model_zoo import vision as tvision

REL_TOL = 1e-4

_BN_DRAW = {
    "gamma": lambda r, n: r.rand(n) * 0.4 + 0.8,
    "beta": lambda r, n: r.standard_normal(n) * 0.05,
    "running_mean": lambda r, n: r.standard_normal(n) * 0.05,
    "running_var": lambda r, n: r.rand(n) * 0.4 + 0.8,
}


def _jax_net(net, x, seed):
    """Initialize a JAX-package net, finish deferred init with one forward,
    give BatchNorm non-trivial statistics; return its weights as numpy."""
    net.initialize(jmx.init.Xavier())
    net(jmx.nd.array(x))
    r = np.random.RandomState(seed)
    arrays = {}
    for name, p in net._collect_params_with_prefix().items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in _BN_DRAW:
            p.set_data(jmx.nd.array(
                _BN_DRAW[leaf](r, p.shape[0]).astype(np.float32)))
        arrays[name] = np.asarray(p.data().asnumpy())
    return arrays


def _close(port, ref):
    assert port.shape == ref.shape and np.isfinite(port).all()
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(port, ref, rtol=REL_TOL, atol=REL_TOL * scale)


@pytest.mark.parametrize("fused", ["1", "0"])
@pytest.mark.parametrize("via_file", [False, True])
def test_bottleneck_v1_projection(monkeypatch, tmp_path, fused, via_file):
    monkeypatch.setenv("MXTPU_FUSED_BLOCK", fused)
    x = np.random.RandomState(0).standard_normal((2, 8, 8, 8)).astype(
        np.float32)
    jnet = jvision.BottleneckV1(16, 2, downsample=True, in_channels=8)
    arrays = _jax_net(jnet, x, seed=1)
    ref = np.asarray(jnet(jmx.nd.array(x)).asnumpy())

    tnet = tvision.BottleneckV1(16, 2, downsample=True, in_channels=8)
    if via_file:
        path = str(tmp_path / "unit.params")
        jnet.save_parameters(path)
        load_jax_params(tnet, path, ctx=tmx.cpu())
    else:
        load_jax_params(tnet, arrays, ctx=tmx.cpu())
    assert set(tnet._collect_params_with_prefix()) == set(arrays)
    out = tnet(tmx.nd.array(x, ctx=tmx.cpu())).asnumpy()
    assert out.shape == (2, 16, 4, 4)
    _close(out, ref)


@pytest.mark.parametrize("fused", ["1", "0"])
def test_resnet50_v1_logits(monkeypatch, fused):
    monkeypatch.setenv("MXTPU_FUSED_BLOCK", fused)
    x = np.random.RandomState(2).standard_normal((1, 3, 64, 64)).astype(
        np.float32)
    jnet = jvision.resnet50_v1(classes=10)
    arrays = _jax_net(jnet, x, seed=3)
    ref = np.asarray(jnet(jmx.nd.array(x)).asnumpy())

    tnet = tvision.resnet50_v1(classes=10)
    load_jax_params(tnet, arrays, ctx=tmx.cpu())
    with tmx.cpu():
        out = tnet(tmx.nd.array(x)).asnumpy()
    assert out.shape == (1, 10)
    _close(out, ref)


def test_port_init_is_seeded():
    """The port draws weights from an explicit generator: same seed, same
    weights; a different seed, different weights."""
    import torch

    def weights(seed):
        net = tvision.resnet18_v1(classes=4)
        net.initialize(tmx.init.Xavier(generator=torch.Generator()
                                       .manual_seed(seed)), ctx=tmx.cpu())
        net(tmx.nd.array(np.zeros((1, 3, 32, 32), np.float32),
                         ctx=tmx.cpu()))
        return {k: p.data().asnumpy()
                for k, p in net._collect_params_with_prefix().items()}

    a, b, c = weights(7), weights(7), weights(8)
    assert a.keys() == b.keys() == c.keys()
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["features.0.weight"], c["features.0.weight"])


def test_pretrained_raises():
    with pytest.raises(tmx.MXNetError, match="pretrained"):
        tvision.resnet50_v1(pretrained=True)
