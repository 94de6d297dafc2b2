"""The port's ``nd.*`` operators of the ResNet inference path against the
JAX package's, on identical numpy inputs, on the CPU (where the port runs
the kernels' plain twins and the JAX package its XLA compositions).

Tolerance: 1e-5 relative and absolute for fp32 — the convolutions and the
matmul sum in different orders in XLA and PyTorch, everything else is the
same elementwise arithmetic.
"""
import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx

TOL = 1e-5


def _run(op, arrays, **params):
    """Call op `op` of both packages on the same numpy arrays (None passes
    through); return the outputs as lists of float32 numpy arrays."""
    jargs = [None if a is None else jmx.nd.array(a) for a in arrays]
    targs = [None if a is None else tmx.nd.array(a, ctx=tmx.cpu())
             for a in arrays]
    jout = getattr(jmx.nd, op)(*jargs, **params)
    tout = getattr(tmx.nd, op)(*targs, **params)
    as_list = lambda o: o if isinstance(o, (list, tuple)) else [o]  # noqa: E731
    return ([np.asarray(o.asnumpy(), np.float32) for o in as_list(jout)],
            [o.asnumpy() for o in as_list(tout)])


def _assert_same(jouts, touts):
    assert len(jouts) == len(touts)
    for j, t in zip(jouts, touts):
        assert j.shape == t.shape
        np.testing.assert_allclose(t, j, rtol=TOL, atol=TOL)


def _bn_params(r, c):
    return [(r.rand(c) + 0.5).astype(np.float32),            # gamma
            (r.standard_normal(c) * 0.2).astype(np.float32),  # beta
            (r.standard_normal(c) * 0.2).astype(np.float32),  # running mean
            (r.rand(c) + 0.5).astype(np.float32)]             # running var


@pytest.mark.parametrize("kernel,stride,pad", [((7, 7), (2, 2), (3, 3)),
                                               ((1, 1), (2, 2), (0, 0)),
                                               ((3, 3), (1, 1), (1, 1))])
@pytest.mark.parametrize("with_bias", [False, True])
def test_convolution(kernel, stride, pad, with_bias):
    r = np.random.RandomState(0)
    x = r.standard_normal((2, 3, 12, 12)).astype(np.float32)
    w = (r.standard_normal((8, 3) + kernel) * 0.2).astype(np.float32)
    b = r.standard_normal(8).astype(np.float32) if with_bias else None
    _assert_same(*_run("Convolution", [x, w, b], kernel=kernel,
                       stride=stride, pad=pad, num_filter=8,
                       no_bias=not with_bias))


@pytest.mark.parametrize("fix_gamma", [False, True])
def test_batch_norm_inference(fix_gamma):
    r = np.random.RandomState(1)
    x = r.standard_normal((2, 6, 5, 5)).astype(np.float32)
    _assert_same(*_run("BatchNorm", [x] + _bn_params(r, 6), eps=1e-5,
                       fix_gamma=fix_gamma, training=False))


@pytest.mark.parametrize("kernel,stride,pad,residual", [
    ((1, 1), (1, 1), (0, 0), False),   # fused kernel, k=1
    ((3, 3), (1, 1), (1, 1), False),   # fused kernel, k=3
    ((1, 1), (2, 2), (0, 0), False),   # plain conv + bn_act epilogue
    ((1, 1), (1, 1), (0, 0), True),    # plain conv + bn_add_act epilogue
])
def test_fused_conv_bn_relu(kernel, stride, pad, residual):
    r = np.random.RandomState(2)
    x = r.standard_normal((2, 4, 8, 8)).astype(np.float32)
    w = (r.standard_normal((8, 4) + kernel) * 0.3).astype(np.float32)
    ho = 8 // stride[0]
    res = (r.standard_normal((2, 8, ho, ho)).astype(np.float32)
           if residual else None)
    arrays = [x, w] + _bn_params(r, 8) + ([res] if residual else [])
    _assert_same(*_run("FusedConvBNReLU", arrays, kernel=kernel,
                       stride=stride, pad=pad, num_filter=8, eps=1e-5,
                       fix_gamma=False, training=False))


@pytest.mark.parametrize("residual", [False, True])
def test_fused_bn_add_relu(residual):
    r = np.random.RandomState(3)
    x = r.standard_normal((2, 6, 5, 5)).astype(np.float32)
    res = r.standard_normal((2, 6, 5, 5)).astype(np.float32)
    arrays = [x] + _bn_params(r, 6) + ([res] if residual else [])
    _assert_same(*_run("FusedBNAddReLU", arrays, eps=1e-5, fix_gamma=False,
                       training=False))


@pytest.mark.parametrize("params", [
    {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1), "pool_type": "max"},
    {"kernel": (1, 1), "global_pool": True, "pool_type": "avg"},
    {"kernel": (2, 2), "stride": (2, 2), "pool_type": "avg"},
])
def test_pooling(params):
    x = np.random.RandomState(4).standard_normal((2, 3, 9, 9)).astype(
        np.float32)
    _assert_same(*_run("Pooling", [x], **params))


@pytest.mark.parametrize("with_bias", [False, True])
def test_fully_connected(with_bias):
    r = np.random.RandomState(5)
    x = r.standard_normal((4, 3, 2, 2)).astype(np.float32)
    w = r.standard_normal((10, 12)).astype(np.float32)
    b = r.standard_normal(10).astype(np.float32) if with_bias else None
    _assert_same(*_run("FullyConnected", [x, w, b], num_hidden=10,
                       no_bias=not with_bias))


@pytest.mark.parametrize("act_type", ["relu", "sigmoid", "tanh", "softrelu",
                                      "softsign"])
def test_activation(act_type):
    x = np.random.RandomState(6).standard_normal((3, 7)).astype(np.float32)
    _assert_same(*_run("Activation", [x], act_type=act_type))


def test_flatten_relu_and_arithmetic():
    r = np.random.RandomState(7)
    a = r.standard_normal((2, 3, 4)).astype(np.float32)
    b = r.standard_normal((2, 3, 4)).astype(np.float32)
    _assert_same(*_run("Flatten", [a]))
    _assert_same(*_run("relu", [a]))
    _assert_same(*_run("broadcast_add", [a, b]))
    ja, jb = jmx.nd.array(a), jmx.nd.array(b)
    ta, tb = tmx.nd.array(a, ctx=tmx.cpu()), tmx.nd.array(b, ctx=tmx.cpu())
    for jo, to in ((ja + jb, ta + tb), (ja - 1.5, ta - 1.5),
                   (2.0 * ja, 2.0 * ta), (ja / jb, ta / tb),
                   (ja.reshape((6, 4)), ta.reshape((6, 4))),
                   (ja.astype("bfloat16").astype("float32"),
                    ta.astype("bfloat16").astype("float32"))):
        np.testing.assert_allclose(to.asnumpy(), np.asarray(jo.asnumpy()),
                                   rtol=TOL, atol=TOL)
    assert ta.context == tmx.cpu() and ta.as_in_context(tmx.cpu()) is ta


# --------------------------------------------------------------------------
# training mode: batch statistics and gradients, against jax.vjp of the JAX
# package's ops (tolerance: the same 1e-5 -- batch statistics and their
# gradients are short fp32 sums in both packages)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def _one_thread():
    import torch
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _train_run(op, arrays, diff, **params):
    """Training-mode ``op`` of both packages on the same arrays: outputs
    (out, mean, var) and the gradients of out, at a random head gradient,
    with respect to the positions in ``diff``."""
    import jax
    import jax.numpy as jnp
    from incubator_mxnet_tpu.ops.registry import get_op as jget_op

    fn = jget_op(op).fn
    prim = [jnp.asarray(a) for a in arrays]

    def f(*d):
        args = list(prim)
        for i, v in zip(diff, d):
            args[i] = v
        return fn(*args, training=True, **params)

    jouts, vjp = jax.vjp(f, *[prim[i] for i in diff])
    hg = np.random.RandomState(11).standard_normal(
        jouts[0].shape).astype(np.float32)
    jgrads = vjp((jnp.asarray(hg), jnp.zeros_like(jouts[1]),
                  jnp.zeros_like(jouts[2])))
    targs = [tmx.nd.array(a, ctx=tmx.cpu()) for a in arrays]
    for i in diff:
        targs[i].attach_grad()
    with tmx.autograd.record():
        touts = getattr(tmx.nd, op)(*targs, training=True, **params)
    touts[0].backward(tmx.nd.array(hg, ctx=tmx.cpu()))
    return ([np.asarray(o, np.float32) for o in jouts]
            + [np.asarray(g, np.float32) for g in jgrads],
            [o.asnumpy() for o in touts]
            + [targs[i].grad.asnumpy() for i in diff])


@pytest.mark.parametrize("fix_gamma", [False, True])
def test_batch_norm_training(_one_thread, fix_gamma):
    r = np.random.RandomState(8)
    x = (r.standard_normal((3, 5, 4, 4)) * 2 + 3).astype(np.float32)
    _assert_same(*_train_run("BatchNorm", [x] + _bn_params(r, 5), (0, 1, 2),
                             eps=1e-5, fix_gamma=fix_gamma))


@pytest.mark.parametrize("residual", [False, True])
def test_fused_bn_add_relu_training(_one_thread, residual):
    r = np.random.RandomState(9)
    x = r.standard_normal((2, 6, 5, 5)).astype(np.float32)
    res = [r.standard_normal((2, 6, 5, 5)).astype(np.float32)] \
        if residual else []
    diff = (0, 1, 2, 5) if residual else (0, 1, 2)
    _assert_same(*_train_run("FusedBNAddReLU", [x] + _bn_params(r, 6) + res,
                             diff, eps=1e-5, fix_gamma=False))


@pytest.mark.parametrize("kernel,stride,pad,residual,global_stats,knob", [
    ((3, 3), (1, 1), (1, 1), False, False, "0"),
    ((3, 3), (1, 1), (1, 1), False, False, "1"),   # conv3x3 Function
    ((1, 1), (1, 1), (0, 0), True, False, "0"),
    ((1, 1), (2, 2), (0, 0), False, False, "0"),
    ((3, 3), (1, 1), (1, 1), False, True, "0"),    # conv_bn_relu Function
])
def test_fused_conv_bn_relu_training(_one_thread, monkeypatch, kernel, stride,
                                     pad, residual, global_stats, knob):
    monkeypatch.setenv("MXTPU_FUSED_CONV_BWD", knob)
    r = np.random.RandomState(10)
    x = r.standard_normal((2, 4, 6, 6)).astype(np.float32)
    w = (r.standard_normal((8, 4) + kernel) * 0.3).astype(np.float32)
    ho = 6 // stride[0]
    res = [r.standard_normal((2, 8, ho, ho)).astype(np.float32)] \
        if residual else []
    diff = (0, 1, 2, 3) + ((6,) if residual else ())
    _assert_same(*_train_run(
        "FusedConvBNReLU", [x, w] + _bn_params(r, 8) + res, diff,
        kernel=kernel, stride=stride, pad=pad, num_filter=8, eps=1e-5,
        fix_gamma=False, use_global_stats=global_stats))


def test_batch_norm_training_empty_batch(_one_thread):
    """A 0-size batch gives NaN statistics, not a crash, in both."""
    r = np.random.RandomState(12)
    x = np.zeros((0, 3, 2, 2), np.float32)
    arrays = [x] + _bn_params(r, 3)
    jout = jmx.nd.BatchNorm(*[jmx.nd.array(a) for a in arrays],
                            training=True)
    tout = tmx.nd.BatchNorm(*[tmx.nd.array(a, ctx=tmx.cpu())
                              for a in arrays], training=True)
    for j, t in zip(jout, tout):
        assert j.shape == t.shape
        np.testing.assert_array_equal(np.isnan(np.asarray(j.asnumpy())),
                                      np.isnan(t.asnumpy()))


@pytest.mark.parametrize("name", ["bn_apply", "bn_act", "bn_add_act",
                                  "conv_bn_relu"])
def test_kernel_functions_gradcheck(_one_thread, name):
    """Each hand kernel's autograd Function on the CPU (forward the twin,
    backward the twin's autograd from the saved inputs) passes
    torch.autograd.gradcheck in float64, without counting a launch."""
    import torch
    from incubator_mxnet_tpu_torch.parallel import fused_conv as fc

    r = np.random.RandomState(13)
    t = lambda *s: torch.from_numpy(r.standard_normal(s)).requires_grad_()
    kern = getattr(fc, name)
    before = kern.launches
    if name == "conv_bn_relu":
        args = (t(2, 3, 4, 4), t(4, 3, 3, 3), t(4), t(4))
        fn = lambda *a: kern(*a, k=3, pad_lo=(1, 1), pad_hi=(1, 1))  # noqa: E731
    else:
        args = (t(2, 3, 3, 3), t(3), t(3)) + (
            (t(2, 3, 3, 3),) if name == "bn_add_act" else ())
        fn = kern
    assert torch.autograd.gradcheck(fn, args)
    assert kern.launches == before
