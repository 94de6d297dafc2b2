"""The fused 3x3 conv backward of the port
(``incubator_mxnet_tpu_torch/parallel/conv_backward.py``) against the JAX
package's, on identical numpy inputs, on the CPU.

The port's twin ``conv3x3_bwd_reference`` is what the CUDA kernel is held
to on the card (chip_smoke.py); here it is held to the JAX package's Pallas
kernel ``conv3x3_bwd_fused`` in interpret mode, in both of its
formulations (MXTPU_CONV_BWD_KERNEL patch and taps, run as
tests/test_conv_backward.py runs them), and to the XLA conv vjp.
Tolerances, relative to max|reference|:
* fp32: 1e-5. The twin sums in float64 and rounds once; the JAX kernels
  sum in fp32 over at most 9*16 (dx) or 2*8*8 (dW) products.
* bf16: 1e-2, one bf16 rounding (2^-8) of the same sums.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from incubator_mxnet_tpu.parallel import conv_backward as jcb
from incubator_mxnet_tpu_torch import tune
from incubator_mxnet_tpu_torch.parallel import conv_backward as tcb

_TOL = {"float32": 1e-5, "bfloat16": 1e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(seed, n, c, h, dtype):
    r = np.random.RandomState(seed)
    x = r.standard_normal((n, c, h, h)).astype(np.float32)
    w = (r.standard_normal((c, c, 3, 3)) * 0.1).astype(np.float32)
    go = r.standard_normal((n, c, h, h)).astype(np.float32)
    jargs = tuple(jnp.asarray(a, dtype) for a in (x, w, go))
    targs = tuple(torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in (x, w, go))
    return jargs, targs


def _close(port, ref, dtype):
    port = port.float().numpy()
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape
    tol = _TOL[dtype]
    np.testing.assert_allclose(port, ref, rtol=tol,
                               atol=tol * float(np.abs(ref).max()))


@pytest.mark.parametrize("mode", ["patch", "taps"])
@pytest.mark.parametrize("c,h,dtype", [(8, 7, "float32"),
                                       (16, 8, "bfloat16")])
def test_twin_matches_pallas_kernel(monkeypatch, mode, c, h, dtype):
    monkeypatch.setenv("MXTPU_CONV_BWD_KERNEL", mode)
    jargs, targs = _inputs(0, 2, c, h, dtype)
    jdx, jdw = jcb.conv3x3_bwd_fused(*jargs)
    dx, dw = tcb.conv3x3_bwd_reference(*targs)
    assert dx.dtype == dw.dtype == getattr(torch, dtype)
    _close(dx, jdx, dtype)
    _close(dw, jdw, dtype)


@pytest.mark.parametrize("c,h", [(8, 8), (16, 7)])
def test_twin_matches_xla_vjp(c, h):
    jargs, targs = _inputs(1, 2, c, h, "float32")
    _, vjp = jax.vjp(jcb._conv3x3_fwd_impl, *jargs[:2])
    jdx, jdw = vjp(jargs[2])
    dx, dw = tcb.conv3x3_bwd_reference(*targs)
    _close(dx, jdx, "float32")
    _close(dw, jdw, "float32")


_GEOMETRIES = [
    ((3, 3), (1, 1), (1, 1), (1, 1), 1),     # eligible
    ((3, 3), (2, 2), (1, 1), (1, 1), 1),     # stride 2
    ((1, 1), (1, 1), (1, 1), (0, 0), 1),     # 1x1
    ((3, 3), (1, 1), (2, 2), (2, 2), 1),     # dilated
    ((3, 3), (1, 1), (1, 1), (1, 1), 2),     # grouped
]


@pytest.mark.parametrize("knob", ["1", "0", None])
def test_fused_eligible_matches_jax(monkeypatch, knob):
    if knob is None:
        monkeypatch.delenv("MXTPU_FUSED_CONV_BWD", raising=False)
    else:
        monkeypatch.setenv("MXTPU_FUSED_CONV_BWD", knob)
    for kernel, stride, dilate, pad, groups in _GEOMETRIES:
        for shape in ((8, 64, 56, 56), (8, 64, 56)):
            args = (shape, (64, 64) + kernel, kernel, stride, dilate, pad,
                    groups)
            assert tcb.fused_eligible(*args) == jcb.fused_eligible(*args)
    assert tcb.fused_eligible(*(((8, 64, 56, 56), (64, 64, 3, 3))
                                + _GEOMETRIES[0])) == (knob == "1")


def test_conv3x3_function_gradcheck():
    """The conv3x3 Function (forward F.conv2d, backward the twin on the
    CPU) passes torch.autograd.gradcheck in float64."""
    r = np.random.RandomState(2)
    x = torch.from_numpy(r.standard_normal((2, 3, 5, 5))).requires_grad_()
    w = torch.from_numpy(r.standard_normal((4, 3, 3, 3))).requires_grad_()
    assert torch.autograd.gradcheck(tcb.conv3x3_custom, (x, w))


def test_conv3x3_function_matches_plain_autograd_without_launching():
    """Through the tuned entry, the Function's gradients equal the autograd
    of the plain conv (1e-5: the twin sums in float64, PyTorch's CPU
    backward in fp32), and the CPU path launches nothing."""
    _, (x, w, go) = _inputs(3, 2, 8, 6, "float32")
    before = tcb.conv3x3.launches
    grads = []
    for fn in (tune.kernels()["conv3x3"], tcb.conv3x3_plain):
        xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
        out = fn(xl, wl)
        out.backward(go)
        grads.append((out.detach(), xl.grad, wl.grad))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(b.abs().max()))
    assert tcb.conv3x3.launches == before
