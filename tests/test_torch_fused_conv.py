"""The port's plain twins in ``incubator_mxnet_tpu_torch/parallel/fused_conv.py``
against the JAX package's references and its Pallas kernels (interpret mode,
as tests/test_tune.py runs them), on identical numpy inputs.

The twins are what the CUDA kernels are held to on the card (chip_smoke.py),
so this file closes the chain kernel -> twin -> JAX reference -> Pallas.
Tolerances:
* fp32 epilogue vs the JAX reference: 1e-6 (both round the multiply and
  the add separately; XLA may contract them, a 1-ulp difference);
* fp32 conv: 1e-5 (XLA's and PyTorch's CPU convolutions sum in different
  orders; K <= 64 here);
* vs Pallas candidates: the bounds tests/test_tune.py uses (2e-6 epilogue,
  5e-5 conv);
* bf16: 3e-2, one bf16 ulp at these magnitudes (a 1-ulp fp32 difference
  can flip a bf16 rounding).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from incubator_mxnet_tpu.parallel import fused_conv as jfc
from incubator_mxnet_tpu_torch import tune
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.parallel import conv_backward  # noqa: F401
from incubator_mxnet_tpu_torch.parallel import fused_conv as tfc

_EPI_TOL = {"float32": 1e-6, "bfloat16": 3e-2}
_EPI_PALLAS_TOL = {"float32": 2e-6, "bfloat16": 3e-2}
_CONV_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
_CONV_PALLAS_TOL = {"float32": 5e-5, "bfloat16": 3e-2}

# (k, pad_lo, pad_hi): 1x1, 3x3 p1, and the 4x4 pad-(2,1) geometry of the
# JAX package's space-to-depth stem
_GEOMETRIES = [(1, (0, 0), (0, 0)), (3, (1, 1), (1, 1)),
               (4, (2, 2), (1, 1))]


def _both(a, dtype):
    return jnp.asarray(a, dtype), torch.from_numpy(a).to(getattr(torch, dtype))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _epi_inputs(seed, dtype, residual):
    r = np.random.RandomState(seed)
    shape = (2, 8, 4, 4)
    z = r.standard_normal(shape).astype(np.float32)
    s = (r.rand(8) + 0.5).astype(np.float32)
    b = (r.standard_normal(8) * 0.3).astype(np.float32)
    res = r.standard_normal(shape).astype(np.float32) if residual else None
    jz, tz = _both(z, dtype)
    js, ts = _both(s, "float32")
    jb, tb = _both(b, "float32")
    jr, tr = _both(res, dtype) if residual else (None, None)
    return (jz, js, jb, jr), (tz, ts, tb, tr)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("relu", [False, True])
def test_bn_act_twin_matches_jax_reference(dtype, residual, relu):
    (jz, js, jb, jr), (tz, ts, tb, tr) = _epi_inputs(4, dtype, residual)
    ref = jfc.bn_act_reference(jz, js, jb, jr, relu=relu)
    out = tfc.bn_act_reference(tz, ts, tb, tr, relu=relu)
    assert out.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=_EPI_TOL[dtype],
                               atol=_EPI_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("relu", [False, True])
def test_bn_act_twin_matches_pallas_candidates(monkeypatch, dtype, residual,
                                               relu):
    monkeypatch.setenv("MXTPU_TUNE_INTERPRET", "1")
    (jz, js, jb, jr), (tz, ts, tb, tr) = _epi_inputs(5, dtype, residual)
    out = tfc.bn_act_reference(tz, ts, tb, tr, relu=relu)
    args = (jz, js, jb, jr) if residual else (jz, js, jb)
    cands = jfc.bn_act_candidates(relu, residual)(args, {})
    assert cands, "interpret-mode candidates must be offered under the env"
    for name, fn in cands.items():
        np.testing.assert_allclose(
            _np(out), _np(fn(*args)), rtol=_EPI_PALLAS_TOL[dtype],
            atol=_EPI_PALLAS_TOL[dtype], err_msg=name)


def _conv_inputs(seed, dtype, k):
    r = np.random.RandomState(seed)
    x = r.standard_normal((2, 4, 6, 6)).astype(np.float32)
    w = (r.standard_normal((8, 4, k, k)) / (2 * k)).astype(np.float32)
    s = (r.rand(8) + 0.5).astype(np.float32)
    b = (r.standard_normal(8) * 0.3).astype(np.float32)
    pairs = [_both(x, dtype), _both(w, dtype), _both(s, "float32"),
             _both(b, "float32")]
    return tuple(p[0] for p in pairs), tuple(p[1] for p in pairs)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,pad_lo,pad_hi", _GEOMETRIES)
def test_conv_bn_relu_twin_matches_jax_reference(dtype, k, pad_lo, pad_hi):
    jargs, targs = _conv_inputs(6, dtype, k)
    ref = jfc.conv_bn_relu_reference(*jargs, k, pad_lo, pad_hi)
    out = tfc.conv_bn_relu_reference(*targs, k, pad_lo, pad_hi)
    assert tuple(out.shape) == tuple(ref.shape) == (2, 8, 6, 6)
    assert out.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=_CONV_TOL[dtype],
                               atol=_CONV_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,pad_lo,pad_hi", _GEOMETRIES)
def test_conv_bn_relu_twin_matches_pallas_candidates(monkeypatch, dtype, k,
                                                     pad_lo, pad_hi):
    monkeypatch.setenv("MXTPU_TUNE_INTERPRET", "1")
    jargs, targs = _conv_inputs(7, dtype, k)
    kw = {"k": k, "pad_lo": pad_lo, "pad_hi": pad_hi}
    out = tfc.conv_bn_relu_reference(*targs, **kw)
    cands = jfc.conv_bn_relu_candidates(jargs, kw)
    assert {n.split("_")[1] for n in cands} == {"patch", "taps"}
    for name, fn in cands.items():
        np.testing.assert_allclose(
            _np(out), _np(fn(*jargs, **kw)), rtol=_CONV_PALLAS_TOL[dtype],
            atol=_CONV_PALLAS_TOL[dtype], err_msg=name)


def test_wrappers_run_twins_on_cpu_without_launching():
    _, (tz, ts, tb, tr) = _epi_inputs(8, "float32", True)
    before = {k: v.launches for k, v in tune.kernels().items()}
    out = tfc.bn_add_act(tz, ts, tb, tr)
    np.testing.assert_array_equal(
        out.numpy(), tfc.bn_act_reference(tz, ts, tb, tr).numpy())
    via_tune = tune.tuned_call("bn_apply", tfc.bn_apply.plain, tz, ts, tb)
    np.testing.assert_array_equal(
        via_tune.numpy(), tfc.bn_act_reference(tz, ts, tb, relu=False).numpy())
    assert {k: v.launches for k, v in tune.kernels().items()} == before
    assert set(before) == {"conv_bn_relu", "bn_act", "bn_add_act",
                           "bn_apply", "conv3x3", "fa_fwd", "fa_bwd_dq",
                           "fa_bwd_dkv"}


@pytest.mark.parametrize("name", ["conv_bn_relu", "bn_act", "bn_add_act",
                                  "bn_apply"])
def test_wrappers_raise_off_cpu_instead_of_falling_back(name):
    """A tensor that is not on the CPU goes to the kernel, never the twin:
    here (no CUDA) the wrapper and tuned_call both refuse a meta tensor."""
    z = torch.empty((2, 8, 4, 4), device="meta")
    s = torch.empty((8,), device="meta")
    args = {"conv_bn_relu": (z, torch.empty((8, 8, 3, 3), device="meta"),
                             s, s),
            "bn_add_act": (z, s, s, z)}.get(name, (z, s, s))
    kw = ({"k": 3, "pad_lo": (1, 1), "pad_hi": (1, 1)}
          if name == "conv_bn_relu" else {})
    kern = tune.kernels()[name]
    with pytest.raises(MXNetError, match="CUDA tensor"):
        kern(*args, **kw)
    with pytest.raises(MXNetError, match="CUDA tensor"):
        tune.tuned_call(name, kern.plain, *args, **kw)
    assert kern.launches == 0
