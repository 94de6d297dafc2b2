"""The Transformer LM of the port
(``incubator_mxnet_tpu_torch/models/transformer.py``) against the JAX
package's, on identical parameters and tokens, on the CPU.

Parameters come from the JAX package's ``init_params`` and cross through
``convert.transformer_params_from_numpy`` (bfloat16 exactly). The JAX side
runs its Pallas flash kernels in interpret mode and its train step on a
one-device mesh (tier-1 forces 8 CPU devices). Each (dtype, flash) pair is
computed once on the JAX side and held against the port with remat on and
off (remat changes no value on either side).

Tolerances, measured worst case in brackets:
* float32: logits 1e-5 of max|logit| [8.8e-7]; loss 1e-5 relative
  [7.9e-8]; each parameter's gradient 2e-5 of its max|grad| [1.4e-6];
  3 Adam steps: losses 1e-5 relative [7.9e-8], parameters after the steps
  within 5e-4 (relative L2 of the difference over the update) [2.5e-5].
* bfloat16: logits 3e-2 [8.7e-3]; loss 2e-3 [1.8e-4]; gradients 8e-2
  [2.7e-2]; Adam losses 5e-3 [5.9e-4], parameters 0.25 [0.067]. The two
  frameworks round bf16 at other places (LayerNorm's affine, GELU, the
  embedding's scatter-add), and each bf16 rounding is 2^-8 relative; the
  Adam update of a bf16 weight is a few bf16 ulps, so the cast back after
  each step moves updates by tens of percent where the two sides round a
  weight the other way.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from incubator_mxnet_tpu.base import MXNetError as JMXNetError
from incubator_mxnet_tpu.models.transformer import (
    TransformerConfig as JConfig, TransformerLM as JLM)
from incubator_mxnet_tpu.parallel.mesh import make_mesh as jmake_mesh
from incubator_mxnet_tpu.parallel.train import \
    _make_update_rule as jupdate_rule
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import convert
from incubator_mxnet_tpu_torch.models import TransformerConfig, TransformerLM
from incubator_mxnet_tpu_torch.parallel import make_mesh
from incubator_mxnet_tpu_torch.parallel.mesh import local_mesh_axis_sizes
from incubator_mxnet_tpu_torch.parallel.train import _make_update_rule

_SMALL = dict(vocab_size=256, d_model=128, n_heads=4, n_layers=2, d_ff=512,
              max_len=64)
_STEPS = 3
_TOL = {"float32": dict(logits=1e-5, loss=1e-5, grad=2e-5, traj=1e-5,
                        update=5e-4),
        "bfloat16": dict(logits=3e-2, loss=2e-3, grad=8e-2, traj=5e-3,
                         update=0.25)}
_CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _batch():
    tok = np.random.RandomState(0).randint(0, 256, (2, 64)).astype(np.int32)
    return tok, np.roll(tok, -1, axis=1)


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@functools.lru_cache(maxsize=None)
def _jax_run(dtype, flash):
    """Parameters, logits, loss, gradients and a 3-step Adam trajectory of
    the JAX package's TransformerLM (all as numpy)."""
    model = JLM(JConfig(dtype=dtype, flash_attention=flash, remat=True,
                        **_SMALL))
    params = model.init_params(jax.random.PRNGKey(0))
    tok, tgt = (jnp.asarray(a) for a in _batch())
    logits = jax.jit(model.apply)(params, tok)
    loss, grads = jax.jit(jax.value_and_grad(model.loss))(params, tok, tgt)
    mesh = jmake_mesh({"dp": 1}, devices=jax.devices()[:1])
    step, shard, init_opt = model.make_train_step(mesh, use_sp=False)
    # the step donates its inputs: hand it copies
    p = shard({k: jnp.array(v) for k, v in params.items()})
    o = init_opt(p)
    losses = []
    for i in range(_STEPS):
        p, o, l = step(p, o, tok, tgt, i)
        losses.append(float(l))
    return ({k: np.asarray(v) for k, v in params.items()}, _f32(logits),
            float(loss), {k: _f32(g) for k, g in grads.items()}, losses,
            {k: _f32(v) for k, v in p.items()})


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("flash", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_transformer_matches_jax(dtype, flash, remat):
    jparams, jlogits, jloss, jgrads, jlosses, jfinal = _jax_run(dtype, flash)
    tol = _TOL[dtype]
    model = TransformerLM(TransformerConfig(dtype=dtype, flash_attention=flash,
                                            remat=remat, **_SMALL))
    params = convert.transformer_params_from_numpy(jparams, _CPU)
    assert set(params) == set(model._param_names())
    tok, tgt = _batch()

    logits = model.apply(params, torch.from_numpy(tok)).numpy()
    assert logits.dtype == np.float32 and logits.shape == jlogits.shape
    np.testing.assert_allclose(logits, jlogits, rtol=0,
                               atol=tol["logits"] * np.abs(jlogits).max())

    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss = model.loss(leaves, torch.from_numpy(tok), torch.from_numpy(tgt))
    loss.backward()
    assert abs(float(loss.detach()) - jloss) <= tol["loss"] * abs(jloss)
    for k, leaf in leaves.items():
        g = leaf.grad.float().numpy()
        np.testing.assert_allclose(
            g, jgrads[k], rtol=0, atol=tol["grad"] * np.abs(jgrads[k]).max(),
            err_msg=k)

    mesh = make_mesh({"dp": 1}, devices=[_CPU])
    step, shard, init_opt = model.make_train_step(mesh, use_sp=False)
    p = shard(params)
    o = init_opt(p)
    losses = []
    for i in range(_STEPS):
        p, o, l = step(p, o, tok, tgt, i)
        losses.append(float(l))
    np.testing.assert_allclose(losses, jlosses, rtol=tol["traj"])
    num = sum(float(((p[k].float().numpy() - jfinal[k]) ** 2).sum())
              for k in p)
    den = sum(float(((jfinal[k] - jparams[k].astype(np.float32)) ** 2).sum())
              for k in p)
    assert np.sqrt(num / den) <= tol["update"]
    assert all(p[k].dtype == params[k].dtype for k in p)
    assert all(o[k][0].dtype == torch.float32 for k in o)


def test_n_steps_matches_single_steps():
    """make_train_step(n_steps=3) returns what 3 single steps return."""
    model = TransformerLM(TransformerConfig(dtype="float32", **_SMALL))
    mesh = make_mesh({"dp": 1}, devices=[_CPU])
    params = model.init_params(torch.Generator().manual_seed(1), device=_CPU)
    tok, tgt = _batch()
    step, shard, init_opt = model.make_train_step(mesh, use_sp=False)
    p, o = shard(params), init_opt(params)
    for i in range(3):
        p, o, loss = step(p, o, tok, tgt, 5 + i)
    multi, shard_m, init_m = model.make_train_step(mesh, use_sp=False,
                                                   n_steps=3)
    pm, om, loss_m = multi(shard_m(params), init_m(params), tok, tgt, 5)
    assert float(loss_m) == float(loss)
    for k in p:
        assert torch.equal(p[k], pm[k]), k
        assert torch.equal(o[k][1], om[k][1]), k
    # the inputs were not modified
    assert all(torch.equal(shard(params)[k], params[k]) for k in params)


def test_init_params_shapes_and_distribution():
    cfg = TransformerConfig(**dict(_SMALL, dtype="bfloat16"))
    model = TransformerLM(cfg)
    params = model.init_params(torch.Generator().manual_seed(0), device=_CPU)
    jparams = JLM(JConfig(**dict(_SMALL, dtype="bfloat16"))).init_params(
        jax.random.PRNGKey(0))
    assert list(params) == list(jparams)
    for k, v in params.items():
        assert tuple(v.shape) == tuple(jparams[k].shape), k
        assert v.dtype == torch.bfloat16
    # N(0, 1) / sqrt(fan_in): w_out has fan_in d_ff
    std = float(params["layer0_w_out"].float().std())
    assert abs(std - 1 / np.sqrt(_SMALL["d_ff"])) < 0.05 / np.sqrt(
        _SMALL["d_ff"])
    assert torch.equal(params["lnf_g"], torch.ones(128, dtype=torch.bfloat16))


def test_params_cross_exactly_in_bf16():
    jparams = JLM(JConfig(**dict(_SMALL, dtype="bfloat16"))).init_params(
        jax.random.PRNGKey(3))
    arrays = {k: np.asarray(v) for k, v in jparams.items()}
    params = convert.transformer_params_from_numpy(arrays, _CPU)
    back = convert.transformer_params_to_numpy(params)
    for k, a in arrays.items():
        assert params[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(back[k], a.astype(np.float32))


@pytest.mark.parametrize("kw", [
    dict(rescale_grad=1.0, clip_gradient=-1.0, wd=0.0),
    dict(rescale_grad=0.5, clip_gradient=0.3, wd=1e-2, beta1=0.8,
         beta2=0.99, epsilon=1e-6),
])
def test_adam_rule_matches_jax(kw):
    """TrainStep's adam rule vs the JAX package's, 3 steps, float32:
    1e-6 relative (the bias correction is float32 on both sides)."""
    kw = dict(kw)
    wd = kw.pop("wd")
    r = np.random.RandomState(0)
    w = r.standard_normal((64,)).astype(np.float32)
    grads = [r.standard_normal((64,)).astype(np.float32) for _ in range(3)]
    jinit, jupd = jupdate_rule("adam", 1e-2, 0.0, wd, dict(kw))
    tinit, tupd = _make_update_rule("adam", 1e-2, 0.0, wd, dict(kw))
    jw, jst = jnp.asarray(w), jinit(jnp.asarray(w))
    tw, tst = torch.from_numpy(w), tinit(torch.from_numpy(w))
    for t, g in enumerate(grads, start=1):
        jw, jst = jupd(jw, jnp.asarray(g), jst, t)
        tw, tst = tupd(tw, torch.from_numpy(g), tst, t)
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                                   atol=1e-7)
        for a, b in zip(tst, jst):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)


def test_what_is_not_ported_raises():
    model = TransformerLM(TransformerConfig(**_SMALL))
    cpu = [_CPU]
    with pytest.raises(tmx.MXNetError, match="not ported"):
        model.make_train_step(make_mesh({"dp": 1, "sp": 1}, devices=cpu))
    with pytest.raises(tmx.MXNetError, match="not ported"):
        model.make_train_step(make_mesh({"tp": 1}, devices=cpu),
                              use_sp=False)
    with pytest.raises(tmx.MXNetError, match="not ported"):
        model.make_train_step(make_mesh({"dp": 2}, devices=cpu * 2),
                              use_sp=False)
    named = TransformerLM(TransformerConfig(remat_policy="dots", **_SMALL))
    params = named.init_params(torch.Generator().manual_seed(0), device=_CPU)
    with pytest.raises(tmx.MXNetError, match="not ported"):
        named.apply(params, torch.zeros((1, 8), dtype=torch.int32))
    with pytest.raises(tmx.MXNetError, match="not ported"):
        model.param_sharding(None)


def test_make_mesh():
    mesh = make_mesh({"dp": 1})
    assert mesh.devices == (torch.device("cuda", 0),)
    assert local_mesh_axis_sizes(mesh) == {"dp": 1}
    mesh = make_mesh({"dp": -1, "tp": 2}, devices=[_CPU] * 4)
    assert mesh.shape == {"dp": 2, "tp": 2} and mesh.size == 4
    with pytest.raises(tmx.MXNetError, match="needs 4 devices, have 2"):
        make_mesh({"dp": 4}, devices=[_CPU] * 2)
    with pytest.raises(JMXNetError, match="needs 4 devices, have 2"):
        jmake_mesh({"dp": 4}, devices=jax.devices()[:2])
