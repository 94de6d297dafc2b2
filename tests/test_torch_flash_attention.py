"""Flash attention of the port
(``incubator_mxnet_tpu_torch/parallel/flash_attention.py``) against the
JAX package's, on identical numpy inputs, on the CPU.

The port's twins ``fa_fwd_plain``, ``fa_bwd_dq_plain`` and
``fa_bwd_dkv_plain`` are what the CUDA kernels are held to on the card
(chip_smoke.py); here they are held to the JAX package's Pallas kernel
functions ``_fa_forward`` and ``_fa_backward`` themselves, in interpret
mode (as tests/test_flash_attention.py runs them), at the same block
lengths (a small preferred block, so several blocks run). The public
``flash_attention`` is held to ``jax.vjp`` of the JAX one.
Tolerances, relative to max|reference| (lse absolute):
* float32: 2e-5 for out, dq, dk, dv; 2e-5 for lse. The same recurrence in
  float32, products summed in another order.
* bfloat16: 1e-2, about two bf16 roundings (2^-8 each) of the same values:
  the outputs are bf16, and the P and dS tiles are rounded to bf16 before
  their products on both sides, where one side may round the other way.
  lse 1e-4: it is float32 from the same bf16 products.
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from incubator_mxnet_tpu_torch import MXNetError, tune
from incubator_mxnet_tpu_torch.parallel.ring_attention import \
    attention_reference

# the packages' parallel/__init__ export the function under the module's
# name, so the modules are imported by path
jfa = importlib.import_module("incubator_mxnet_tpu.parallel.flash_attention")
tfa = importlib.import_module(
    "incubator_mxnet_tpu_torch.parallel.flash_attention")

_TOL = {"float32": 2e-5, "bfloat16": 1e-2}
_LSE_TOL = {"float32": 2e-5, "bfloat16": 1e-4}
_BLOCK = 32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _arrays(seed, shapes):
    r = np.random.RandomState(seed)
    return [r.standard_normal(s).astype(np.float32) for s in shapes]


def _both(arrays, dtype):
    jargs = [jnp.asarray(a, dtype) for a in arrays]
    targs = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return jargs, targs


def _close(port, ref, tol):
    port = port.detach().float().numpy()
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    assert port.shape == ref.shape, (port.shape, ref.shape)
    np.testing.assert_allclose(port, ref, rtol=tol,
                               atol=tol * float(np.abs(ref).max()))


# (BH, Tq, Tk, D, causal)
_KERNEL_CASES = [(4, 128, 128, 32, True), (4, 128, 128, 32, False),
                 (2, 64, 128, 64, False), (2, 256, 256, 16, True)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,tq,tk,d,causal", _KERNEL_CASES)
def test_twins_match_pallas_kernels(bh, tq, tk, d, causal, dtype):
    """fa_fwd / fa_bwd_dq / fa_bwd_dkv twins vs _fa_forward and
    _fa_backward, with a non-zero dlse in the backward."""
    sm = 1.0 / np.sqrt(d)
    q, k, v, do = _arrays(tq + d, [(bh, tq, d), (bh, tk, d), (bh, tk, d),
                                   (bh, tq, d)])
    dlse = (np.random.RandomState(7).standard_normal((bh, tq)) * 0.1) \
        .astype(np.float32)
    (jq, jk, jv, jdo), (tq_, tk_, tv, tdo) = _both([q, k, v, do], dtype)
    bq, bk = jfa._pick_block(tq, _BLOCK), jfa._pick_block(tk, _BLOCK)
    jout, jlse = jfa._fa_forward(jq, jk, jv, causal, sm, bq, bk, True)
    out, lse = tfa.fa_fwd_plain(tq_, tk_, tv, causal, sm, block=_BLOCK)
    _close(out, jout, _TOL[dtype])
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0],
                               rtol=0, atol=_LSE_TOL[dtype])

    # the backward from the JAX forward's out and lse, on both sides
    jdlse = jnp.asarray(dlse)[..., None]
    jdq, jdk, jdv = jfa._fa_backward(jq, jk, jv, jdo, jlse, jout, jdlse,
                                     causal, sm, bq, bk, True)
    tout = torch.from_numpy(np.array(jout.astype(jnp.float32))) \
        .to(getattr(torch, dtype))
    tlse = torch.from_numpy(np.asarray(jlse)[..., 0].copy())
    dq, delta = tfa.fa_bwd_dq_plain(tq_, tk_, tv, tdo, tlse, tout,
                                    torch.from_numpy(dlse), causal, sm,
                                    block=_BLOCK)
    ref_delta = (np.asarray(jdo.astype(jnp.float32))
                 * np.asarray(jout.astype(jnp.float32))).sum(-1) - dlse
    np.testing.assert_allclose(delta.numpy(), ref_delta, rtol=1e-5,
                               atol=1e-5 * np.abs(ref_delta).max())
    dk, dv = tfa.fa_bwd_dkv_plain(tk_, tv, tq_, tdo, tlse, delta, causal,
                                  sm, block=_BLOCK)
    for port, ref in ((dq, jdq), (dk, jdk), (dv, jdv)):
        _close(port, ref, _TOL[dtype])


def test_twins_run_the_default_blocks():
    """At the default preferred block (1024) a T = 2048 twin runs two
    blocks per axis; a T = 128 one runs one. Both agree with the dense
    reference (float32, 2e-5 of max|ref|)."""
    for t in (128, 2048):
        q, k, v = (torch.from_numpy(a) for a in
                   _arrays(t, [(1, t, 8), (1, t, 8), (1, t, 8)]))
        out, _ = tfa.fa_fwd_plain(q, k, v, True, 0.25)
        ref = attention_reference(q[:, :, None], k[:, :, None],
                                  v[:, :, None], causal=True,
                                  sm_scale=0.25)[:, :, 0]
        np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=2e-5,
                                   atol=2e-5 * float(ref.abs().max()))


# (B, Tq, Tk, H, D, causal)
_ENTRY_CASES = [(2, 64, 64, 2, 32, True), (1, 64, 128, 2, 32, False),
                (1, 100, 100, 2, 32, True)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,tq,tk,h,d,causal", _ENTRY_CASES)
def test_flash_attention_matches_jax_vjp(b, tq, tk, h, d, causal, dtype):
    """flash_attention forward and gradients vs jax.vjp of the JAX
    package's (T = 100 does not tile: both take attention_reference).
    The port's twins run at the JAX block sizes here, and no kernel is
    launched on the CPU."""
    q, k, v, g = _arrays(tq * tk + d, [(b, tq, h, d), (b, tk, h, d),
                                       (b, tk, h, d), (b, tq, h, d)])
    (jq, jk, jv, jg), targs = _both([q, k, v, g], dtype)
    jout, vjp = jax.vjp(lambda a, b_, c: jfa.flash_attention(
        a, b_, c, causal=causal), jq, jk, jv)
    jgrads = vjp(jg)
    tq_, tk_, tv = (t.clone().requires_grad_(True) for t in targs[:3])
    kernels = [tune.kernels()[n] for n in ("fa_fwd", "fa_bwd_dq",
                                           "fa_bwd_dkv")]
    before = [k_.launches for k_ in kernels]
    out = tfa.flash_attention(tq_, tk_, tv, causal=causal)
    out.backward(targs[3])
    assert [k_.launches for k_ in kernels] == before
    tol = _TOL[dtype] if tq % 8 == 0 else {"float32": 1e-4,
                                           "bfloat16": 2e-2}[dtype]
    _close(out, jout, tol)
    for port, ref in zip((tq_.grad, tk_.grad, tv.grad), jgrads):
        _close(port, ref, tol)


def test_flash_attention_bh_layout():
    q, k, v = (torch.from_numpy(a) for a in
               _arrays(3, [(4, 64, 16), (4, 64, 16), (4, 64, 16)]))
    out = tfa.flash_attention_bh(q, k, v, causal=True)
    ref = attention_reference(q[:, :, None], k[:, :, None], v[:, :, None],
                              causal=True)[:, :, 0]
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_wrappers_are_registered_and_raise_on_what_they_do_not_take():
    """The three tuned names are registered wrappers that count launches;
    on the CPU they run the twins; the launchers refuse CPU tensors."""
    regs = tune.kernels()
    for name in ("fa_fwd", "fa_bwd_dq", "fa_bwd_dkv"):
        assert regs[name] is getattr(tfa, name)
        assert regs[name].launches == 0
    q = torch.zeros((1, 16, 8))
    out, lse = tfa.fa_fwd(q, q, q, True, 0.5)
    assert out.shape == q.shape and lse.shape == (1, 16)
    assert tfa.fa_fwd.launches == 0
    with pytest.raises(MXNetError, match="CUDA tensor"):
        tfa._launch_fwd(q, q, q, True, 0.5)
