"""Transformer language model (GPT-style, pre-norm), functional.

Counterpart of ``incubator_mxnet_tpu/models/transformer.py`` on one
device. Parameters are a flat dict name -> tensor with the JAX package's
names and shapes; ``apply``/``loss`` are pure functions of them, and
``make_train_step`` returns the same ``(step, shard_params, init_opt)``
triple: Adam with float32 moments, each bf16 weight upcast to float32 for
its update and cast back (no separate master copy, as in the JAX step).
Attention goes through ``parallel.flash_attention`` (the hand flash
kernels on the card) when ``flash_attention`` is on, else through
``attention_reference``. ``remat`` recomputes each block in the backward
(``torch.utils.checkpoint``), as ``jax.checkpoint`` does, so the flash
forward runs twice per block and step.

Not ported yet (ROADMAP queue A, slice 7): the sp/tp paths (ring
attention, ``shard_map``, Megatron sharding, ``param_sharding``), meshes
of more than one device, and the named ``remat_policy`` values.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..base import MXNetError, dtype_torch
from ..context import current_context
from ..parallel.flash_attention import flash_attention
from ..parallel.ring_attention import attention_reference

__all__ = ["TransformerConfig", "TransformerLM"]


def _not_ported(what):
    return MXNetError(f"TransformerLM {what} is not ported yet (ROADMAP "
                      f"queue A, slice 7)")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 6
    d_ff: int = 2048
    max_len: int = 2048
    dtype: str = "bfloat16"
    remat: bool = True          # recompute each block in the backward
    remat_policy: str | None = None   # named policies: not ported
    flash_attention: bool = True


def _tokens(x, device):
    return torch.as_tensor(x).to(device=device, dtype=torch.int64)


class TransformerLM:
    def __init__(self, config: TransformerConfig):
        self.cfg = config

    # -- parameters ---------------------------------------------------------
    def init_params(self, generator, device=None):
        """The JAX package's shapes and distribution: N(0, 1) / sqrt(fan_in)
        drawn in float32 from ``generator`` (on its device), cast to the
        config's dtype, placed on ``device`` (default: the current
        context, gpu(0) unless the caller asks for the CPU)."""
        cfg = self.cfg
        dt = dtype_torch(cfg.dtype)
        if device is None:
            device = current_context().torch_device
        d, f = cfg.d_model, cfg.d_ff

        def dense(fan_in, shape):
            w = torch.randn(shape, generator=generator,
                            device=generator.device, dtype=torch.float32)
            return (w / math.sqrt(fan_in)).to(device=device, dtype=dt)

        def const(value):
            return torch.full((d,), value, dtype=dt, device=device)

        params = {"embed": dense(d, (cfg.vocab_size, d)),
                  "pos_embed": dense(d, (cfg.max_len, d))}
        for i in range(cfg.n_layers):
            p = f"layer{i}_"
            params[p + "ln1_g"] = const(1.0)
            params[p + "ln1_b"] = const(0.0)
            for name in ("wq", "wk", "wv", "wo"):
                params[p + name] = dense(d, (d, d))
            params[p + "ln2_g"] = const(1.0)
            params[p + "ln2_b"] = const(0.0)
            params[p + "w_in"] = dense(d, (d, f))
            params[p + "w_out"] = dense(f, (f, d))
        params["lnf_g"] = const(1.0)
        params["lnf_b"] = const(0.0)
        return params

    def _param_names(self):
        names = ["embed", "pos_embed", "lnf_g", "lnf_b"]
        for i in range(self.cfg.n_layers):
            p = f"layer{i}_"
            names += [p + s for s in ("ln1_g", "ln1_b", "wq", "wk", "wv",
                                      "wo", "ln2_g", "ln2_b", "w_in",
                                      "w_out")]
        return names

    def param_sharding(self, mesh, tp_axis="tp"):
        raise _not_ported("param_sharding")

    # -- forward ------------------------------------------------------------
    def _ln(self, x, g, b):
        # statistics in float32; the normalised x is cast back to x's dtype
        # BEFORE the affine, which runs in that dtype
        xf = x.float()
        m = xf.mean(dim=-1, keepdim=True)
        v = xf.var(dim=-1, keepdim=True, unbiased=False)
        return ((x - m) * torch.rsqrt(v + 1e-5)).to(x.dtype) * g + b

    def _block(self, params, prefix, x, sp_axis=None, tp_axis=None):
        """One pre-norm block on one device."""
        if sp_axis is not None or tp_axis is not None:
            raise _not_ported("sequence/tensor parallelism")
        cfg = self.cfg
        B, T, D = x.shape
        hd = D // cfg.n_heads
        h = self._ln(x, params[prefix + "ln1_g"], params[prefix + "ln1_b"])
        q = (h @ params[prefix + "wq"]).reshape(B, T, cfg.n_heads, hd)
        k = (h @ params[prefix + "wk"]).reshape(B, T, cfg.n_heads, hd)
        v = (h @ params[prefix + "wv"]).reshape(B, T, cfg.n_heads, hd)
        if cfg.flash_attention:
            attn = flash_attention(q, k, v, causal=True)
        else:
            attn = attention_reference(q, k, v, causal=True)
        x = x + attn.reshape(B, T, D) @ params[prefix + "wo"]
        h = self._ln(x, params[prefix + "ln2_g"], params[prefix + "ln2_b"])
        y = F.gelu(h @ params[prefix + "w_in"], approximate="tanh") \
            @ params[prefix + "w_out"]
        return x + y

    def apply(self, params, tokens, sp_axis=None, positions=None,
              tp_axis=None):
        """tokens (B, T) integers -> logits (B, T, vocab) float32."""
        cfg = self.cfg
        if sp_axis is not None or tp_axis is not None:
            raise _not_ported("sequence/tensor parallelism")
        device = params["embed"].device
        tokens = _tokens(tokens, device)
        x = F.embedding(tokens, params["embed"])
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=device)
        x = x + params["pos_embed"][_tokens(positions, device)]
        if cfg.remat:
            if cfg.remat_policy:
                raise _not_ported(f"remat_policy {cfg.remat_policy!r}")

            def block(p, pref, y):
                return checkpoint(self._block, p, pref, y,
                                  use_reentrant=False,
                                  preserve_rng_state=False)
        else:
            block = self._block
        for i in range(cfg.n_layers):
            x = block(params, f"layer{i}_", x)
        x = self._ln(x, params["lnf_g"], params["lnf_b"])
        return (x @ params["embed"].T).float()

    def loss(self, params, tokens, targets, sp_axis=None, positions=None,
             tp_axis=None):
        logits = self.apply(params, tokens, sp_axis, positions, tp_axis)
        logp = torch.log_softmax(logits, dim=-1)
        targets = _tokens(targets, logits.device)
        nll = -logp.gather(-1, targets[..., None])[..., 0]
        return nll.mean()

    # -- training -----------------------------------------------------------
    def make_train_step(self, mesh, lr=1e-3, use_sp=True, n_steps=None):
        """One-device train step, Adam (float32 moments). Returns
        (step_fn, shard_params_fn, init_opt_fn); step_fn(params,
        opt_state, tokens, targets, step_i) -> (params, opt_state, loss),
        loss of the parameters before the update. The inputs are not
        modified; the caller rebinds the returned dicts, which frees the
        old ones.

        n_steps: run that many steps on the same batch, with step_i
        advancing from the given one, and return the last step's loss."""
        from ..parallel.train import _make_update_rule

        names = mesh.axis_names
        if mesh.size != 1 or "tp" in names or (use_sp and "sp" in names):
            raise _not_ported(f"training on mesh {mesh.shape}")
        device = mesh.devices[0]
        _, adam_rule = _make_update_rule("adam", lr, 0.0, 0.0, {})
        model = self

        def one(params, opt_state, tokens, targets, step_i):
            leaves = {k: w.detach().requires_grad_(True)
                      for k, w in params.items()}
            with torch.enable_grad():
                loss = model.loss(leaves, tokens, targets)
                grads = torch.autograd.grad(loss, list(leaves.values()))
            t = int(step_i) + 1
            new_params, new_opt = {}, {}
            with torch.no_grad():
                for (k, w), g in zip(params.items(), grads):
                    w32, new_opt[k] = adam_rule(w.float(), g.float(),
                                                opt_state[k], t)
                    new_params[k] = w32.to(w.dtype)
            return new_params, new_opt, loss.detach()

        def step(params, opt_state, tokens, targets, step_i):
            tokens, targets = _tokens(tokens, device), _tokens(targets, device)
            if not n_steps:
                return one(params, opt_state, tokens, targets, step_i)
            for i in range(n_steps):
                params, opt_state, loss = one(params, opt_state, tokens,
                                              targets, int(step_i) + i)
            return params, opt_state, loss

        def shard_params(params):
            # a copy, so the step never shares storage with the caller's
            return {k: torch.as_tensor(v).detach().to(device).clone()
                    for k, v in params.items()}

        def init_opt(params):
            return {k: (torch.zeros(v.shape, dtype=torch.float32,
                                    device=v.device),
                        torch.zeros(v.shape, dtype=torch.float32,
                                    device=v.device))
                    for k, v in params.items()}

        return step, shard_params, init_opt
