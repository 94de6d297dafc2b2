"""Blocked flash attention: the hand CUDA kernels for Hopper
(``csrc/flash_attention.cu``), their plain PyTorch twins, the wrappers
that launch them, and the ``_Flash`` autograd Function that puts all three
on the transformer's training path.

Counterpart of ``incubator_mxnet_tpu/parallel/flash_attention.py``
(``flash_attention``, ``flash_attention_bh``, ``_pick_block``, and the
custom_vjp ``_flash``). ``flash_attention(q, k, v, causal, sm_scale)``
takes the (B, T, H, D) layout; shapes that do not tile (no block of at
least 8 divides T, or D % 8) take ``attention_reference`` with PyTorch's
autograd, as the JAX package does. Otherwise ``_Flash`` runs the forward
kernel, which also emits the row log-sum-exp, and its backward runs the dq
kernel (which also emits delta = rowsum(dO * O) - dlse) and then the dk/dv
kernel: on the card the hand kernels, on the CPU their twins. ``flash_hop``
(the ring-attention hop) is not ported yet (slice 7); the kernels already
take its ``dlse``.

Kernel note (one H100 SXM: 989 TFLOP/s dense bf16 tensor cores, 67 TFLOP/s
fp32 FMA, 3.35 TB/s HBM). At the transformer flagship (BH = 512, T = 2048,
D = 64, causal, bf16) the three kernels do 2, 3 and 4 products of
BH * T^2 * D / 2 multiply-adds each (274.9, 412.3 and 549.8 GFLOP) and move
about 0.55 GB, so all three are bound by operations, not bytes:

* ``fa_fwd`` -> ``mx_fa_fwd``, replaces ``_fa_kernel``;
* ``fa_bwd_dq`` -> ``mx_fa_bwd_dq``, replaces ``_fa_bwd_dq_kernel``;
* ``fa_bwd_dkv`` -> ``mx_fa_bwd_dkv``, replaces ``_fa_bwd_dkv_kernel``.

The TPU kernels run 1024 x 1024 blocks over a sequential kv (or q) grid
axis that carries the statistics in VMEM. On the card every CTA owns a
64-row tile and loops over the other operand itself (FlashAttention-2):
the running max and sum stay in registers, the streamed tiles and the
softmax tiles pass through shared memory, and the bf16 products run on
the tensor cores through warp-level ``mma.sync`` (f32 accumulation); fp32
runs SIMT FMA (no TF32). The two backward kernels keep the JAX split, so
dq, dk and dv each have one writer: no atomics, bit-identical reruns.
``wgmma``, TMA and a pipelined, warp-specialised schedule are later work.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch
from torch.autograd.function import once_differentiable

from .. import tune
from .hand_kernel import DTYPE_CODE, HandKernel, I32_MAX, check, check_data, \
    raise_on
from .ring_attention import attention_reference

__all__ = ["flash_attention", "flash_attention_bh", "fa_fwd", "fa_bwd_dq",
           "fa_bwd_dkv", "fa_fwd_plain", "fa_bwd_dq_plain",
           "fa_bwd_dkv_plain", "build"]

_SOURCE = "flash_attention"
_NEG_INF = -1e30
_TILE = 64           # the CUDA kernels' tile rows (for the grid-size check)


def _pick_block(t, preferred):
    for b in (preferred, 512, 256, 128, 64, 32, 16, 8):
        if b <= t and t % b == 0:
            return b
    return None


def _to_bh(x):
    B, T, H, D = x.shape
    return x.transpose(1, 2).reshape(B * H, T, D)


def _un_bh(x, B, H, T, D):
    return x.reshape(B, H, T, D).transpose(1, 2)


# ---------------------------------------------------------------------------
# plain versions: the TPU kernels' block recurrence at their block sizes
# (_pick_block(T, 1024)) and cast points, vectorised over BH
# ---------------------------------------------------------------------------

def _dot(a, b):
    """a @ b with float32 accumulation (bf16 products are exact in f32)."""
    return torch.matmul(a.float(), b.float())


def _scaled(q, sm_scale):
    """q * dtype(sm_scale), rounded in q's dtype, as the kernels scale q
    (``torch.full`` fills on the device: no host copy, so CUDA graphs can
    capture the twins)."""
    return q * torch.full((), sm_scale, dtype=q.dtype, device=q.device)


def _mask(s, q0, k0, transposed=False):
    """Causal mask (q >= kv) of a score block; -1e30 elsewhere."""
    a = torch.arange(s.shape[-2], device=s.device)
    b = torch.arange(s.shape[-1], device=s.device)
    if transposed:                     # rows kv, columns q
        keep = (q0 + b)[None, :] >= (k0 + a)[:, None]
    else:
        keep = (q0 + a)[:, None] >= (k0 + b)[None, :]
    return torch.where(keep, s, torch.full_like(s, _NEG_INF))


def _blocks(tq, tk, block):
    bq, bk = _pick_block(tq, block), _pick_block(tk, block)
    check(bq is not None and bk is not None,
          f"flash attention twin: lengths ({tq}, {tk}) do not tile")
    return bq, bk


def fa_fwd_plain(q, k, v, causal, sm_scale, block=1024):
    """(out, lse) of the forward kernel; q (BH, Tq, D), k, v (BH, Tk, D),
    lse (BH, Tq) float32. ``block`` is the preferred block length (the
    JAX package's 1024; smaller in tests, to run several blocks)."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    bq, bk = _blocks(tq, tk, block)
    qs = _scaled(q, sm_scale)
    out = torch.empty_like(q)
    lse = torch.empty((bh, tq), dtype=torch.float32, device=q.device)
    for i in range(tq // bq):
        rows = slice(i * bq, (i + 1) * bq)
        m = torch.full((bh, bq), _NEG_INF, device=q.device)
        l = torch.zeros((bh, bq), device=q.device)
        acc = torch.zeros((bh, bq, d), device=q.device)
        for j in range(tk // bk):
            if causal and j * bk > i * bq + bq - 1:
                break
            cols = slice(j * bk, (j + 1) * bk)
            s = _dot(qs[:, rows], k[:, cols].transpose(1, 2))
            if causal:
                s = _mask(s, i * bq, j * bk)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + _dot(p.to(v.dtype), v[:, cols])
            m = m_new
        den = torch.where(l == 0, torch.ones_like(l), l)
        out[:, rows] = (acc / den[..., None]).to(q.dtype)
        lse[:, rows] = torch.where(l == 0, torch.full_like(l, 1e30),
                                   m + torch.log(den))
    return out, lse


def fa_bwd_dq_plain(q, k, v, do, lse, out, dlse, causal, sm_scale,
                    block=1024):
    """(dq, delta) of the dq kernel; delta = rowsum(dO * O) - dlse,
    (BH, Tq) float32."""
    tq, tk = q.shape[1], k.shape[1]
    bq, bk = _blocks(tq, tk, block)
    delta = (do.float() * out.float()).sum(dim=-1) - dlse
    qs = _scaled(q, sm_scale)
    dq = torch.empty_like(q)
    for i in range(tq // bq):
        rows = slice(i * bq, (i + 1) * bq)
        acc = torch.zeros(q[:, rows].shape, device=q.device)
        for j in range(tk // bk):
            if causal and j * bk > i * bq + bq - 1:
                break
            cols = slice(j * bk, (j + 1) * bk)
            s = _dot(qs[:, rows], k[:, cols].transpose(1, 2))
            if causal:
                s = _mask(s, i * bq, j * bk)
            p = torch.exp(s - lse[:, rows, None])
            dp = _dot(do[:, rows], v[:, cols].transpose(1, 2))
            ds = p * (dp - delta[:, rows, None])
            acc = acc + _dot(ds.to(k.dtype), k[:, cols])
        dq[:, rows] = (acc * sm_scale).to(q.dtype)
    return dq, delta


def fa_bwd_dkv_plain(k, v, q, do, lse, delta, causal, sm_scale,
                     block=1024):
    """(dk, dv) of the dk/dv kernel."""
    tq, tk = q.shape[1], k.shape[1]
    bq, bk = _blocks(tq, tk, block)
    qs = _scaled(q, sm_scale)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    for j in range(tk // bk):
        cols = slice(j * bk, (j + 1) * bk)
        dk_acc = torch.zeros(k[:, cols].shape, device=k.device)
        dv_acc = torch.zeros(v[:, cols].shape, device=v.device)
        for i in range(tq // bq):
            if causal and i * bq + bq - 1 < j * bk:
                continue
            rows = slice(i * bq, (i + 1) * bq)
            st = _dot(k[:, cols], qs[:, rows].transpose(1, 2))
            if causal:
                st = _mask(st, i * bq, j * bk, transposed=True)
            pt = torch.exp(st - lse[:, None, rows])
            dv_acc = dv_acc + _dot(pt.to(do.dtype), do[:, rows])
            dpt = _dot(v[:, cols], do[:, rows].transpose(1, 2))
            dst = pt * (dpt - delta[:, None, rows])
            dk_acc = dk_acc + _dot(dst.to(q.dtype), q[:, rows])
        dk[:, cols] = (dk_acc * sm_scale).to(k.dtype)
        dv[:, cols] = dv_acc.to(v.dtype)
    return dk, dv


# ---------------------------------------------------------------------------
# kernel launches (CUDA tensors only)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib():
    from .. import _cuda
    lib = _cuda.library(_SOURCE)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tail = [i] * 5 + [f, i, p]   # bh, tq, tk, d, causal; scale, dtype, stream
    lib.mx_fa_fwd.argtypes = [p] * 5 + tail
    lib.mx_fa_bwd_dq.argtypes = [p] * 9 + tail
    lib.mx_fa_bwd_dkv.argtypes = [p] * 8 + tail
    for fn in (lib.mx_fa_fwd, lib.mx_fa_bwd_dq, lib.mx_fa_bwd_dkv):
        fn.restype = i
    lib.mx_cuda_error_string.argtypes = [i]
    lib.mx_cuda_error_string.restype = ctypes.c_char_p
    return lib


def build():
    """Compile and load the kernels now (else at their first launch)."""
    _lib()


def _check_qkv(q, k, v):
    check_data("q", q)
    check_data("k", k, q.dtype)
    check_data("v", v, q.dtype)
    check(q.dim() == 3 and k.dim() == 3 and v.shape == k.shape,
          f"expected q (BH, Tq, D) and k, v (BH, Tk, D), got "
          f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    bh, tq, d = q.shape
    tk = k.shape[1]
    check(k.shape[0] == bh and k.shape[2] == d and q.numel() > 0
          and k.numel() > 0, f"q {tuple(q.shape)} and k {tuple(k.shape)} "
          "disagree on BH or D")
    check(k.device == q.device and v.device == q.device,
          "q, k and v must be on one device")
    check(d % 8 == 0 and d <= 128, f"head dim {d}: the kernels take "
          "multiples of 8 up to 128")
    check(bh * -(-max(tq, tk) // _TILE) <= I32_MAX, "grid too large")
    return bh, tq, tk, d


def _check_rows(name, t, bh, tq, device):
    check(isinstance(t, torch.Tensor) and t.device == device
          and t.dtype == torch.float32 and t.is_contiguous()
          and tuple(t.shape) == (bh, tq),
          f"{name}: expected contiguous float32 ({bh}, {tq}) on {device}")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _launch_fwd(q, k, v, causal, sm_scale):
    bh, tq, tk, d = _check_qkv(q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((bh, tq), dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.mx_fa_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            out.data_ptr(), lse.data_ptr(), bh, tq, tk, d,
                            int(causal), float(sm_scale), DTYPE_CODE[q.dtype],
                            _stream(q))
    raise_on(lib, err, "flash attention forward")
    return out, lse


def _launch_bwd_dq(q, k, v, do, lse, out, dlse, causal, sm_scale):
    bh, tq, tk, d = _check_qkv(q, k, v)
    for name, t in (("do", do), ("out", out)):
        check_data(name, t, q.dtype)
        check(t.shape == q.shape and t.device == q.device,
              f"{name}: expected {tuple(q.shape)} on {q.device}")
    _check_rows("lse", lse, bh, tq, q.device)
    _check_rows("dlse", dlse, bh, tq, q.device)
    dq = torch.empty_like(q)
    delta = torch.empty((bh, tq), dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.mx_fa_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), out.data_ptr(), dlse.data_ptr(), dq.data_ptr(),
            delta.data_ptr(), bh, tq, tk, d, int(causal), float(sm_scale),
            DTYPE_CODE[q.dtype], _stream(q))
    raise_on(lib, err, "flash attention dq")
    return dq, delta


def _launch_bwd_dkv(k, v, q, do, lse, delta, causal, sm_scale):
    bh, tq, tk, d = _check_qkv(q, k, v)
    check_data("do", do, q.dtype)
    check(do.shape == q.shape and do.device == q.device,
          f"do: expected {tuple(q.shape)} on {q.device}")
    _check_rows("lse", lse, bh, tq, q.device)
    _check_rows("delta", delta, bh, tq, q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.mx_fa_bwd_dkv(
            k.data_ptr(), v.data_ptr(), q.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            bh, tq, tk, d, int(causal), float(sm_scale), DTYPE_CODE[q.dtype],
            _stream(q))
    raise_on(lib, err, "flash attention dk/dv")
    return dk, dv


class _FlashKernel(HandKernel):
    """A flash kernel's wrapper: the twin for CPU tensors, else one counted
    launch. No autograd of its own: ``_Flash`` owns the gradient and calls
    the backward kernels itself."""

    __call__ = HandKernel.dispatch


fa_fwd = _FlashKernel("fa_fwd", _launch_fwd, fa_fwd_plain)
fa_bwd_dq = _FlashKernel("fa_bwd_dq", _launch_bwd_dq, fa_bwd_dq_plain)
fa_bwd_dkv = _FlashKernel("fa_bwd_dkv", _launch_bwd_dkv, fa_bwd_dkv_plain)


def register_kernels():
    """Register the three wrappers (runs at import; idempotent)."""
    for kern in (fa_fwd, fa_bwd_dq, fa_bwd_dkv):
        tune.register_kernel(kern.name, kern)


register_kernels()


# ---------------------------------------------------------------------------
# the autograd Function and the public entries
# ---------------------------------------------------------------------------

class _Flash(torch.autograd.Function):
    """Forward: the fa_fwd kernel (saves q, k, v, out, lse in the (BH, T,
    D) layout). Backward: the fa_bwd_dq kernel with dlse = 0, then the
    fa_bwd_dkv kernel on its delta. Each call goes through
    ``tune.tuned_call``: twins on the CPU, the registered kernels on the
    card."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        B, Tq, H, D = q.shape
        qb, kb, vb = _to_bh(q), _to_bh(k), _to_bh(v)
        out, lse = tune.tuned_call("fa_fwd", fa_fwd_plain, qb, kb, vb,
                                   causal, sm_scale)
        ctx.save_for_backward(qb, kb, vb, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        ctx.shapes = (B, H, Tq, k.shape[1], D)
        return _un_bh(out, B, H, Tq, D)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        qb, kb, vb, out, lse = ctx.saved_tensors
        B, H, Tq, Tk, D = ctx.shapes
        do = _to_bh(g.to(qb.dtype))
        dq, delta = tune.tuned_call(
            "fa_bwd_dq", fa_bwd_dq_plain, qb, kb, vb, do, lse, out,
            torch.zeros_like(lse), ctx.causal, ctx.sm_scale)
        dk, dv = tune.tuned_call(
            "fa_bwd_dkv", fa_bwd_dkv_plain, kb, vb, qb, do, lse, delta,
            ctx.causal, ctx.sm_scale)
        return (_un_bh(dq, B, H, Tq, D), _un_bh(dk, B, H, Tk, D),
                _un_bh(dv, B, H, Tk, D), None, None)


def flash_attention(q, k, v, causal=False, sm_scale=None):
    """Blocked flash attention. q, k, v: (B, T, H, D) (the layout of
    attention_reference and the transformer flagship). Differentiable;
    shapes that do not tile take attention_reference."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    causal, sm_scale = bool(causal), float(sm_scale)
    bq = _pick_block(q.shape[1], 1024)
    bk = _pick_block(k.shape[1], 1024)
    if bq is None or bk is None or q.shape[-1] % 8:
        return attention_reference(q, k, v, causal=causal, sm_scale=sm_scale)
    return _Flash.apply(q, k, v, causal, sm_scale)


def flash_attention_bh(q, k, v, causal=False, sm_scale=None):
    """(BH, T, D)-layout flash attention: a singleton-head view of
    flash_attention, sharing its kernels and its backward."""
    return flash_attention(q[:, :, None, :], k[:, :, None, :],
                           v[:, :, None, :], causal=causal,
                           sm_scale=sm_scale)[:, :, 0, :]
