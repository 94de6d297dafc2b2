"""Dense single-device attention: the numeric oracle of the flash kernels
and their route for shapes that do not tile.

Counterpart of ``attention_reference`` in
``incubator_mxnet_tpu/parallel/ring_attention.py:31-45``. The ring itself
(sequence parallelism over a mesh axis) is not ported yet (ROADMAP queue
A, slice 7).
"""
from __future__ import annotations

import math

import torch

__all__ = ["attention_reference"]


def attention_reference(q, k, v, causal=False, sm_scale=None):
    """softmax(q k^T * scale) v. q, k, v: (B, T, H, D). The products run
    in the input dtype (float32 in full precision: the port's strict fp32
    mode keeps TF32 off); a causal mask keeps ``tril`` and fills the rest
    with -inf."""
    d = q.shape[-1]
    if sm_scale is None:
        scale = 1.0 / torch.tensor(math.sqrt(d), dtype=q.dtype)
    else:
        scale = sm_scale
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        mask = torch.tril(torch.ones((q.shape[1], k.shape[1]),
                                     dtype=torch.bool, device=q.device))
        scores = scores.masked_fill(~mask, float("-inf"))
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)
