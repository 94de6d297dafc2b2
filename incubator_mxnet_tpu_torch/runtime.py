"""fp32 matmul/convolution precision mode.

Counterpart of ``incubator_mxnet_tpu/runtime.py:14-36``. "strict" is
MXNet's fp32 contract (full fp32 accumulate) and the default: on the card
it turns TF32 off for cuBLAS matmuls AND for cuDNN convolutions, where
PyTorch turns it on by default.
"""
from __future__ import annotations

import torch

__all__ = ["set_fp32_matmul_mode", "fp32_matmul_mode"]

# mode -> (torch float32 matmul precision, cuDNN TF32 allowed)
_FP32_MODES = {"strict": ("highest", False),
               "fast": ("high", True),
               "fastest": ("medium", True)}
_fp32_mode = "strict"


def set_fp32_matmul_mode(mode):
    """Select fp32 matmul semantics ("strict" | "fast" | "fastest"); also
    settable at import via MXTPU_FP32_MATMUL. Applies process-wide."""
    global _fp32_mode
    mode = (mode or "strict").lower()
    if mode not in _FP32_MODES:
        raise ValueError(f"fp32 matmul mode must be one of "
                         f"{sorted(_FP32_MODES)}, got {mode!r}")
    precision, cudnn_tf32 = _FP32_MODES[mode]
    torch.set_float32_matmul_precision(precision)
    if mode == "strict":
        torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = cudnn_tf32
    _fp32_mode = mode


def fp32_matmul_mode():
    return _fp32_mode
