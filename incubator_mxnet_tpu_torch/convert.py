"""Carry weights from the JAX package into the port.

Both packages name parameters the same way (the structured dotted names of
``Block._collect_params_with_prefix``) and write the same dmlc ``.params``
bytes, so weights cross either as a dict of numpy arrays or as a file that
the JAX package's ``save_parameters`` wrote. BatchNorm running statistics
are parameters too and cross with the rest.

The functional transformer's parameters (a flat dict of name -> array,
``models/transformer.py``) cross as numpy arrays with
``transformer_params_from_numpy`` / ``transformer_params_to_numpy``.
numpy has no bfloat16 of its own, so a bfloat16 array (the ``ml_dtypes``
type that JAX hands to numpy) goes through float32, which holds every
bfloat16 value exactly, and is cast back on arrival.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .base import MXNetError
from .context import Context, current_context
from .ndarray import NDArray
from .ndarray import load as _load

__all__ = ["params_from_numpy", "load_jax_params",
           "transformer_params_from_numpy", "transformer_params_to_numpy"]


def params_from_numpy(arrays, ctx: Context):
    """{structured name: numpy array} -> {name: NDArray on ``ctx``}."""
    return {name: NDArray(a, ctx=ctx) for name, a in arrays.items()}


def load_jax_params(net, arrays_or_path, ctx: Context | None = None):
    """Set every parameter of ``net`` from a {name: numpy array} dict or a
    ``.params`` file path. Parameters without data are created on ``ctx``
    (default: the current context); missing or extra names raise."""
    if isinstance(arrays_or_path, (str, os.PathLike)):
        loaded = _load(os.fspath(arrays_or_path))
        if not isinstance(loaded, dict):
            raise MXNetError(f"{arrays_or_path} holds no parameter dict")
        source = os.fspath(arrays_or_path)
    else:
        loaded = params_from_numpy(arrays_or_path, ctx or current_context())
        source = "arrays"
    net.load_dict(loaded, ctx=ctx, source=source)
    return net


def transformer_params_from_numpy(arrays, device):
    """{name: numpy array} -> {name: tensor on ``device``}; bfloat16
    arrays stay bfloat16 (exactly)."""
    out = {}
    for name, a in arrays.items():
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            out[name] = torch.from_numpy(a.astype(np.float32)).to(
                device=device, dtype=torch.bfloat16)
        else:
            out[name] = torch.from_numpy(a.copy()).to(device)
    return out


def transformer_params_to_numpy(params):
    """{name: tensor} -> {name: numpy array}; bfloat16 tensors come out as
    float32 arrays holding the same values."""
    return {name: (t.detach().float() if t.dtype == torch.bfloat16
                   else t.detach()).cpu().numpy()
            for name, t in params.items()}
