"""Random number source for initializers.

The JAX package threads a global PRNG key chain
(``incubator_mxnet_tpu/ndarray/random.py``). The port draws from an
explicit CPU ``torch.Generator``: a caller passes its own, or takes this
module's default, which ``seed`` re-seeds. Draws happen on the CPU and are
then moved, so one seed gives the same weights on every device.
"""
from __future__ import annotations

import torch

__all__ = ["seed", "default_generator"]

_default = torch.Generator(device="cpu")
_default.manual_seed(0)


def seed(seed_state: int):
    """Re-seed the default generator (reference ``mx.random.seed``)."""
    _default.manual_seed(int(seed_state))


def default_generator() -> torch.Generator:
    return _default
