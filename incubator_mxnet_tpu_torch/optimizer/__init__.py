"""Optimizers (counterpart of ``incubator_mxnet_tpu/optimizer``)."""
from .optimizer import *  # noqa: F401,F403
from . import optimizer  # noqa: F401
