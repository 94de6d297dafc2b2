"""Gluon neural-network layers."""
from .basic_layers import *  # noqa: F401,F403
from .conv_layers import *  # noqa: F401,F403
