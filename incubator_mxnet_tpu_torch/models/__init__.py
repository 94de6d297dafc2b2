"""Flagship model definitions (counterpart of
``incubator_mxnet_tpu/models/``): the functional GPT-style Transformer LM.
The vision CNNs live in ``gluon.model_zoo``."""
from . import transformer
from .transformer import TransformerConfig, TransformerLM

__all__ = ["transformer", "TransformerLM", "TransformerConfig"]
