"""Gluon: imperative neural network API (counterpart of
``incubator_mxnet_tpu/gluon``)."""
from . import nn
from . import loss
from . import model_zoo
from .block import Block, HybridBlock
from .parameter import Parameter, ParameterDict
from .trainer import Trainer
