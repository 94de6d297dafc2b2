"""incubator_mxnet_tpu_torch: the PyTorch + CUDA port of incubator_mxnet_tpu.

Same user surface as the JAX package (``mx.nd``, ``mx.autograd``,
``mx.gluon``, ``mx.serve``), on ``torch.Tensor``s. Entry points run on
``gpu(0)`` unless the caller asks for the CPU (``ctx=mx.cpu()`` or
``with mx.cpu():``). On the card the repository's hand-written CUDA kernels
run where the JAX package runs Pallas kernels; on the CPU their plain
PyTorch twins do.

This release ports the ResNet-50 v1 inference path and its Gluon training
step (autograd, BatchNorm statistics, losses, SGD/NAG, Trainer,
TrainStep), and the functional Transformer LM's one-device training step
(``models.TransformerLM``, flash attention, Adam); the rest of the JAX package's surface follows slice by slice
(ROADMAP.md).

Typical use:
    import incubator_mxnet_tpu_torch as mx
    net = mx.gluon.model_zoo.vision.resnet50_v1()
    net.initialize(mx.init.Xavier(), ctx=mx.gpu())
"""
from __future__ import annotations

__version__ = "0.1.0"

from .runtime import set_fp32_matmul_mode as _set_fp32_mode
from .util import getenv_str as _getenv_str

# MXNet fp32 semantics by default ("strict"): TF32 off for cuBLAS and cuDNN.
_set_fp32_mode(_getenv_str("MXTPU_FP32_MATMUL"))

from . import base
from .base import MXNetError, MXTPUError
from . import context
from .context import Context, cpu, current_context, gpu, num_gpus
from . import autograd
from . import engine
from . import ndarray
from . import ndarray as nd
from .ndarray import NDArray
from .ndarray import random
from . import initializer
from . import initializer as init
from . import runtime
from . import tune
from . import optimizer
from . import gluon
from . import parallel
from . import serve
from . import convert
from . import models
