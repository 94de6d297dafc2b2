"""Hand-kernel modules and the training step of the port (counterparts of
``incubator_mxnet_tpu/parallel/``)."""
from .train import TrainStep

__all__ = ["TrainStep"]
