"""Hand-kernel modules, meshes and the training step of the port
(counterparts of ``incubator_mxnet_tpu/parallel/``)."""
from .flash_attention import flash_attention, flash_attention_bh
from .mesh import make_mesh
from .train import TrainStep

__all__ = ["TrainStep", "make_mesh", "flash_attention", "flash_attention_bh"]
