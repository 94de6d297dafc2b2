"""Hand-kernel modules of the port (counterparts of
``incubator_mxnet_tpu/parallel/``)."""
