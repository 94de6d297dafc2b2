"""Inference serving: the dynamic micro-batcher and its telemetry
(counterparts of ``incubator_mxnet_tpu/serve/batcher.py`` and
``serve/stats.py``)."""
from .batcher import DeadlineExceeded, DynamicBatcher, Overloaded
from .stats import LatencyHistogram, ServingStats
