"""Engine control surface: the bulk size.

Counterpart of ``incubator_mxnet_tpu/engine.py``. A nonzero bulk size
overrides ``MXNET_OPTIMIZER_AGGREGATION_SIZE`` as the per-bucket parameter
count of ``gluon.Trainer``'s aggregated optimizer step, so code that wraps
its update loop in ``engine.bulk(n)`` changes how the step is batched.
``set_bulk_size`` returns the previous value and ``bulk(size)`` restores it
on exit.
"""
from __future__ import annotations

from contextlib import contextmanager

__all__ = ["bulk", "bulk_size", "set_bulk_size"]

_bulk_size = 0


def set_bulk_size(size):
    """Set the bulk size; returns the previous one."""
    global _bulk_size
    prev, _bulk_size = _bulk_size, int(size)
    return prev


def bulk_size():
    """Current bulk size; 0 means unset (the Trainer then reads
    MXNET_OPTIMIZER_AGGREGATION_SIZE)."""
    return _bulk_size


@contextmanager
def bulk(size):
    prev = set_bulk_size(size)
    try:
        yield
    finally:
        set_bulk_size(prev)
