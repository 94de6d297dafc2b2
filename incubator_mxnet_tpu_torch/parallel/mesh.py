"""Device mesh construction, for one device.

Counterpart of ``incubator_mxnet_tpu/parallel/mesh.py``. The JAX package
returns a ``jax.sharding.Mesh`` that names every parallelism axis; the
port returns a ``Mesh`` record of axis names, sizes and ``torch.device``s
with the same size rule and the same error. Nothing shards yet: the
training steps of the port take one-device meshes (multi-device
parallelism is ROADMAP queue A, slice 7).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..base import MXNetError

__all__ = ["Mesh", "make_mesh", "local_mesh_axis_sizes"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names (major to minor), their sizes, and the devices in
    row-major order over those axes."""
    axis_names: tuple
    axis_sizes: tuple
    devices: tuple

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self):
        return math.prod(self.axis_sizes)


def make_mesh(axis_shapes=None, devices=None, axis_names=None):
    """Build a Mesh.

    axis_shapes: dict like {"dp": 2, "tp": 4} (order = major->minor), or
    None for all devices on a single "dp" axis. -1 means "remaining
    devices". devices: a list of ``torch.device`` (default ``[cuda:0]``;
    pass ``[torch.device("cpu")]`` to run on the CPU).
    """
    devices = [torch.device(d) for d in
               (devices if devices is not None else ["cuda:0"])]
    n = len(devices)
    if axis_shapes is None:
        axis_shapes = {"dp": n}
    names = list(axis_shapes.keys())
    sizes = list(axis_shapes.values())
    if -1 in sizes:
        known = 1
        for s in sizes:
            if s != -1:
                known *= s
        sizes[sizes.index(-1)] = n // known
    total = math.prod(sizes)
    if total != n:
        raise MXNetError(f"mesh {dict(zip(names, sizes))} needs {total} "
                         f"devices, have {n}")
    return Mesh(tuple(names), tuple(sizes), tuple(devices))


def local_mesh_axis_sizes(mesh):
    return dict(zip(mesh.axis_names, mesh.axis_sizes))
