"""Device meshes (port of ``libviso_tpu/parallel/mesh.py``).

A ``Mesh`` is a numpy array of ``torch.device`` with named axes, the shape
of ``jax.sharding.Mesh`` without its compiler: the parallel drivers read
it to decide which device runs which shard, and run the shards from one
process (the JAX layer is single-controller too).  Axis convention:

  - ``data``: sequence chunks (parallel/odometry.py) and serving streams
    (pipeline/multistream.py::jit_multistream_sharded);
  - ``model``: view-2 slots of the match-cost matrix
    (parallel/tp_matching.py) and the landmarks of a BA window
    (parallel/ba_sharding.py);
  - ``pipe``: the two stages of the staged pipeline
    (parallel/pp_odometry.py).

A mesh may name one device more than once.  The JAX tests get eight CPU
devices from ``--xla_force_host_platform_device_count=8``
(tests/conftest.py); the port's tests repeat the one CPU device instead,
and a machine with one card repeats ``cuda:0``.  Shards on one device run
there in turn: that proves the sharding logic (the split, the offsets, the
merge), not scale-out.  ``torch.distributed.DeviceMesh`` does not fit this
layer: it needs one process per device.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


class Mesh:
    """Devices in an array with named axes; ``shape`` maps each axis name
    to its size, as ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, devices, axis_names):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-d device array for axes "
                             f"{self.axis_names}")

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str):
        """The devices along ``axis``, at index 0 of every other axis."""
        i = self.axis_names.index(axis)
        index = tuple(slice(None) if a == i else 0
                      for a in range(self.devices.ndim))
        return list(self.devices[index])


def default_devices():
    """One entry per visible card; without a card this raises, as
    ``pipeline/stereo.py::resolve_device`` does, instead of running on the
    CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "torch sees no CUDA device; pass devices explicitly (e.g. "
            "['cpu'] * 4) to build a mesh on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A ('data', 'model') mesh over ``devices`` (default: every card),
    filled row-major from the first n_data * n_model entries."""
    if devices is None:
        devices = default_devices()
    devices = [torch.device(d) for d in devices]
    if n_data is None:
        n_data = len(devices) // n_model
    need = n_data * n_model
    if need < 1 or len(devices) < need:
        raise ValueError(f"a {n_data} x {n_model} mesh needs {need} "
                         f"devices, got {len(devices)}")
    grid = np.empty((n_data, n_model), dtype=object)
    for i, d in enumerate(devices[:need]):
        grid[i // n_model, i % n_model] = d
    return Mesh(grid, ("data", "model"))


def make_pipe_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """The 2-entry ('pipe',) mesh of the staged pipeline: stage 0 the
    front-end and matching, stage 1 the solve."""
    if devices is None:
        devices = default_devices()
    devices = [torch.device(d) for d in devices]
    if len(devices) < 2:
        raise ValueError("pipeline parallelism needs 2 devices (a device "
                         "may be named twice)")
    grid = np.empty((2,), dtype=object)
    grid[0], grid[1] = devices[0], devices[1]
    return Mesh(grid, ("pipe",))
