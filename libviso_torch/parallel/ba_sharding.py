"""Landmark-sharded bundle adjustment (port of
``libviso_tpu/parallel/ba_sharding.py``).

A BA window's heavy axis is the landmarks: the pose blocks U, the Schur
term W V^-1 W' and the right-hand side are sums over them, while V, its
inverse and the back-substitution are per landmark.  So the landmarks
split over the mesh's ``model`` entries: each entry computes its slice's
sums on its device (``solvers/bundle_adjust.py::landmark_sums``), the
first entry adds them, solves the 6W pose system and sends the pose step
back, and each entry back-substitutes its own landmarks.  Devices
exchange tensors only, so nothing waits for the host.

The sums are added in another order than one device adds them, so the
result is not bit-equal to ``bundle_adjust``; it agrees within float32
reduction noise (tests/test_torch_ba_sharding.py).
"""

from __future__ import annotations

import torch

from libviso_torch.config import Calib
from libviso_torch.solvers.bundle_adjust import (
    BAResult,
    solve_landmark_slices,
)


def sharded_bundle_adjust(mesh, poses0, X0, obs, mask, calib: Calib,
                          iters: int = 10, damping: float = 1e-4,
                          fix_first: bool = True,
                          axis: str = "model") -> BAResult:
    """Window BA with the landmark axis split over ``axis``.

    Args:
      mesh: a mesh with ``axis`` (``parallel/mesh.py``).
      poses0: (W, 6) initial poses, solved on the first entry's device.
      X0: (L, 3) landmarks; obs (W, L, 4); mask (W, L): split along L.

    L must be divisible by the axis size.  Returns a BAResult on the first
    entry's device.
    """
    devices = mesh.axis_devices(axis)
    k = len(devices)
    L = X0.shape[0]
    if L % k:
        raise ValueError(f"L={L} not divisible by mesh axis {axis!r} "
                         f"size {k}")
    n = L // k
    home = devices[0]
    slices = [(X0[i * n:(i + 1) * n].to(dev),
               obs[:, i * n:(i + 1) * n].to(dev),
               mask[:, i * n:(i + 1) * n].to(dev))
              for i, dev in enumerate(devices)]
    poses, Xs, cost, init_cost = solve_landmark_slices(
        poses0.to(home), slices, calib, iters=iters, damping=damping,
        fix_first=fix_first)
    return BAResult(poses=poses,
                    landmarks=torch.cat([X.to(home) for X in Xs]),
                    cost=cost, initial_cost=init_cost,
                    iters=torch.full((), iters, dtype=torch.int32,
                                     device=home))
