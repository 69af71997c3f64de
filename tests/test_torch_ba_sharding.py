"""Landmark-sharded bundle adjustment of libviso_torch
(``parallel/ba_sharding.py``) against the port's ``bundle_adjust`` and
libviso_tpu's ``sharded_bundle_adjust``, on the windows of
tests/test_bundle_adjust.py::test_sharded_bundle_adjust_api (W = 4, L =
256, poses perturbed by 0.005, 8 iterations).

Tolerances, those of the JAX test: poses within 1e-4 and landmarks within
1e-3 of the unsharded solve (the slices' sums are added in another order)
and of JAX's sharded solve.  On one slice the landmark-slice solver is
``bundle_adjust`` itself, bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libviso_tpu.config import Calib as JCalib
from libviso_tpu.parallel import make_mesh as jax_make_mesh
from libviso_tpu.parallel.ba_sharding import (
    sharded_bundle_adjust as jax_sharded_ba,
)
from libviso_torch.config import Calib
from libviso_torch.parallel import make_mesh, sharded_bundle_adjust
from libviso_torch.solvers.bundle_adjust import (
    bundle_adjust,
    solve_landmark_slices,
)
from tests.test_bundle_adjust import make_window
from tests.torch_parity import to_np

JCALIB = JCalib(f=718.856, cu=607.19, cv=185.22, base=0.537)
CALIB = Calib(f=718.856, cu=607.19, cv=185.22, base=0.537)


def _window(seed, W=4, L=256):
    rng = np.random.default_rng(seed)
    poses, X, obs, mask = (np.asarray(a) for a in make_window(rng, W=W,
                                                                L=L))
    poses_n = poses + 0.005
    poses_n[0] = poses[0]
    f32 = lambda a: np.array(a, np.float32)  # noqa: E731
    return f32(poses_n), f32(X), f32(obs), np.array(mask)


def _mesh(k):
    return make_mesh(n_data=1, n_model=k, devices=["cpu"] * k)


@pytest.mark.parametrize("k", [2, 4, 8])
def test_sharded_equals_unsharded_and_jax(k):
    args = _window(0)
    ref = bundle_adjust(*(torch.from_numpy(a) for a in args), CALIB,
                        iters=8)
    out = sharded_bundle_adjust(_mesh(k), *(torch.from_numpy(a)
                                            for a in args), CALIB, iters=8)
    np.testing.assert_allclose(to_np(out.poses), to_np(ref.poses),
                               atol=1e-4)
    np.testing.assert_allclose(to_np(out.landmarks), to_np(ref.landmarks),
                               atol=1e-3)
    assert float(out.cost) < 0.1 * float(out.initial_cost)
    j = jax_sharded_ba(jax_make_mesh(n_data=1, n_model=k),
                       *(jnp.asarray(a) for a in args), JCALIB, iters=8)
    np.testing.assert_allclose(to_np(out.poses), np.asarray(j.poses),
                               atol=1e-4)
    np.testing.assert_allclose(to_np(out.landmarks),
                               np.asarray(j.landmarks), atol=1e-3)


def test_one_slice_is_bundle_adjust_bitwise():
    args = [torch.from_numpy(a) for a in _window(1)]
    ref = bundle_adjust(*args, CALIB, iters=5)
    out = sharded_bundle_adjust(_mesh(1), *args, CALIB, iters=5)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    poses, Xs, cost, _ = solve_landmark_slices(args[0], [tuple(args[1:])],
                                               CALIB, iters=5)
    assert torch.equal(poses, ref.poses) and torch.equal(Xs[0],
                                                         ref.landmarks)


def test_sharded_bundle_adjust_validates():
    args = [torch.from_numpy(a) for a in _window(2, W=3, L=100)]
    with pytest.raises(ValueError, match="divisible"):
        sharded_bundle_adjust(_mesh(8), *args, CALIB)


def test_unknown_mode_raises():
    args = [torch.from_numpy(a) for a in _window(2, W=3, L=16)]
    with pytest.raises(ValueError, match="unknown mode"):
        solve_landmark_slices(args[0], [tuple(args[1:])], CALIB,
                              mode="both")
