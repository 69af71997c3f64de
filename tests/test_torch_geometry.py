"""libviso_torch.geometry against libviso_tpu.geometry (tolerance atol
1e-5: both compute in float32, in different summation orders)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libviso_tpu.geometry import mvg as jmvg
from libviso_tpu.geometry import procrustes as jpro
from libviso_tpu.geometry import se3 as jse3
from libviso_tpu.geometry import triangulate as jtri
from libviso_torch.geometry import mvg as tmvg
from libviso_torch.geometry import procrustes as tpro
from libviso_torch.geometry import se3 as tse3
from libviso_torch.geometry import triangulate as ttri
from libviso_torch.synthetic import kitti_projections
from tests.torch_parity import to_np, to_torch

ATOL = 1e-5


def _motions(rng, n):
    tr = rng.normal(size=(n, 6)).astype(np.float32)
    tr[:, :3] *= 0.2
    return tr


@pytest.mark.parametrize("fn", ["euler_to_rotation", "pose_vector_to_matrix",
                                "rotation_derivatives"])
def test_se3_maps(rng, fn):
    tr = _motions(rng, 7)
    x = tr[:, :3] if fn != "pose_vector_to_matrix" else tr
    a = getattr(tse3, fn)(to_torch(x))
    b = getattr(jse3, fn)(jnp.asarray(x))
    np.testing.assert_allclose(to_np(a), np.asarray(b), atol=ATOL)


def test_matrix_to_pose_vector_and_inverse(rng):
    tr = _motions(rng, 7)
    T = np.asarray(jse3.pose_vector_to_matrix(jnp.asarray(tr)))
    np.testing.assert_allclose(
        to_np(tse3.matrix_to_pose_vector(to_torch(T))),
        np.asarray(jse3.matrix_to_pose_vector(jnp.asarray(T))), atol=ATOL)
    np.testing.assert_allclose(
        to_np(tse3.invert_se3(to_torch(T))),
        np.asarray(jse3.invert_se3(jnp.asarray(T))), atol=ATOL)


def test_chain_motions_with_invalid_frames(rng):
    tr = _motions(rng, 9) * 0.3
    T = np.asarray(jse3.pose_vector_to_matrix(jnp.asarray(tr)))
    valid = rng.random(9) > 0.3
    a = tse3.chain_motions(to_torch(T), to_torch(valid))
    b = jse3.chain_motions(jnp.asarray(T), jnp.asarray(valid))
    np.testing.assert_allclose(to_np(a), np.asarray(b), atol=ATOL)


def test_homogeneous_round_trip(rng):
    x = rng.normal(size=(5, 3)).astype(np.float32)
    np.testing.assert_array_equal(to_np(tmvg.e2h(to_torch(x))),
                                  np.asarray(jmvg.e2h(jnp.asarray(x))))
    xh = np.concatenate([x, np.full((5, 1), 1e-9, np.float32)], -1)
    for eps in (0.0, 1e-6):
        np.testing.assert_allclose(
            to_np(tmvg.h2e(to_torch(xh), eps=eps)),
            np.asarray(jmvg.h2e(jnp.asarray(xh), eps=eps)), rtol=1e-6)


def test_fundamental_matrix_host():
    P1, P2 = kitti_projections()
    np.testing.assert_array_equal(tmvg.F_from_P_host(P1, P2),
                                  jmvg.F_from_P_host(P1, P2))


def test_sampson_distance_pairs(rng):
    P1, P2 = kitti_projections()
    F = jmvg.F_from_P_host(P1, P2).astype(np.float32)
    x1 = rng.uniform(0, 600, size=(40, 2)).astype(np.float32)
    x2 = x1 + rng.normal(scale=2.0, size=(40, 2)).astype(np.float32)
    a = tmvg.sampson_distance(to_torch(F), to_torch(x1)[:, None],
                              to_torch(x2)[None])
    b = jmvg.sampson_distance(jnp.asarray(F), jnp.asarray(x1)[:, None],
                              jnp.asarray(x2)[None])
    np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=1e-4,
                               atol=1e-3)


def test_sampson_zero_denominator_is_not_finite():
    # F = 0: the denominator vanishes and the matcher must reject the pair
    F = torch.zeros(3, 3)
    s = tmvg.sampson_distance(F, torch.ones(1, 2), torch.ones(1, 2))
    assert not torch.isfinite(s).any()


def test_triangulate_rectified_with_clamp(rng):
    x = rng.uniform(0, 400, size=(3, 20, 4)).astype(np.float32)
    x[..., 2] = x[..., 0] - rng.uniform(0.5, 40, size=(3, 20))
    x[0, :3, 2] = x[0, :3, 0]            # zero disparity: clamped
    x[1, :3, 2] = x[1, :3, 0] + 5.0      # negative disparity: clamped
    args = (718.856, 0.5371657, 607.1928, 185.2157)
    a = ttri.triangulate_rectified(to_torch(x), *args)
    b = jtri.triangulate_rectified(jnp.asarray(x), *args)
    assert torch.isfinite(a).all()
    np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=1e-6)


def test_horn_alignment(rng):
    tr = _motions(rng, 4)
    T = np.asarray(jse3.pose_vector_to_matrix(jnp.asarray(tr)))
    B = rng.normal(size=(4, 12, 3)).astype(np.float32) * 5
    A = (B @ T[:, :3, :3].transpose(0, 2, 1) + T[:, None, :3, 3]
         + rng.normal(scale=0.01, size=B.shape)).astype(np.float32)
    w = (rng.random((4, 12)) > 0.2).astype(np.float32)
    a = tpro.solve_rigid_motion_horn(to_torch(A), to_torch(B), to_torch(w))
    b = jpro.solve_rigid_motion_horn(jnp.asarray(A), jnp.asarray(B),
                                     jnp.asarray(w))
    np.testing.assert_allclose(to_np(a), np.asarray(b), atol=1e-4)
    np.testing.assert_allclose(to_np(a), T, atol=0.02)
