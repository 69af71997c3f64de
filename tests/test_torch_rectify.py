"""The stereo rig geometry of libviso_torch (``geometry/mvg.py``: Camera,
StereoCam, _rodrigues, _log_so3, stereo_rectify, _bilinear_sample,
rectification_warp) against libviso_tpu/geometry/mvg.py, on the same
float32 numpy inputs, plus the oracles of tests/test_geometry.py.

Tolerances: rotations, rectified projections and Q within 1e-5 relative
or absolute (float32 trigonometry and cross products in different
libraries); the normalized F within 1e-4 (float32 4x4 determinants that
cancel to zero in exact arithmetic); bilinear samples at the same
coordinates within 1e-3 grey levels; warped images within 1e-2 grey
levels of JAX's: the float32 homography (K R^T K^-1, inverted by each
library) moves a sample point by about 1e-5 px, times gradients of up to
255 grey levels a pixel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libviso_tpu.geometry import mvg as jmvg
from libviso_torch.geometry import mvg as tmvg
from tests.torch_parity import to_np

K = np.array([[500.0, 0, 320], [0, 510, 240], [0, 0, 1]], np.float32)


def _rig(package, Rw, t):
    m = tmvg if package == "torch" else jmvg
    return m.StereoCam(c1=m.Camera(K=K), c2=m.Camera(K=K), R=Rw, t=t)


def test_camera_default_distortion():
    cam = tmvg.Camera(K=np.eye(3))
    assert cam.D.shape == (4,) and float(cam.D.abs().max()) == 0.0
    assert cam.K.dtype == torch.float32


def test_stereocam_projections_equal_jax():
    t = np.array([-0.5, 0.0, 0.0], np.float32)
    trig = _rig("torch", np.eye(3, dtype=np.float32), t)
    jrig = _rig("jax", np.eye(3, dtype=np.float32), t)
    for name in ("p1", "p2"):
        np.testing.assert_allclose(to_np(getattr(trig, name)()),
                                   np.asarray(getattr(jrig, name)()),
                                   rtol=1e-6)
    Fn = to_np(trig.F()) / np.linalg.norm(to_np(trig.F()))
    Fj = np.asarray(jrig.F()) / np.linalg.norm(np.asarray(jrig.F()))
    np.testing.assert_allclose(Fn, Fj, atol=1e-4)


@pytest.mark.parametrize("v", [[0.3, -0.2, 0.1], [1.2, 0.4, -1.1],
                               [0.0, 0.0, 0.0], [1e-7, 0.0, 0.0]])
def test_rodrigues_and_log_equal_jax(v):
    v = np.asarray(v, np.float32)
    R = tmvg._rodrigues(v)
    np.testing.assert_allclose(to_np(R), np.asarray(jmvg._rodrigues(
        jnp.asarray(v))), atol=1e-6)
    np.testing.assert_allclose(to_np(tmvg._log_so3(R)), np.asarray(
        jmvg._log_so3(jnp.asarray(to_np(R)))), atol=1e-5)
    np.testing.assert_allclose(to_np(tmvg._log_so3(R)), v, atol=1e-5)


def test_stereo_rectify_equals_jax_and_oracle(rng):
    Rw = to_np(tmvg._rodrigues(np.asarray([0.02, -0.05, 0.01], np.float32)))
    t = np.array([-0.54, 0.01, -0.02], np.float32)
    rig = tmvg.stereo_rectify(_rig("torch", Rw, t))
    jrig = jmvg.stereo_rectify(_rig("jax", Rw, t))
    for name in ("R1", "R2", "P1", "P2", "Q"):
        np.testing.assert_allclose(to_np(getattr(rig, name)),
                                   np.asarray(getattr(jrig, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    # the oracle of tests/test_geometry.py::test_stereo_rectify_oracle
    R1, R2 = to_np(rig.R1), to_np(rig.R2)
    assert np.allclose(R1 @ R1.T, np.eye(3), atol=1e-5)
    assert np.allclose(R2 @ Rw, R1, atol=1e-5)
    X = np.stack([rng.uniform(-2, 2, 50), rng.uniform(-1, 1, 50),
                  rng.uniform(3, 10, 50)], -1)
    Kr = to_np(rig.P1)[:, :3]
    p1 = (Kr @ (R1 @ X.T)).T
    p2 = (Kr @ (R2 @ ((Rw @ X.T).T + t).T)).T
    p1, p2 = p1[:, :2] / p1[:, 2:3], p2[:, :2] / p2[:, 2:3]
    assert np.abs(p1[:, 1] - p2[:, 1]).max() < 1e-3
    d = p1[:, 0] - p2[:, 0]
    assert (d > 0).all()
    Z = float(to_np(rig.Q)[2, 3]) * np.linalg.norm(t) / d
    assert np.abs(Z - (R1 @ X.T)[2]).max() < 1e-3


def test_bilinear_sample_equals_jax(rng):
    img = rng.uniform(0, 255, (16, 24)).astype(np.float32)
    x = rng.uniform(-2, 26, 200).astype(np.float32)
    y = rng.uniform(-2, 18, 200).astype(np.float32)
    got = tmvg._bilinear_sample(torch.from_numpy(img), torch.from_numpy(x),
                                torch.from_numpy(y))
    want = jmvg._bilinear_sample(jnp.asarray(img), jnp.asarray(x),
                                 jnp.asarray(y))
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-3)
    assert (to_np(got) == 0).any()   # some samples fell outside


def test_rectification_warp_equals_jax(rng):
    Ks = np.array([[100.0, 0, 64], [0, 100, 32], [0, 0, 1]], np.float32)
    img = rng.uniform(0, 255, (64, 128)).astype(np.float32)
    np.testing.assert_allclose(
        to_np(tmvg.rectification_warp(img, Ks, np.eye(3), Ks)), img,
        atol=1e-3)
    R = to_np(tmvg._rodrigues(np.asarray([0.0, 0.02, 0.01], np.float32)))
    got = tmvg.rectification_warp(img, Ks, R, Ks)
    want = jmvg.rectification_warp(jnp.asarray(img), jnp.asarray(Ks),
                                   jnp.asarray(R), jnp.asarray(Ks))
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-2)
    # the spike lands where the homography predicts
    spike = np.zeros((64, 128), np.float32)
    spike[30:32, 70:72] = 255.0
    out = to_np(tmvg.rectification_warp(spike, Ks, R, Ks))
    yy, xx = np.unravel_index(np.argmax(out), out.shape)
    p = Ks @ R @ np.linalg.inv(Ks) @ [71, 31, 1]
    assert abs(xx - p[0] / p[2]) < 2 and abs(yy - p[1] / p[2]) < 2
