"""The window bundle adjustment of libviso_torch
(``solvers/bundle_adjust.py``) against libviso_tpu's.

Windows as ``tests/test_bundle_adjust.py::make_window`` builds them (W = 6
cameras driving forward over L = 200 landmarks, 85 % visible), perturbed
with numpy from a seed, go through both packages under each option.  The
cost at given poses agrees within rtol 1e-5; after the LM iterations the
poses agree within 1e-4, the landmarks within 1e-3 m and the final cost
within rtol 1e-4 (both sum the normal equations in float32, in different
orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libviso_tpu.config import Calib as JCalib
from libviso_tpu.solvers import bundle_adjust as jba
from libviso_torch.config import Calib
from libviso_torch.solvers import bundle_adjust as tba
from tests.test_bundle_adjust import make_window
from tests.torch_parity import to_np

JCALIB = JCalib(f=718.856, cu=607.19, cv=185.22, base=0.537)
CALIB = Calib(f=718.856, cu=607.19, cv=185.22, base=0.537)


def _window(seed, noise_px=0.0, pose_sigma=0.01, lm_sigma=0.05):
    """(ground-truth poses, start poses, start landmarks, obs, mask) as
    float32 numpy; the gauge pose starts exact."""
    rng = np.random.default_rng(seed)
    poses, X, obs, mask = (np.asarray(a) for a in make_window(
        rng, noise_px=noise_px))
    poses0 = poses + pose_sigma * rng.normal(size=poses.shape)
    poses0[0] = poses[0]
    X0 = X + lm_sigma * rng.normal(size=X.shape)
    f32 = lambda a: np.array(a, np.float32)  # noqa: E731
    return f32(poses), f32(poses0), f32(X0), f32(obs), np.array(mask)


def _both(args, **kw):
    """bundle_adjust of each package on the same numpy inputs."""
    j = jba.bundle_adjust(*(jnp.asarray(a) for a in args), JCALIB,
                          **{k: jnp.asarray(v) if isinstance(v, np.ndarray)
                             else v for k, v in kw.items()})
    t = tba.bundle_adjust(*(torch.from_numpy(a) for a in args), CALIB,
                          **{k: torch.from_numpy(v)
                             if isinstance(v, np.ndarray) else v
                             for k, v in kw.items()})
    return j, t


def _close(j, t):
    np.testing.assert_allclose(to_np(t.poses), np.asarray(j.poses),
                               atol=1e-4)
    # rtol: a landmark 50-60 m out lies in a flat valley along its depth
    # (0.3 px of noise is ~2.5 m of depth there); once both packages reach
    # the float32 floor of the cost, steps accepted or rejected on its last
    # bit move such a landmark by up to 7.3e-3 m (1.3e-4 of its depth;
    # measured on the prior case, where the poses agree within 5e-7)
    np.testing.assert_allclose(to_np(t.landmarks), np.asarray(j.landmarks),
                               atol=1e-3, rtol=2e-4)
    np.testing.assert_allclose(float(t.initial_cost), float(j.initial_cost),
                               rtol=1e-5)
    # atol: a window that converges reaches the float32 floor of its
    # residuals (coordinates of ~600 px carry ulps of 6e-5 px), a cost of
    # ~2e-9 px^2 whose digits are rounding in either package (measured
    # gap 2.4e-10 on the clean case)
    np.testing.assert_allclose(float(t.cost), float(j.cost), rtol=1e-4,
                               atol=1e-8)
    assert float(t.cost) <= float(t.initial_cost)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("at", ["truth", "start"])
def test_ba_cost_equals_jax(seed, at):
    gt, poses0, X0, obs, mask = _window(seed, noise_px=0.3)
    poses = gt if at == "truth" else poses0
    weight = np.full(poses.shape, 50.0, np.float32)
    for prior in (None, gt):
        kw = ({} if prior is None else dict(pose_prior=prior,
                                            prior_weight=weight))
        want = float(jba.ba_cost(*(jnp.asarray(a) for a in (poses, X0, obs,
                                                             mask)), JCALIB,
                                 **{k: jnp.asarray(v) for k, v in kw.items()}))
        got = float(tba.ba_cost(*(torch.from_numpy(a) for a in (poses, X0,
                                                                obs, mask)),
                                CALIB, **{k: torch.from_numpy(v)
                                          for k, v in kw.items()}))
        np.testing.assert_allclose(got, want, rtol=1e-5)


CASES = {"clean": dict(), "noisy": dict(noise_px=0.3),
         "perturbed": dict(pose_sigma=0.03, lm_sigma=0.2),
         "poses only": dict(lm_sigma=0.0)}


@pytest.mark.parametrize("case", list(CASES))
def test_bundle_adjust_equals_jax(case):
    gt, poses0, X0, obs, mask = _window(3, **CASES[case])
    j, t = _both((poses0, X0, obs, mask), iters=15)
    _close(j, t)
    # the gauge pose stays where it started
    np.testing.assert_array_equal(to_np(t.poses)[0], poses0[0])
    if case != "noisy":
        assert float(t.cost) < 1e-4
        np.testing.assert_allclose(to_np(t.poses), gt, atol=1e-3)


@pytest.mark.parametrize("weight", [0.0, 2e4])
def test_pose_prior_equals_jax(weight):
    gt, poses0, X0, obs, mask = _window(4, noise_px=0.3)
    prior = gt + np.float32(0.002)
    w = np.full(gt.shape, weight, np.float32)
    w[0] = 0.0
    j, t = _both((poses0, X0, obs, mask), iters=12, pose_prior=prior,
                 prior_weight=w)
    _close(j, t)
    plain = tba.bundle_adjust(*(torch.from_numpy(a) for a in
                                (poses0, X0, obs, mask)), CALIB, iters=12)
    if weight == 0.0:
        # a zero-weight prior is a no-op, bit for bit
        assert torch.equal(t.poses, plain.poses)
        assert torch.equal(t.landmarks, plain.landmarks)
    else:
        # the prior pulls the poses towards itself
        d_prior = np.abs(to_np(t.poses) - prior)[1:].mean()
        d_plain = np.abs(to_np(plain.poses) - prior)[1:].mean()
        assert d_prior < d_plain


def test_pose_prior_needs_weight():
    _, poses0, X0, obs, mask = _window(0)
    with pytest.raises(ValueError, match="prior_weight"):
        tba.bundle_adjust(*(torch.from_numpy(a) for a in
                            (poses0, X0, obs, mask)), CALIB,
                          pose_prior=torch.from_numpy(poses0))


@pytest.mark.parametrize("freeze", ["freeze_landmarks", "freeze_poses"])
def test_frozen_blocks_equal_jax(freeze):
    _, poses0, X0, obs, mask = _window(5, noise_px=0.3)
    j, t = _both((poses0, X0, obs, mask), iters=10, **{freeze: True})
    _close(j, t)
    if freeze == "freeze_landmarks":
        np.testing.assert_array_equal(to_np(t.landmarks), X0)
    else:
        np.testing.assert_array_equal(to_np(t.poses), poses0)


def test_singular_step_is_rejected():
    """A landmark seen nowhere and a camera that sees nothing leave the
    system singular without damping: the step is rejected in values (no
    exception), the iterate stays finite and the cost does not rise."""
    _, poses0, X0, obs, mask = _window(6)
    mask = mask.copy()
    mask[:, :10] = False
    mask[3] = False
    t = tba.bundle_adjust(*(torch.from_numpy(a) for a in
                            (poses0, X0, obs, mask)), CALIB, iters=6,
                          damping=0.0)
    assert torch.isfinite(t.poses).all() and torch.isfinite(t.landmarks).all()
    assert float(t.cost) <= float(t.initial_cost)
