"""libviso_torch.solvers against libviso_tpu.solvers, with JAX's RANSAC
Gumbel draws injected: ok flags and inlier masks equal, motions within
atol 1e-4 (float32 normal equations summed in different orders)."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libviso_tpu.config import Calib, RansacConfig
from libviso_torch.config import from_jax_config
from libviso_torch.solvers import gauss_newton as tgn
from libviso_torch.solvers import ransac as transac
from tests.torch_parity import to_np, to_torch

# libviso_tpu.solvers re-exports functions under its modules' names
jgn = importlib.import_module("libviso_tpu.solvers.gauss_newton")
jransac = importlib.import_module("libviso_tpu.solvers.ransac")

CALIB = Calib(f=718.856, cu=607.1928, cv=185.2157, base=0.5371657)
TCALIB = from_jax_config(CALIB)
TRUE_TR = np.array([0.01, -0.02, 0.005, 0.1, -0.05, -0.8], np.float32)


def _problem(rng, n=300, outliers=0.25, noise=0.3):
    """Previous-frame points, their current-frame observations under
    TRUE_TR with pixel noise, a share of gross outliers and padded
    slots."""
    X = np.stack([rng.uniform(-20, 20, n), rng.uniform(-3, 2, n),
                  rng.uniform(5, 60, n)], -1).astype(np.float32)
    pred, _ = jgn.stereo_predict(jnp.asarray(TRUE_TR), jnp.asarray(X), CALIB)
    obs = np.asarray(pred) + rng.normal(scale=noise, size=(n, 4))
    obs[:, 3] = obs[:, 1]
    bad = rng.random(n) < outliers
    obs[bad] += rng.uniform(-40, 40, size=(bad.sum(), 4))
    valid = rng.random(n) > 0.1
    return X, obs.astype(np.float32), valid


def test_gauss_newton_matches_jax(rng):
    X, obs, valid = _problem(rng, outliers=0.0)
    w = valid.astype(np.float32)
    cfg = RansacConfig()
    a = tgn.gauss_newton(to_torch(X), to_torch(obs), to_torch(w),
                         torch.zeros(6), TCALIB, from_jax_config(cfg))
    b = jgn.gauss_newton(jnp.asarray(X), jnp.asarray(obs), jnp.asarray(w),
                         jnp.zeros(6), CALIB, cfg)
    np.testing.assert_allclose(to_np(a.tr), np.asarray(b.tr), atol=1e-4)
    assert bool(a.converged) == bool(b.converged)
    np.testing.assert_allclose(to_np(a.tr), TRUE_TR, atol=5e-3)


def test_gauss_newton_batched_lanes_and_unroll_invariance(rng):
    X, obs, _ = _problem(rng, n=40, outliers=0.0)
    idx = rng.integers(0, 40, size=(8, 3))
    Xs, os_ = X[idx], obs[idx]
    w = np.ones((8, 3), np.float32)
    cfg = RansacConfig(gn_iters=30)
    b = jgn.gauss_newton(jnp.asarray(Xs), jnp.asarray(os_), jnp.asarray(w),
                         jnp.zeros((8, 6)), CALIB, cfg)
    results = []
    for unroll in (1, 2, 5):
        tcfg = from_jax_config(dataclasses.replace(cfg, gn_unroll=unroll))
        results.append(tgn.gauss_newton(
            to_torch(Xs), to_torch(os_), to_torch(w), torch.zeros(8, 6),
            TCALIB, tcfg))
    for r in results[1:]:
        assert torch.equal(r.tr, results[0].tr)
        assert torch.equal(r.iters, results[0].iters)
    ok = np.asarray(b.converged)
    np.testing.assert_array_equal(to_np(results[0].converged), ok)
    np.testing.assert_allclose(to_np(results[0].tr)[ok],
                               np.asarray(b.tr)[ok], atol=1e-4)


def test_solve_spd6_flags_non_positive_definite(rng):
    M = rng.normal(size=(6, 6))
    A = np.stack([M @ M.T + 6 * np.eye(6), -np.eye(6)]).astype(np.float32)
    b = rng.normal(size=(2, 6)).astype(np.float32)
    step, ok = tgn._solve_spd6(to_torch(A), to_torch(b))
    jstep, jok = jgn._solve_spd6(jnp.asarray(A), jnp.asarray(b))
    assert to_np(ok).tolist() == np.asarray(jok).tolist() == [True, False]
    assert not step[1].any()
    np.testing.assert_allclose(to_np(step), np.asarray(jstep), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("method", ["procrustes", "gn"])
def test_ransac_pose_with_injected_draws(rng, method):
    X, obs, valid = _problem(rng)
    cfg = RansacConfig(hypothesis_method=method)
    key = jax.random.PRNGKey(7)
    b = jransac.ransac_pose(key, jnp.asarray(X), jnp.asarray(obs),
                            jnp.asarray(valid), CALIB, cfg)
    gumbel = to_torch(jax.random.gumbel(key, (cfg.num_hypotheses, len(X)),
                                        jnp.float32))
    a = transac.ransac_pose(to_torch(X), to_torch(obs), to_torch(valid),
                            TCALIB, from_jax_config(cfg), gumbel=gumbel)
    assert bool(a.ok) == bool(b.ok) is True
    assert int(a.best_hypothesis) == int(b.best_hypothesis)
    np.testing.assert_array_equal(to_np(a.inliers), np.asarray(b.inliers))
    assert int(a.num_inliers) == int(b.num_inliers)
    np.testing.assert_allclose(to_np(a.tr), np.asarray(b.tr), atol=1e-4)
    np.testing.assert_allclose(float(a.rms), float(b.rms), rtol=1e-4)


def test_ransac_pose_draws_from_a_generator(rng):
    X, obs, valid = _problem(rng)
    args = (to_torch(X), to_torch(obs), to_torch(valid), TCALIB)
    with pytest.raises(ValueError, match="gumbel or a generator"):
        transac.ransac_pose(*args)
    a = transac.ransac_pose(*args, generator=transac.frame_generator(0, 3))
    b = transac.ransac_pose(*args, generator=transac.frame_generator(0, 3))
    assert bool(a.ok) and torch.equal(a.tr, b.tr)
    np.testing.assert_allclose(to_np(a.tr), TRUE_TR, atol=0.02)
    g1 = transac.sample_gumbel((4, 5), transac.frame_generator(0, 3))
    g2 = transac.sample_gumbel((4, 5), transac.frame_generator(0, 4))
    assert torch.isfinite(g1).all() and not torch.equal(g1, g2)
