"""The BA window assembly and refinement of libviso_torch
(``pipeline/refine.py``) against libviso_tpu's, on one front-end output.

The JAX package's frame-batched front-end runs once on a 6-frame window of
the sprite generator (416x160, 512 slots); its TrackData goes to the port
through ``pipeline/batched.py::tracks_from_jax``, so both packages build
their BA problems from the same tracks and no RANSAC near-tie separates
them.  Discrete outputs are equal (the inverted maps, the problem's
observations and mask, the gates' masks and decisions); poses within 1e-6,
gate medians within 1e-5 on equal poses, refined motions within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libviso_tpu.config import Calib as JCalib
from libviso_tpu.config import DetectorConfig, PipelineConfig, RansacConfig
from libviso_tpu.geometry.mvg import F_from_P_host
from libviso_tpu.pipeline import refine as jref
from libviso_tpu.pipeline.batched import build_batched_odometry
from libviso_tpu.synthetic import generate_sequence
from libviso_torch.config import Calib
from libviso_torch.pipeline import refine as tref
from libviso_torch.pipeline.batched import tracks_from_jax
from tests.torch_parity import to_np, to_torch

N = 512
W = 6


@pytest.fixture(scope="module")
def window():
    """(JAX TrackData, JAX motions, the port's TrackData, both calibs)."""
    seq = generate_sequence(num_frames=W, num_points=500, seed=31,
                            width=416, height=160, speed=0.6, f=360.0)
    cfg = PipelineConfig(
        detector=DetectorConfig(max_features=480, nbinx=8, nbiny=4,
                                num_slots=N),
        ransac=RansacConfig(num_hypotheses=32, gn_iters=50))
    jcalib = JCalib.from_projections(seq.P1, seq.P2)
    fn = jax.jit(build_batched_odometry(jcalib, F_from_P_host(seq.P1, seq.P2),
                                        cfg, with_tracks=True))
    ims = [jnp.asarray(np.stack([f[v] for f in seq.frames])) for v in (0, 1)]
    out, tracks = fn(*ims, jax.random.PRNGKey(0))
    assert np.asarray(out.ok)[1:].all()
    return (tracks, out.motions, tracks_from_jax(tracks),
            jcalib, Calib.from_projections(seq.P1, seq.P2))


@pytest.fixture(scope="module")
def problems(window):
    tracks, motions, t_tracks, _, _ = window
    jp = jref.build_window_problem(
        tracks.kp1_xy, tracks.kp2_xy, tracks.mlr_idx, tracks.mlr_valid,
        tracks.m11_idx, tracks.m11_valid, tracks.X, motions, N,
        circ_valid=tracks.circ_valid)
    tp = tref.build_window_problem(
        t_tracks.kp1_xy, t_tracks.kp2_xy, t_tracks.mlr_idx,
        t_tracks.mlr_valid, t_tracks.m11_idx, t_tracks.m11_valid,
        t_tracks.X, to_torch(motions), N, circ_valid=t_tracks.circ_valid)
    return jp, tp


def test_invert_match_map_collisions():
    """The last writer wins, as XLA's scatter keeps it on the CPU."""
    idx = np.array([3, 3, 1, 3, 0, 1], np.int32)
    valid = np.ones(6, bool)
    want = np.asarray(jref.invert_match_map(jnp.asarray(idx),
                                            jnp.asarray(valid), 5))
    got = to_np(tref.invert_match_map(to_torch(idx), to_torch(valid), 5))
    np.testing.assert_array_equal(want, [4, 5, -1, 3, -1])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_invert_match_map_equals_jax(seed):
    """1280 random indices into 50 slots, some invalid (with idx -1 or a
    stale index), one map and a stack of maps."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 50, (3, 1280)).astype(np.int32)
    valid = rng.random((3, 1280)) < 0.7
    idx[rng.random((3, 1280)) < 0.1] = -1
    valid &= idx >= 0
    want = np.asarray(jax.vmap(lambda i, v: jref.invert_match_map(
        i, v, 50))(jnp.asarray(idx), jnp.asarray(valid)))
    got = to_np(tref.invert_match_map(to_torch(idx), to_torch(valid), 50))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        to_np(tref.invert_match_map(to_torch(idx[0]), to_torch(valid[0]),
                                    50)), want[0])


def test_tracks_from_jax(window):
    tracks, _, t_tracks, _, _ = window
    assert t_tracks._fields == tracks._fields
    for name in tracks._fields:
        np.testing.assert_array_equal(to_np(getattr(t_tracks, name)),
                                      np.asarray(getattr(tracks, name)),
                                      name)
    assert t_tracks.mlr_idx.dtype == torch.long
    assert t_tracks.mlr_valid.dtype == torch.bool
    assert t_tracks.X.dtype == torch.float32


def test_build_window_problem_equals_jax(problems):
    jp, tp = problems
    np.testing.assert_array_equal(to_np(tp.mask), np.asarray(jp.mask))
    np.testing.assert_array_equal(to_np(tp.obs), np.asarray(jp.obs))
    np.testing.assert_array_equal(to_np(tp.X0), np.asarray(jp.X0))
    np.testing.assert_allclose(to_np(tp.poses0), np.asarray(jp.poses0),
                               atol=1e-6)
    # tracks run through the window: landmarks seen in the last frame
    assert to_np(tp.mask)[-1].sum() > 20 and to_np(tp.mask)[0].sum() > 100


def test_build_window_problem_without_circle(window):
    tracks, motions, t_tracks, _, _ = window
    args = ("kp1_xy", "kp2_xy", "mlr_idx", "mlr_valid", "m11_idx",
            "m11_valid", "X")
    jp = jref.build_window_problem(*(getattr(tracks, a) for a in args),
                                   motions, N)
    tp = tref.build_window_problem(*(getattr(t_tracks, a) for a in args),
                                   to_torch(motions), N)
    np.testing.assert_array_equal(to_np(tp.mask), np.asarray(jp.mask))
    np.testing.assert_array_equal(to_np(tp.obs), np.asarray(jp.obs))


@pytest.mark.parametrize("count", [0, 1, 3, W])
def test_motion_prior_poses_equals_jax(window, count):
    _, motions, _, _, _ = window
    prior = np.asarray(motions) + np.float32(1e-3)
    want = jref.motion_prior_poses(motions, jnp.asarray(prior), count)
    got = tref.motion_prior_poses(to_torch(motions), to_torch(prior), count)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-6)


def test_masked_median_empty_is_inf():
    vals = np.arange(12, dtype=np.float32).reshape(3, 4)
    for mask in (np.zeros((3, 4), bool), vals > 4, vals < 1):
        want = float(jref._masked_median(jnp.asarray(vals),
                                         jnp.asarray(mask)))
        got = float(tref._masked_median(to_torch(vals), to_torch(mask)))
        assert got == want
    assert got == 0.0
    assert float(tref._masked_median(to_torch(vals),
                                     torch.zeros(3, 4, dtype=bool))) \
        == float("inf")


@pytest.mark.parametrize("shift", [0.0, 2e-3, -5e-3])
@pytest.mark.parametrize("margin", [0.9, 1.05])
def test_holdout_gate_equals_jax(window, problems, shift, margin):
    _, _, _, jcalib, calib = window
    jp, tp = problems
    cand = np.asarray(jp.poses0).copy()
    cand[1:, 5] += shift
    cand[1:, 1] -= shift / 20
    hold = np.asarray(jp.mask).copy()
    hold[0] = False
    want = jref.holdout_gate(jnp.asarray(cand), jp.poses0, jp.X0, jp.obs,
                             jnp.asarray(hold), jcalib, margin=margin)
    got = tref.holdout_gate(to_torch(cand), tp.poses0, tp.X0, tp.obs,
                            to_torch(hold), calib, margin=margin)
    assert bool(got[0]) == bool(want[0])
    np.testing.assert_allclose([float(got[1]), float(got[2])],
                               [float(want[1]), float(want[2])], rtol=1e-5)


def _prior(jp, strength):
    """A pose prior and weights as run_windowed_ba makes them: the
    first 3 poses anchored at a shifted copy, per-dof weights of the
    given strength."""
    f2 = 360.0 ** 2
    w6 = strength * np.array([70 * f2] * 3 + [70 * f2 / 225] * 3,
                             np.float32)
    weight = np.zeros((W, 6), np.float32)
    weight[:3] = w6
    prior = np.asarray(jp.poses0) + np.float32(1e-3)
    return prior, weight


@pytest.mark.parametrize("modulus", [0, 3])
@pytest.mark.parametrize("strength", [0.0, 1.0])
def test_refine_window_motions_equals_jax(window, problems, modulus,
                                          strength):
    _, _, _, jcalib, calib = window
    jp, tp = problems
    prior, weight = _prior(jp, strength)
    want = jref.refine_window_motions(
        jp, jcalib, iters=10, pose_prior=jnp.asarray(prior),
        prior_weight=jnp.asarray(weight), holdout_modulus=modulus)
    got = tref.refine_window_motions(
        tp, calib, iters=10, pose_prior=to_torch(prior),
        prior_weight=to_torch(weight), holdout_modulus=modulus)
    for name in ("ok", "holdout_ok", "cam_obs"):
        np.testing.assert_array_equal(to_np(getattr(got, name)),
                                      np.asarray(getattr(want, name)), name)
    np.testing.assert_allclose(to_np(got.motions), np.asarray(want.motions),
                               atol=1e-4)
    for name in ("initial_cost", "cost"):
        np.testing.assert_allclose(float(getattr(got, name)),
                                   float(getattr(want, name)), rtol=1e-4)
    # the medians are taken at the refined poses, which agree within
    # 1e-4, not at equal inputs as in test_holdout_gate_equals_jax:
    # measured 1.4e-5 apart (relative)
    np.testing.assert_allclose(
        [float(got.holdout_half0), float(got.holdout_half1)],
        [float(want.holdout_half0), float(want.holdout_half1)], rtol=1e-4)
    assert bool(got.ok) and float(got.cost) <= float(got.initial_cost)


def test_refine_frozen_landmarks_equals_jax(window, problems):
    _, _, _, jcalib, calib = window
    jp, tp = problems
    want = jref.refine_window_motions(jp, jcalib, freeze_landmarks=True)
    got = tref.refine_window_motions(tp, calib, freeze_landmarks=True)
    np.testing.assert_array_equal(to_np(got.cam_obs),
                                  np.asarray(want.cam_obs))
    assert bool(got.holdout_ok) == bool(want.holdout_ok)
    np.testing.assert_allclose(to_np(got.motions), np.asarray(want.motions),
                               atol=1e-4)
