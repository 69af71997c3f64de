"""The step's options in libviso_torch against libviso_tpu:
``hold_state_on_failure`` / ``keep_features_on_failure``, ``debug=True``
and the debug dumps.

States are carried across from the JAX package with
``state_from_leaves`` (its pytree leaves as numpy arrays) and compared leaf
by leaf, exactly: the hold is a select.  The end-to-end runs use JAX's
RANSAC draws; discrete stats are equal and motions within 1e-4 (float32
normal equations summed in different orders, as in
tests/test_torch_pipeline.py).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libviso_tpu.config import DetectorConfig as JDetectorConfig
from libviso_tpu.config import PipelineConfig as JPipelineConfig
from libviso_tpu.config import RansacConfig as JRansacConfig
from libviso_tpu.ops.features import Keypoints as JKeypoints
from libviso_tpu.pipeline import stereo as jstereo
from libviso_torch.config import from_jax_config
from libviso_torch.pipeline import multistream as tms
from libviso_torch.pipeline import stereo as tstereo
from libviso_torch.synthetic import generate_sequence
from tests.torch_parity import jax_frame_gumbel

KEYS = ("frame", "ok", "num_kp1", "num_lr", "num_circle", "num_inliers")
JAX_CFG = JPipelineConfig(
    detector=JDetectorConfig(max_features=120, nbinx=6, nbiny=2,
                             num_slots=128),
    ransac=JRansacConfig(num_hypotheses=16, gn_iters=10),
    keep_features_on_failure=True, max_keep_age=2).with_metric("l1")
CFG = from_jax_config(JAX_CFG)
H, N = CFG.ransac.num_hypotheses, CFG.detector.num_slots


def _jax_state(rng, fail_age, empty=False):
    n, d = 16, 8

    def kp():
        valid = np.zeros(n, bool) if empty else rng.random(n) > 0.3
        return JKeypoints(
            xy=jnp.asarray(rng.uniform(0, 99, (n, 2)), jnp.float32),
            response=jnp.asarray(rng.random(n), jnp.float32),
            valid=jnp.asarray(valid))

    return jstereo.FrameState(
        kp1=kp(), kp2=kp(),
        d1=jnp.asarray(rng.normal(size=(n, d)), jnp.float32),
        d2=jnp.asarray(rng.normal(size=(n, d)), jnp.float32),
        match_lr=jnp.asarray(rng.integers(-1, n, n), jnp.int32),
        X=jnp.asarray(rng.normal(size=(n, 3)), jnp.float32),
        X_valid=jnp.asarray(rng.random(n) > 0.5),
        fail_age=jnp.asarray(fail_age, jnp.int32))


def _leaves(jstate):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(jstate)]


# (ok, held state empty, fail_age, expect the old state kept); max_age 3
HOLD_CASES = [(False, False, 0, True), (True, False, 0, False),
              (False, True, 0, False), (False, False, 3, False)]


@pytest.mark.parametrize("ok,empty,age,kept", HOLD_CASES)
def test_hold_state_on_failure_equals_jax(ok, empty, age, kept):
    rng = np.random.default_rng(age + 2 * ok + 4 * empty)
    jold, jnew = _jax_state(rng, age, empty), _jax_state(rng, 0)
    want = jstereo.hold_state_on_failure(
        jold, jnew, jnp.asarray(ok), jnp.any(jold.kp1.valid), 3)
    told = tstereo.state_from_leaves(_leaves(jold))
    tnew = tstereo.state_from_leaves(_leaves(jnew))
    got = tstereo.hold_state_on_failure(
        told, tnew, torch.tensor(ok), told.kp1.valid.any(-1), 3)
    for a, b in zip(tstereo.state_to_leaves(got), _leaves(want)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert int(got.fail_age) == (age + 1 if kept else 0)
    src = told if kept else tnew
    assert torch.equal(got.d1, src.d1)


def test_hold_state_with_a_stream_axis_equals_the_single_calls():
    """keep of shape (S,): the four cases as four streams of one call."""
    rng = np.random.default_rng(0)
    olds, news, singles = [], [], []
    for ok, empty, age, _ in HOLD_CASES:
        told = tstereo.state_from_leaves(_leaves(_jax_state(rng, age, empty)))
        tnew = tstereo.state_from_leaves(_leaves(_jax_state(rng, 0)))
        olds.append(told)
        news.append(tnew)
        singles.append(tstereo.hold_state_on_failure(
            told, tnew, torch.tensor(ok), told.kp1.valid.any(-1), 3))
    old, new = tms.stack_states(olds), tms.stack_states(news)
    got = tstereo.hold_state_on_failure(
        old, new, torch.tensor([c[0] for c in HOLD_CASES]),
        old.kp1.valid.any(-1), 3)
    want = tms.stack_states(singles)
    for a, b in zip(tstereo.state_leaves(got), tstereo.state_leaves(want)):
        assert torch.equal(a, b)
    assert got.fail_age.tolist() == [1, 0, 0, 0]


def test_state_leaves_round_trip_and_dtypes():
    rng = np.random.default_rng(1)
    leaves = _leaves(_jax_state(rng, 2))
    state = tstereo.state_from_leaves(leaves)
    assert state.match_lr.dtype == torch.long
    assert state.fail_age.dtype == torch.int32
    assert state.kp1.valid.dtype == torch.bool
    for a, b in zip(tstereo.state_to_leaves(state), leaves):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def dropped():
    """Six frames with frame 3 blanked (a transient sensor dropout)."""
    seq = generate_sequence(num_frames=6, num_points=300, width=160,
                            height=96, f=120.0, seed=3)
    frames = list(seq.frames)
    frames[3] = (np.zeros_like(frames[3][0]), np.zeros_like(frames[3][1]))
    return seq, frames


def _draws(t):
    return jax_frame_gumbel(0, t, H, N)


def test_keep_features_on_failure_end_to_end_equals_jax(dropped):
    seq, frames = dropped
    jres = jstereo.run_stereo_sequence(frames, seq.P1, seq.P2, JAX_CFG,
                                       seed=0, backend="xla")
    tres = tstereo.run_stereo_sequence(frames, seq.P1, seq.P2, CFG, seed=0,
                                       device="cpu", draws=_draws)
    assert [{k: s[k] for k in KEYS} for s in tres.stats] == \
        [{k: s[k] for k in KEYS} for s in jres.stats]
    np.testing.assert_allclose(tres.motions, jres.motions, atol=1e-4)
    # the blank frame fails; the next one matches against the held frame 2
    assert tres.frame_ok.tolist() == [False, True, True, False, True, True]
    plain = tstereo.run_stereo_sequence(
        frames, seq.P1, seq.P2,
        dataclasses.replace(CFG, keep_features_on_failure=False), seed=0,
        device="cpu", draws=_draws)
    assert plain.frame_ok.tolist() == [False, True, True, False, False, True]
    # the held frame spans two steps of the drive
    assert abs(tres.motions[4][5]) > 1.5 * abs(tres.motions[2][5])


def test_keep_features_when_serving_equals_solo(dropped):
    """One hold decision per stream: a stream with a dropout beside one
    without, each equal to its solo run."""
    seq, frames = dropped
    solos = [tstereo.run_stereo_sequence(fr, seq.P1, seq.P2, CFG, seed=s,
                                         device="cpu")
             for s, fr in enumerate((frames, seq.frames))]
    multi = tms.run_multistream([frames, seq.frames], [seq.P1] * 2,
                                [seq.P2] * 2, CFG, seeds=[0, 1],
                                device="cpu")
    for got, solo in zip(multi, solos):
        assert [{k: s[k] for k in KEYS} for s in got.stats] == \
            [{k: s[k] for k in KEYS} for s in solo.stats]
        np.testing.assert_allclose(got.motions, solo.motions, rtol=0,
                                   atol=5e-6)
    assert multi[0].frame_ok.tolist() == [False, True, True, False, True,
                                          True]
    assert multi[1].frame_ok[1:].all()


def test_debug_step_returns_this_frames_tensors(dropped):
    seq, frames = dropped
    calib = tstereo.Calib.from_projections(seq.P1, seq.P2)
    F = torch.as_tensor(tstereo.F_from_P_host(seq.P1, seq.P2),
                        dtype=torch.float32)
    step = tstereo.build_frame_step(calib, F, CFG, debug=True)
    plain = tstereo.build_frame_step(calib, F, CFG)
    state = tstereo.empty_state(CFG)
    for t in range(4):
        im1, im2 = (torch.tensor(x) for x in frames[t])
        prev = state
        state, out, dbg = step(prev, im1, im2, _draws(t))
        _, want = plain(prev, im1, im2, _draws(t))
        assert all(torch.equal(a, b) for a, b in zip(out, want))
        assert dbg.predict.shape == dbg.obs.shape == (N, 4)
        assert int(dbg.inliers.sum()) == int(out.num_inliers)
        assert int(dbg.circle.count) == int(out.num_circle)
    # frame 3 failed and the state holds frame 2, but the debug tensors
    # are frame 3's own (no detections on a blank frame)
    assert not bool(out.ok) and int(state.fail_age) == 1
    assert int(dbg.kp1.valid.sum()) == 0 and int(state.kp1.valid.sum()) > 0
    assert (dbg.match_lr == -1).all()


def test_debug_dumps_write_the_jax_file_names(dropped, tmp_path):
    seq, frames = dropped
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jres = jstereo.run_stereo_sequence(frames[:3], seq.P1, seq.P2, JAX_CFG,
                                       seed=0, backend="xla",
                                       dbg_dir=str(jdir))
    tres = tstereo.run_stereo_sequence(frames[:3], seq.P1, seq.P2, CFG,
                                       seed=0, device="cpu", draws=_draws,
                                       dbg_dir=str(tdir), chunk=2)
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    assert "circ_match_001.jpg" in os.listdir(tdir)
    assert "reproj1_002.jpg" in os.listdir(tdir)
    assert [s["num_inliers"] for s in tres.stats] == \
        [s["num_inliers"] for s in jres.stats]
