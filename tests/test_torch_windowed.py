"""The windowed BA of libviso_torch (``pipeline/windowed.py``)
against libviso_tpu's, on the JAX package's window draws.

- World frames (``generate_world_sequence(seed=6)``, 416x160, 12 frames,
  tests/test_world.py's ``world_cfg``), window 6, stride 3, the gate on:
  JAX accepts window 0 (paired ratios 0.795 / 0.787) and rejects windows 1
  and 2 (0.949 / 0.928, 0.949 / 0.948); every ratio is at least 0.028 from
  the 0.90 margin, so the port must make the same decisions, give the
  same ok flags and an ATE within 1e-3 m of JAX's.
- tests/test_windowed.py's 12-frame sprite sequence with the gate off:
  every window accepted, the same flags, poses within 1e-3 m.
- A resume from a checkpoint is bit-exact; a single window covers a short
  sequence; ``stride > window`` raises.
"""

import numpy as np
import pytest

from libviso_tpu.config import BAConfig as JBAConfig
from libviso_tpu.config import DetectorConfig, PipelineConfig, RansacConfig
from libviso_tpu.pipeline import windowed as jwin
from libviso_tpu.synthetic import generate_sequence
from libviso_tpu.synthetic_world import generate_world_sequence
from libviso_torch.config import BAConfig, from_jax_config
from libviso_torch.pipeline import windowed as twin
from libviso_torch.utils.checkpoint import CheckpointManager
from libviso_torch.utils.metrics import ate_rmse
from tests.torch_parity import jax_window_gumbel

WORLD_CFG = PipelineConfig(
    detector=DetectorConfig(max_features=480, nbinx=12, nbiny=4,
                            num_slots=512),
    ransac=RansacConfig(num_hypotheses=32))
SPRITE_CFG = PipelineConfig(
    detector=DetectorConfig(max_features=480, nbinx=8, nbiny=4,
                            num_slots=512),
    ransac=RansacConfig(num_hypotheses=32, gn_iters=50))
TINY_CFG = PipelineConfig(
    detector=DetectorConfig(max_features=120, nbinx=6, nbiny=2,
                            num_slots=128),
    ransac=RansacConfig(num_hypotheses=8, gn_iters=10))


def _pair(seq, cfg, seed, **kw):
    """The JAX run and the port's on JAX's window draws."""
    H, N = cfg.ransac.num_hypotheses, cfg.detector.num_slots
    frames = list(seq.frames)
    want = jwin.run_windowed_ba(frames, seq.P1, seq.P2, cfg, seed=seed,
                                **{k: JBAConfig(**v) if k == "ba" else v
                                   for k, v in kw.items()})
    got = twin.run_windowed_ba(
        frames, seq.P1, seq.P2, from_jax_config(cfg), seed=seed,
        device="cpu",
        draws=lambda w, n: jax_window_gumbel(seed, w, n, H, N),
        **{k: BAConfig(**v) if k == "ba" else v for k, v in kw.items()})
    return want, got


@pytest.fixture(scope="module")
def world():
    seq = generate_world_sequence(seed=6, width=416, height=160,
                                  num_frames=12)
    return seq, *_pair(seq, WORLD_CFG, 6, ba=dict(window=6, stride=3))


@pytest.fixture(scope="module")
def sprite():
    seq = generate_sequence(num_frames=12, num_points=500, seed=31,
                            width=416, height=160, speed=0.6, f=360.0)
    return seq, *_pair(seq, SPRITE_CFG, 0, window=6, stride=3, ba_iters=10,
                       gate=False)


@pytest.mark.parametrize("T,window,stride", [
    (20, 8, 4), (12, 6, 3), (13, 6, 3), (5, 8, 4), (8, 8, 8), (9, 4, 1),
    (1, 4, 2)])
def test_window_starts_equal_jax(T, window, stride):
    got = twin.window_starts(T, window, stride)
    assert got == jwin.window_starts(T, window, stride)
    covered = set()
    for s in got:
        covered |= set(range(s, min(s + window, T)))
    assert covered == set(range(T))


def test_stride_above_window_raises():
    seq = generate_sequence(num_frames=3, num_points=50, width=160,
                            height=96, f=120.0, seed=5)
    with pytest.raises(ValueError, match="stride"):
        twin.run_windowed_ba(seq.frames, seq.P1, seq.P2, TINY_CFG,
                             window=4, stride=8, device="cpu")


@pytest.mark.parametrize("kw", [dict(window=4, stride=8),
                                dict(holdout_modulus=-1)])
def test_ba_config_validates_as_jax(kw):
    with pytest.raises(ValueError):
        JBAConfig(**kw)
    with pytest.raises(ValueError):
        BAConfig(**kw)


def test_world_gate_accepts_and_rejects_as_jax(world):
    seq, want, got = world
    accepted = [c[2] for c in got.window_costs]
    assert accepted == [c[2] for c in want.window_costs] \
        == [True, False, False]
    np.testing.assert_array_equal(got.frame_ok, want.frame_ok)
    assert got.frame_ok[1:].all()
    # costs and gate ratios end to end: the front-ends' VO motions start
    # the BA 1e-4 apart (tests/test_torch_batched.py), measured 1.7e-4
    # (relative) apart at the end
    for g, w in zip(got.window_costs, want.window_costs):
        np.testing.assert_allclose(g[:2], w[:2], rtol=1e-3)
        np.testing.assert_allclose(g[3:], w[3:], rtol=1e-3)


def test_world_trajectory_equals_jax(world):
    seq, want, got = world
    ate = ate_rmse(got.poses, seq.gt_poses)
    assert abs(ate - ate_rmse(want.poses, seq.gt_poses)) <= 1e-3
    # the accepted window improves on VO (JAX: 0.0534 -> 0.0287 m)
    assert ate < ate_rmse(got.poses_vo, seq.gt_poses)
    np.testing.assert_allclose(got.poses, want.poses, atol=1e-3)
    np.testing.assert_allclose(got.poses_vo, want.poses_vo, atol=1e-3)
    assert got.processed == 12


def test_sprite_gate_off_equals_jax(sprite):
    seq, want, got = sprite
    assert all(c[2] for c in got.window_costs)
    assert [c[2] for c in got.window_costs] == \
        [c[2] for c in want.window_costs]
    assert all(c[1] <= c[0] for c in got.window_costs)
    np.testing.assert_array_equal(got.frame_ok, want.frame_ok)
    assert got.frame_ok[1:].all()
    np.testing.assert_allclose(got.poses, want.poses, atol=1e-3)
    np.testing.assert_allclose(got.motions, want.motions, atol=1e-4)
    ate_vo = ate_rmse(got.poses_vo, seq.gt_poses)
    assert ate_rmse(got.poses, seq.gt_poses) < ate_vo < 0.15


def test_checkpoint_resume_bit_exact(tmp_path):
    """A run cut after its second window and resumed equals the
    uninterrupted run bit for bit (window w's draws depend on (seed, w)),
    and a snapshot of another configuration is refused."""
    seq = generate_sequence(num_frames=8, num_points=200, width=160,
                            height=96, f=120.0, seed=5)
    kw = dict(window=4, stride=2, ba_iters=4, seed=0, device="cpu")
    full = twin.run_windowed_ba(seq.frames, seq.P1, seq.P2, TINY_CFG, **kw)
    mgr = CheckpointManager(str(tmp_path / "ck"), every=1, keep=10)
    twin.run_windowed_ba(seq.frames, seq.P1, seq.P2, TINY_CFG,
                         checkpoint=mgr, **kw)
    # cut: drop the snapshots after window 2
    for name in sorted(p.name for p in (tmp_path / "ck").iterdir())[2:]:
        (tmp_path / "ck" / name).unlink()
    resumed = twin.run_windowed_ba(seq.frames, seq.P1, seq.P2, TINY_CFG,
                                   checkpoint=mgr, **kw)
    assert resumed.processed == 8 - 4 and full.processed == 8
    np.testing.assert_array_equal(resumed.motions, full.motions)
    np.testing.assert_array_equal(resumed.frame_ok, full.frame_ok)
    np.testing.assert_array_equal(resumed.poses, full.poses)
    np.testing.assert_array_equal(resumed.poses_vo, full.poses_vo)
    assert resumed.window_costs == full.window_costs
    with pytest.raises(ValueError, match="fingerprint"):
        twin.run_windowed_ba(seq.frames, seq.P1, seq.P2, TINY_CFG,
                             checkpoint=mgr, **{**kw, "seed": 1})


def test_single_window_equals_jax():
    """A sequence no longer than the window is one window from frame 0."""
    seq = generate_sequence(num_frames=5, num_points=200, width=160,
                            height=96, f=120.0, seed=5)
    want, got = _pair(seq, TINY_CFG, 2, window=8, stride=4, ba_iters=4)
    assert len(got.window_costs) == len(want.window_costs) == 1
    assert got.window_costs[0][2] == want.window_costs[0][2]
    np.testing.assert_array_equal(got.frame_ok, want.frame_ok)
    np.testing.assert_allclose(got.poses, want.poses, atol=1e-3)


def test_cuda_without_a_card_raises(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    seq = generate_sequence(num_frames=3, num_points=50, width=160,
                            height=96, f=120.0, seed=5)
    with pytest.raises(RuntimeError, match="--device cpu"):
        twin.run_windowed_ba(seq.frames, seq.P1, seq.P2, TINY_CFG)
