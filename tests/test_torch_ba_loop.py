"""The composed BA + loop back-end of libviso_torch
(``pipeline/ba_loop.py``) against libviso_tpu's, on the JAX package's
window and loop verification draws.

The 48-frame circle of tests/test_ba_loop.py (416x160, radius 10 m, 512
slots), windows of 8 frames every 4, a keyframe every 4 frames, under the
gate (JAX: no window accepted) and without it (every window accepted):
the port closes JAX's loop 44 -> 0 with inliers within 2 % of JAX's, makes
the same window decisions and ok flags, and gives JAX's poses within 1e-3
m; the optimized endpoint is no farther from the truth than the BA
chain's.  A composed run resumed from an earlier snapshot (window
progress, keyframe store and loop edges) equals the uninterrupted run bit
for bit.
"""

import numpy as np
import pytest

from libviso_tpu.config import BAConfig as JBAConfig
from libviso_tpu.pipeline.ba_loop import run_windowed_ba_loop as jax_run
from libviso_torch.config import BAConfig, from_jax_config
from libviso_torch.pipeline.ba_loop import run_windowed_ba_loop
from libviso_torch.utils.checkpoint import CheckpointManager
from tests.test_ba_loop import LOOP_KW, _cfg, _circle_sequence
from tests.torch_parity import jax_loop_verify_gumbel, jax_window_gumbel

JCFG = _cfg()
CFG = from_jax_config(JCFG)
H, N = CFG.ransac.num_hypotheses, CFG.detector.num_slots
SEED = LOOP_KW["seed"]


def _draws():
    vshape = (max(256, H), min(256, N))
    return dict(
        draws=lambda w, n: jax_window_gumbel(SEED, w, n, H, N),
        verify_draws=lambda t, it: jax_loop_verify_gumbel(SEED, t, it,
                                                          *vshape))


@pytest.fixture(scope="module")
def seq():
    return _circle_sequence()


@pytest.fixture(scope="module")
def runs(seq, tmp_path_factory):
    """{gate: (JAX result, port result)}; the gated port run snapshots
    every window (kept for the resume test)."""
    out = {}
    for gate in (True, False):
        want = jax_run(list(seq.frames), seq.P1, seq.P2, JCFG,
                       ba=JBAConfig(window=8, stride=4, gate=gate),
                       **LOOP_KW)
        ckpt = (CheckpointManager(str(tmp_path_factory.mktemp("ck")),
                                  every=1, keep=100) if gate else None)
        got = run_windowed_ba_loop(
            list(seq.frames), seq.P1, seq.P2, CFG,
            ba=BAConfig(window=8, stride=4, gate=gate), device="cpu",
            checkpoint=ckpt, **LOOP_KW, **_draws())
        out[gate] = (want, got, ckpt)
    return out


def _end_error(P, gt):
    return float(np.linalg.norm(P[-1, :3, 3] - gt[-1, :3, 3]))


@pytest.mark.parametrize("gate", [True, False])
def test_loop_and_windows_equal_jax(runs, gate):
    want, got, _ = runs[gate]
    assert [(le.frame_new, le.frame_old) for le in got.loops] == \
        [(le.frame_new, le.frame_old) for le in want.loops] == [(44, 0)]
    n_got, n_want = got.loops[0].num_inliers, want.loops[0].num_inliers
    assert abs(n_got - n_want) <= 0.02 * n_want, (n_got, n_want)
    flags = [c[2] for c in got.window_costs]
    assert flags == [c[2] for c in want.window_costs]
    assert len(flags) == 11 and all(f != gate for f in flags)
    np.testing.assert_array_equal(got.frame_ok, want.frame_ok)
    assert got.frame_ok[1:].all()
    assert got.graph_cost[1] < got.graph_cost[0]


@pytest.mark.parametrize("gate", [True, False])
def test_poses_equal_jax(runs, seq, gate):
    want, got, _ = runs[gate]
    for name in ("poses_vo", "poses_ba", "poses"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   atol=1e-3, err_msg=name)
    if gate:   # no window accepted: the BA chain is the VO chain
        np.testing.assert_array_equal(got.poses_ba, got.poses_vo)
    gt = seq.gt_poses
    assert _end_error(got.poses, gt) <= _end_error(got.poses_ba, gt)


def test_composed_resume_bit_exact(runs, seq):
    """Snapshots after window 6 are dropped; the rerun restores window
    progress, the keyframe store and the loop edges and recomputes
    windows 6-10 (the loop at frame 44 among them)."""
    import os

    _, full, ckpt = runs[True]
    names = sorted(os.listdir(ckpt.directory))
    assert len(names) == 11     # one a window (the last also at the end)
    for name in names[6:]:
        os.remove(os.path.join(ckpt.directory, name))
    resumed = run_windowed_ba_loop(
        list(seq.frames), seq.P1, seq.P2, CFG,
        ba=BAConfig(window=8, stride=4), device="cpu", checkpoint=ckpt,
        **LOOP_KW, **_draws())
    assert resumed.processed == 48 - 24
    for name in ("poses", "poses_ba", "poses_vo", "motions", "frame_ok"):
        np.testing.assert_array_equal(getattr(resumed, name),
                                      getattr(full, name), name)
    assert resumed.window_costs == full.window_costs
    assert resumed.graph_cost == full.graph_cost
    assert [(le.frame_new, le.frame_old, le.num_inliers, le.tr.tolist())
            for le in resumed.loops] == \
        [(le.frame_new, le.frame_old, le.num_inliers, le.tr.tolist())
         for le in full.loops]
