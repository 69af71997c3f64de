"""The loop-closure entry points of the port's CLI, on the CPU.

``kitti --loop-closure`` on the mini KITTI tree of
``tests/test_torch_pipeline.py`` (6 frames of 416x160, a keyframe every 2
frames, candidates from a gap of 4: on the straight drive keyframe 4
still sees keyframe 0's scene and verifies against it),
with loop checkpoints under checkpoints/loop and a resumed rerun; ``synth
--world-loop`` on the plaza drive; ``mono --sim3-loop`` on a folder of the
same sprite frames.  Each prints the JAX CLI's JSON keys
(libviso_tpu/cli.py: ``_cmd_kitti``'s loop mode, ``_cmd_synth``,
``_cmd_mono``) and the port's ``device``.  Both KITTI-mode runs use the
default 1280-slot configuration, about a second a frame on one core.
"""

import json
import os

import numpy as np
import pytest
from PIL import Image

from libviso_torch import cli
from libviso_torch.synthetic import generate_sequence
from tests.test_torch_pipeline import _mini_kitti

KITTI_KEYS = {"sequence", "frames", "solved", "fps", "poses", "loops",
              "graph_cost", "health", "device"}
MONO_KEYS = {"frames", "solved", "fps", "poses", "note", "loops",
             "keyframes", "graph_cost", "device"}
LOOP_ARGS = ["--loop-closure", "--keyframe-every", "2", "--loop-min-gap", "4",
             "--loop-min-matches", "20", "--loop-min-inliers", "12"]


@pytest.fixture(scope="module")
def kitti_home(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti")
    _mini_kitti(root)
    return root


def _run(capsys, *argv):
    cli.main([*argv, "--device", "cpu"])
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_kitti_loop_closure(kitti_home, capsys):
    out = _run(capsys, "kitti", "loopsha", "77", "--kitti-home",
               str(kitti_home), *LOOP_ARGS, "--checkpoint-every", "3",
               "--loop-eviction", "fifo", "--loop-robust", "huber")
    assert set(out) == KITTI_KEYS
    assert out["frames"] == 6 and out["solved"] == 5
    assert [(le["new"], le["old"]) for le in out["loops"]] == [(4, 0)]
    assert set(out["loops"][0]) == {"new", "old", "inliers", "edge_scale"}
    assert out["graph_cost"][1] <= out["graph_cost"][0]
    assert out["health"]["failed_frames"] == 0
    rows = np.loadtxt(out["poses"])
    assert rows.shape == (6, 12)
    result = os.path.join(kitti_home, "results", "77", "loopsha")
    lines = [json.loads(x) for x in
             open(os.path.join(result, "metrics.jsonl")).read().splitlines()]
    frames = [x for x in lines if "frame" in x]
    cands = [x["loop_candidate"] for x in lines if "loop_candidate" in x]
    assert [x["frame"] for x in frames] == list(range(6))
    assert cands and all({"frame_new", "frame_old", "score", "ok",
                          "num_inliers"} <= set(c) for c in cands)
    assert os.listdir(os.path.join(result, "checkpoints", "loop"))

    # a rerun resumes from the final snapshot: nothing computed, the same
    # poses
    again = _run(capsys, "kitti", "loopsha", "77", "--kitti-home",
                 str(kitti_home), *LOOP_ARGS, "--checkpoint-every", "3",
                 "--loop-eviction", "fifo", "--loop-robust", "huber")
    np.testing.assert_array_equal(np.loadtxt(again["poses"]), rows)
    # another loop knob is another fingerprint: the old snapshot is refused
    with pytest.raises(ValueError, match="fingerprint"):
        cli.main(["kitti", "loopsha", "77", "--kitti-home", str(kitti_home),
                  *LOOP_ARGS, "--checkpoint-every", "3", "--device", "cpu"])


def test_cli_kitti_loop_closure_takes_one_sequence(kitti_home):
    with pytest.raises(SystemExit, match="one sequence"):
        cli.main(["kitti", "sha", "77,78", "--kitti-home", str(kitti_home),
                  "--loop-closure", "--device", "cpu"])


def test_cli_synth_world_loop(capsys):
    """The plaza circuit in --frames frames: 3 frames span the circle at
    180 degrees a frame, which no frame-to-frame matcher tracks; this
    drives the flag's path (render, odometry, JSON), and chip_smoke.py
    phase 14 drives it at a trackable rate on the card."""
    out = _run(capsys, "synth", "--world-loop", "--frames", "3",
               "--metric", "l1", "--backend", "sweep")
    assert set(out) == {"frames", "device", "solved", "ate_rmse_m",
                        "rpe_trans_mean_m", "rpe_rot_mean_rad", "fps"}
    assert out["frames"] == 3 and 0 <= out["solved"] <= 2
    assert np.isfinite(out["ate_rmse_m"])


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("mono_loop")
    seq = generate_sequence(num_frames=5, num_points=600, seed=13, width=416,
                            height=160, speed=0.6, yaw_rate=0.01)
    for i, (left, _) in enumerate(seq.frames):
        Image.fromarray(left.astype(np.uint8)).save(root / f"{i:06d}.png")
    np.savetxt(root / "K.txt", seq.P1[:, :3])
    return root


def test_cli_mono_sim3_loop(folder, capsys):
    """Keyframes at frames 2 and 4 with a gap of 2 allowed: keyframe 4 is
    matched against keyframe 2 and their landmark clouds verify (a
    revisit of the same street, 19 inliers, scale 1.135 on the CPU), so
    the Sim(3) graph runs and lowers its cost."""
    out = _run(capsys, "mono", "--image-mask", str(folder / "%06d.png"),
               "--calib", str(folder / "K.txt"), "--out",
               str(folder / "poses.txt"), "--sim3-loop", "--kf-every", "2",
               "--loop-min-gap", "2")
    assert set(out) == MONO_KEYS
    assert out["frames"] == 5 and out["solved"] == 4
    assert out["keyframes"] == 2
    assert [(le["frame_old"], le["frame_new"]) for le in out["loops"]] == \
        [(2, 4)]
    assert set(out["loops"][0]) == {"frame_old", "frame_new", "inliers",
                                    "scale"}
    assert out["graph_cost"][1] <= out["graph_cost"][0]
    rows = np.loadtxt(out["poses"])
    assert rows.shape == (5, 12) and np.isfinite(rows).all()
