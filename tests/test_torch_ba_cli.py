"""``kitti --ba-window`` of the port's CLI, alone and with
``--loop-closure``, on the CPU.

Two runs on the mini KITTI tree of ``tests/test_torch_pipeline.py`` (6
frames of 416x160, windows of 4 frames every 2) print the JAX CLI's JSON
keys (libviso_tpu/cli.py, ``_cmd_kitti``'s BA and composed modes) and the
port's ``device``, write metrics.jsonl and checkpoints under
checkpoints/ba or checkpoints/ba_loop, and resume from them.  Every BA
flag reaches the ``BAConfig`` the pipeline functions get (checked with
them replaced by a recorder), in both modes; ``--keep-on-failure`` is
refused before any frame is read.
"""

import json
import os
import types

import numpy as np
import pytest

from libviso_torch import cli
from libviso_torch.config import BAConfig
from libviso_torch.pipeline import ba_loop, windowed
from tests.test_torch_pipeline import _mini_kitti

BA_KEYS = {"sequence", "frames", "device", "solved", "fps", "poses",
           "ba_windows", "ba_improved", "health"}
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


def _metrics(kitti_home, sha):
    path = os.path.join(kitti_home, "results", "77", sha, "metrics.jsonl")
    return [json.loads(x) for x in open(path).read().splitlines()]


def test_cli_kitti_ba_window(kitti_home, capsys):
    argv = ["kitti", "basha", "77", "--kitti-home", str(kitti_home),
            "--ba-window", "4", "--checkpoint-every", "1"]
    out = _run(capsys, *argv)
    assert set(out) == BA_KEYS
    assert out["frames"] == 6 and out["solved"] == 5
    assert out["ba_windows"] == 2 and 0 <= out["ba_improved"] <= 2
    assert out["device"] == "cpu" and out["health"]["failed_frames"] == 0
    rows = np.loadtxt(out["poses"])
    assert rows.shape == (6, 12)
    assert [r["frame"] for r in _metrics(kitti_home, "basha")] == \
        list(range(6))
    ckdir = os.path.join(kitti_home, "results", "77", "basha",
                         "checkpoints", "ba")
    assert os.listdir(ckdir)
    # a rerun resumes from the final snapshot: the same poses
    again = _run(capsys, *argv)
    np.testing.assert_array_equal(np.loadtxt(again["poses"]), rows)


def test_cli_kitti_ba_window_with_loop_closure(kitti_home, capsys):
    argv = ["kitti", "blsha", "77", "--kitti-home", str(kitti_home),
            "--ba-window", "4", *LOOP_ARGS, "--checkpoint-every", "1"]
    out = _run(capsys, *argv)
    assert set(out) == BA_KEYS | {"loops", "graph_cost"}
    assert out["frames"] == 6 and out["solved"] == 5
    assert out["ba_windows"] == 2
    # on the straight drive keyframe 4 still sees keyframe 0's scene
    assert [(le["new"], le["old"]) for le in out["loops"]] == [(4, 0)]
    assert set(out["loops"][0]) == {"new", "old", "inliers", "edge_scale"}
    assert out["graph_cost"][1] <= out["graph_cost"][0]
    lines = _metrics(kitti_home, "blsha")
    assert [x["frame"] for x in lines if "frame" in x] == list(range(6))
    assert any("loop_candidate" in x for x in lines)
    ckdir = os.path.join(kitti_home, "results", "77", "blsha",
                         "checkpoints", "ba_loop")
    assert os.listdir(ckdir)
    again = _run(capsys, *argv)
    np.testing.assert_array_equal(np.loadtxt(again["poses"]),
                                  np.loadtxt(out["poses"]))
    assert again["loops"] == out["loops"]


def test_keep_on_failure_with_ba_window_is_refused(kitti_home):
    with pytest.raises(SystemExit, match="--keep-on-failure"):
        cli.main(["kitti", "sha", "77", "--kitti-home", str(kitti_home),
                  "--ba-window", "4", "--keep-on-failure", "--device",
                  "cpu"])


def test_stride_above_window_is_refused(kitti_home):
    with pytest.raises(ValueError, match="stride"):
        cli.main(["kitti", "sha", "77", "--kitti-home", str(kitti_home),
                  "--ba-window", "4", "--ba-stride", "6", "--device", "cpu"])


@pytest.fixture
def recorded(monkeypatch):
    """Replace both pipeline functions by a recorder of their keyword
    arguments that returns an empty 6-frame result."""
    calls = []

    def fake(frames, P1, P2, cfg, **kw):
        calls.append(kw)
        T = len(list(frames))
        return types.SimpleNamespace(
            poses=np.tile(np.eye(4), (T, 1, 1)),
            frame_ok=np.arange(T) > 0, window_costs=[], processed=T,
            loops=[], graph_cost=(0.0, 0.0), candidates=[],
            loop_edge_scale=np.zeros(0))

    monkeypatch.setattr(windowed, "run_windowed_ba", fake)
    monkeypatch.setattr(ba_loop, "run_windowed_ba_loop", fake)
    return calls


@pytest.mark.parametrize("composed", [False, True],
                         ids=["alone", "with-loop-closure"])
@pytest.mark.parametrize("flags,want", [
    (["--ba-window", "6"], dict(window=6, stride=3)),
    (["--ba-window", "1"], dict(window=1, stride=1)),
    (["--ba-stride", "1"], dict(window=4, stride=1)),
    (["--ba-prior", "0.5"], dict(prior_strength=0.5)),
    (["--ba-outlier-px", "20"], dict(outlier_px=20.0)),
    (["--ba-rerank-px", "3"], dict(rerank_px=3.0)),
    (["--ba-no-gate"], dict(gate=False)),
    (["--ba-holdout", "3"], dict(holdout_modulus=3)),
    (["--ba-gate-margin", "0.8"], dict(gate_margin=0.8)),
    (["--ba-min-cam-obs", "12"], dict(min_cam_obs=12)),
], ids=lambda x: " ".join(x) if isinstance(x, list) else None)
def test_ba_flags_reach_the_config(kitti_home, capsys, recorded, flags,
                                   want, composed):
    argv = ["kitti", "flagsha", "77", "--kitti-home", str(kitti_home),
            "--ba-window", "4", *flags, "--backend", "fused", "--metric",
            "l1", "--seed", "3", "--checkpoint-every", "2"]
    if composed:
        argv += LOOP_ARGS
    out = _run(capsys, *argv)
    kw, = recorded
    defaults = dict(window=4, stride=2, prior_strength=1.0, outlier_px=30.0,
                    rerank_px=2.0, gate=True, holdout_modulus=0,
                    gate_margin=0.90, min_cam_obs=24)
    assert kw["ba"] == BAConfig(**{**defaults, **want})
    assert (kw["backend"], kw["seed"], kw["device"]) == ("fused", 3, "cpu")
    assert kw["fingerprint_scope"] == "77:0:None"
    mode = "ba_loop" if composed else "ba"
    assert kw["checkpoint"].every == 2 and kw["checkpoint"].directory \
        == os.path.join(str(kitti_home), "results", "77", "flagsha",
                        "checkpoints", mode)
    if composed:
        assert (kw["keyframe_every"], kw["min_gap"], kw["min_matches"],
                kw["min_inliers"]) == (2, 4, 20, 12)
    assert set(out) == BA_KEYS | ({"loops", "graph_cost"} if composed
                                  else set())
