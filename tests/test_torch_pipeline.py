"""The whole stereo slice of libviso_torch against libviso_tpu.

Both packages run one synthetic sequence with metric 'l1' (JAX with its
XLA backend, whose L1 is the kernel's reference) and the same RANSAC
draws (JAX's, injected into the port): every frame's ok flag and match,
circle and inlier counts are equal, and the trajectories' ATE differ by
less than 1e-3 m.  The port's CLI drivers run on the CPU; the card's run
is held against the CPU's by tests/test_torch_cuda.py.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from libviso_tpu.config import PipelineConfig
from libviso_tpu.pipeline import run_stereo_sequence as jax_run
from libviso_tpu.synthetic import generate_sequence
from libviso_tpu.utils.metrics import ate_rmse
from libviso_torch import cli
from libviso_torch.config import from_jax_config
from libviso_torch.pipeline import stereo as tstereo
from tests.torch_parity import jax_frame_gumbel

KEYS = ("ok", "num_lr", "num_circle", "num_inliers")


@pytest.fixture(scope="module")
def seq():
    return generate_sequence(num_frames=6, num_points=500, seed=3, width=416,
                             height=160)


@pytest.fixture(scope="module")
def runs(seq):
    cfg = PipelineConfig().with_metric("l1")
    jres = jax_run(seq.frames, seq.P1, seq.P2, cfg, seed=0, backend="xla")
    H, N = cfg.ransac.num_hypotheses, cfg.detector.num_slots
    tres = tstereo.run_stereo_sequence(
        seq.frames, seq.P1, seq.P2, from_jax_config(cfg), seed=0,
        device="cpu", draws=lambda t: jax_frame_gumbel(0, t, H, N))
    return jres, tres


def test_per_frame_outputs_equal_jax(runs):
    jres, tres = runs
    assert len(tres.stats) == len(jres.stats) == 6
    for a, b in zip(tres.stats, jres.stats):
        assert {k: a[k] for k in KEYS} == {k: b[k] for k in KEYS}, a["frame"]
    np.testing.assert_array_equal(tres.frame_ok, jres.frame_ok)
    assert tres.frame_ok[1:].all()


def test_trajectory_matches_jax(seq, runs):
    jres, tres = runs
    np.testing.assert_allclose(tres.motions, jres.motions, atol=1e-4)
    ate_t = ate_rmse(tres.poses, seq.gt_poses)
    ate_j = ate_rmse(jres.poses, seq.gt_poses)
    assert abs(ate_t - ate_j) < 1e-3, (ate_t, ate_j)
    assert ate_t < 0.15


def test_cli_synth_on_cpu(capsys):
    cli.main(["synth", "--device", "cpu", "--metric", "l1", "--frames", "3"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["solved"] == 2 and out["device"] == "cpu"
    assert out["ate_rmse_m"] < 0.15


def _mini_kitti(root):
    """The mini-KITTI tree of the verify recipe: 6 PNG stereo pairs."""
    from PIL import Image

    seq = generate_sequence(num_frames=6, num_points=500, seed=7, width=416,
                            height=160)
    base = root / "sequences" / "77"
    (base / "image_0").mkdir(parents=True)
    (base / "image_1").mkdir(parents=True)
    (base / "calib.txt").write_text(
        "P0: " + " ".join(f"{v:.9e}" for v in seq.P1.reshape(-1)) + "\n"
        + "P1: " + " ".join(f"{v:.9e}" for v in seq.P2.reshape(-1)) + "\n")
    for i, (left, right) in enumerate(seq.frames):
        Image.fromarray(left.astype(np.uint8)).save(
            base / "image_0" / f"{i:06d}.png")
        Image.fromarray(right.astype(np.uint8)).save(
            base / "image_1" / f"{i:06d}.png")


def test_cli_kitti_on_cpu(tmp_path, capsys):
    _mini_kitti(tmp_path)
    cli.main(["kitti", "testsha", "77", "--kitti-home", str(tmp_path),
              "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["solved"] == 5 and out["frames"] == 6
    assert out["health"]["failed_frames"] == 0
    rows = np.loadtxt(out["poses"])
    assert rows.shape == (6, 12)
    np.testing.assert_allclose(rows[0], np.eye(4)[:3].reshape(-1))
    metrics = os.path.join(tmp_path, "results", "77", "testsha",
                           "metrics.jsonl")
    assert len(open(metrics).read().splitlines()) == 6


def test_cuda_device_without_a_card_raises(seq, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tstereo.run_stereo_sequence(seq.frames[:2], seq.P1, seq.P2,
                                    device="cuda")


@pytest.mark.parametrize("kwargs", [
    dict(cfg=from_jax_config(PipelineConfig().with_metric("l2q8"))),
    dict(cfg=from_jax_config(dataclasses.replace(
        PipelineConfig(), stereo_match=dataclasses.replace(
            PipelineConfig().stereo_match, banded=True)))),
    dict(cfg=from_jax_config(PipelineConfig().with_metric("l2q8")),
         chunk=2),
])
def test_options_not_ported_raise(seq, kwargs):
    """No matcher variant is left unported: 'l2q8', the banded matcher
    and 'l2q8' in chunks, which used to raise NotImplementedError, now
    run and solve every frame after the first (their parity with JAX is
    tests/test_torch_matcher_variants.py's)."""
    res = tstereo.run_stereo_sequence(seq.frames[:3], seq.P1, seq.P2,
                                      device="cpu", **kwargs)
    assert len(res.stats) == 3 and res.frame_ok[1:].all()


@pytest.mark.parametrize("argv", [["--metric", "l2q8"]])
def test_cli_flags_not_ported_raise(argv, capsys):
    """No CLI flag is left unported: --metric l2q8, which used to raise
    NotImplementedError, now runs."""
    cli.main(["synth", "--frames", "2", "--device", "cpu", *argv])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["solved"] == 1
