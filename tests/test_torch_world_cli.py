"""World frames and the CLI flags of the port, on the CPU.

The world renderer is host-side numpy copied into the port: for the same
seed its frames, poses and projections equal the JAX package's arrays
exactly.  Each CLI flag is driven once on ``--device cpu`` on small inputs
(the synth subcommand's sprite frames are fixed at KITTI size, so the flag
tests run 2 frames).
"""

import json

import numpy as np
import pytest

from libviso_tpu import synthetic_world as jworld
from libviso_torch import cli
from libviso_torch import synthetic_world as tworld
from libviso_torch.io.kitti import StereoImageStream, save_poses_kitti
from tests.test_torch_pipeline import _mini_kitti


def _assert_sequences_equal(a, b):
    assert len(a.frames) == len(b.frames)
    for (l1, r1), (l2, r2) in zip(a.frames, b.frames):
        assert l1.dtype == l2.dtype
        np.testing.assert_array_equal(l1, l2)
        np.testing.assert_array_equal(r1, r2)
    np.testing.assert_array_equal(a.gt_poses, b.gt_poses)
    np.testing.assert_array_equal(a.P1, b.P1)
    np.testing.assert_array_equal(a.P2, b.P2)


@pytest.mark.parametrize("seed", [0, 7])
def test_world_sequence_equals_jax_package(seed):
    kw = dict(num_frames=3, seed=seed, width=208, height=96)
    _assert_sequences_equal(tworld.generate_world_sequence(**kw),
                            jworld.generate_world_sequence(**kw))


def test_plaza_sequence_equals_jax_package():
    kw = dict(num_frames=4, seed=2, width=160, height=80)
    _assert_sequences_equal(tworld.generate_plaza_sequence(**kw),
                            jworld.generate_plaza_sequence(**kw))


def test_world_textures_equal_jax_package():
    for name in ("make_brick_texture", "make_foliage_texture",
                 "make_glass_texture"):
        a = getattr(tworld, name)(np.random.default_rng(3), 48, 64)
        b = getattr(jworld, name)(np.random.default_rng(3), 48, 64)
        np.testing.assert_array_equal(a, b)


def _synth(capsys, *argv):
    cli.main(["synth", "--device", "cpu", "--metric", "l1", *argv])
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("argv", [
    ["--subpixel"], ["--pyramid", "2"], ["--sharpen", "2.0"],
    ["--sharpen", "2.0", "--sharpen-amount", "2.0"], ["--sharpen-auto"],
    ["--nms", "2"], ["--keep-on-failure"], ["--chunk", "2"],
], ids=lambda a: "".join(a))
def test_cli_synth_flags_on_cpu(capsys, argv):
    out = _synth(capsys, "--frames", "2", *argv)
    assert out["frames"] == 2 and out["solved"] == 1
    assert out["ate_rmse_m"] < 0.15
    assert set(out) == {"frames", "device", "solved", "ate_rmse_m",
                        "rpe_trans_mean_m", "rpe_rot_mean_rad", "fps"}


def test_cli_synth_world_on_cpu(capsys):
    out = _synth(capsys, "--world", "--frames", "3", "--chunk", "2",
                 "--backend", "sweep")
    assert out["frames"] == 3 and out["solved"] == 2
    assert out["ate_rmse_m"] < 0.15


def test_cli_flags_reach_the_config():
    import argparse

    args = argparse.Namespace(
        metric="l1", hyp="gn", subpixel=True, pyramid=3, sharpen=None,
        sharpen_amount=2.5, sharpen_auto=True, nms=2, keep_on_failure=True)
    cfg = cli._config(args)
    det = cfg.detector
    assert (det.subpixel, det.pyramid_levels, det.sharpen_sigma,
            det.sharpen_amount, det.sharpen_auto, det.nms_radius) == \
        (True, 3, 3.0, 2.5, True, 2)
    assert cfg.keep_features_on_failure
    assert cfg.ransac.hypothesis_method == "gn"
    assert cfg.stereo_match.metric == cfg.temporal_match.metric == "l1"


@pytest.fixture(scope="module")
def kitti_home(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti")
    _mini_kitti(root)
    return root


def _kitti(capsys, home, sha, *argv):
    cli.main(["kitti", sha, "77", "--kitti-home", str(home), "--device",
              "cpu", *argv])
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_kitti_checkpoint_every_resumes(kitti_home, capsys):
    whole = _kitti(capsys, kitti_home, "whole", "--chunk", "2")
    first = _kitti(capsys, kitti_home, "ck", "--checkpoint-every", "2",
                   "--chunk", "2")
    ckdir = kitti_home / "results" / "77" / "ck" / "checkpoints"
    assert sorted(p.name for p in ckdir.iterdir()) == [
        "ckpt_00000004.npz", "ckpt_00000006.npz"]
    (ckdir / "ckpt_00000006.npz").unlink()     # as if cut after frame 3
    resumed = _kitti(capsys, kitti_home, "ck", "--checkpoint-every", "2",
                     "--chunk", "2")
    assert first["solved"] == resumed["solved"] == whole["solved"] == 5
    np.testing.assert_array_equal(np.loadtxt(resumed["poses"]),
                                  np.loadtxt(whole["poses"]))
    assert resumed["health"] == whole["health"]
    with pytest.raises(ValueError, match="fingerprint"):
        _kitti(capsys, kitti_home, "ck", "--checkpoint-every", "2", "0", "4")


def test_cli_kitti_save_debug_and_health_flags(kitti_home, capsys):
    out = _kitti(capsys, kitti_home, "dbg", "0", "2", "--save-debug",
                 "--support-ratio-alarm", "0.99", "--motion-jump-alarm",
                 "0.0")
    names = sorted(p.name for p in
                   (kitti_home / "results" / "77" / "dbg" / "dbg").iterdir())
    assert names == sorted(
        [f"{k}_{t:03d}.jpg" for t in range(3)
         for k in ("corners1", "corners2", "blend12")]
        + [f"{k}_{t:03d}.jpg" for t in (1, 2)
           for k in ("circ_match", "reproj1")])
    assert out["frames"] == 3
    assert out["health"]["alarms"] == ["support_ratio", "motion_jump"]


def test_stream_skipped_starts_later_without_decoding(kitti_home):
    base = kitti_home / "sequences" / "77"
    stream = StereoImageStream(str(base / "image_0" / "%06d.png"),
                               str(base / "image_1" / "%06d.png"), end=4)
    later = stream.skipped(3)
    assert (later.begin, later.end, stream.begin) == (3, 4, 0)
    frames, tail = list(stream), list(later)
    assert len(frames) == 5 and len(tail) == 2
    np.testing.assert_array_equal(tail[0][0], frames[3][0])


def test_cli_eval(tmp_path, capsys):
    gt = np.tile(np.eye(4), (12, 1, 1))
    gt[:, 2, 3] = np.arange(12) * 0.8
    est = gt.copy()
    est[:, 0, 3] += np.linspace(0, 0.1, 12)
    save_poses_kitti(str(tmp_path / "gt.txt"), gt)
    save_poses_kitti(str(tmp_path / "est.txt"), est)
    plot = tmp_path / "traj.png"
    cli.main(["eval", str(tmp_path / "est.txt"), str(tmp_path / "gt.txt"),
              "--align", "se3", "--plot", str(plot)])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["frames"] == 12 and out["align"] == "se3"
    assert 0 < out["ate_rmse_m"] < out["ate_rmse_raw_m"] < 0.1
    assert out["t_err_pct"] is None and out["num_segments"] == 0
    assert plot.exists() and out["plot"] == str(plot)
    with pytest.raises(SystemExit):
        save_poses_kitti(str(tmp_path / "one.txt"), gt[:1])
        cli.main(["eval", str(tmp_path / "one.txt"),
                  str(tmp_path / "gt.txt")])


def test_cli_kitti_runs_each_of_several_sequences(kitti_home, capsys):
    """`kitti SHA 77,78` runs each sequence in turn, as the JAX CLI does:
    one JSON line and one pose file per sequence."""
    from PIL import Image

    from libviso_torch.synthetic import generate_sequence

    seq = generate_sequence(num_frames=4, num_points=500, seed=8, width=416,
                            height=160)
    base = kitti_home / "sequences" / "78"
    for cam, P in (("image_0", seq.P1), ("image_1", seq.P2)):
        (base / cam).mkdir(parents=True)
    (base / "calib.txt").write_text(
        "".join(f"{row}: " + " ".join(f"{v:.9e}" for v in P.reshape(-1))
                + "\n" for row, P in (("P0", seq.P1), ("P1", seq.P2))))
    for i, pair in enumerate(seq.frames):
        for cam, im in zip(("image_0", "image_1"), pair):
            Image.fromarray(im.astype(np.uint8)).save(
                base / cam / f"{i:06d}.png")
    cli.main(["kitti", "multi", "77,78", "0", "3", "--kitti-home",
              str(kitti_home), "--device", "cpu"])
    lines = [json.loads(x) for x in
             capsys.readouterr().out.strip().splitlines()]
    assert [x["sequence"] for x in lines] == ["77", "78"]
    for x in lines:
        assert x["frames"] == 4 and x["solved"] == 3
        assert np.loadtxt(x["poses"]).shape == (4, 12)
        assert x["poses"].endswith(f"/{x['sequence']}/multi/data/"
                                   f"{x['sequence']}.txt")
