"""libviso_torch's numpy modules (synthetic sequences, KITTI I/O,
trajectory metrics) against their libviso_tpu originals: equal results."""

import dataclasses

import numpy as np
import pytest

from libviso_tpu import synthetic as jsyn
from libviso_tpu.io import kitti as jkitti
from libviso_tpu.utils import metrics as jmetrics
from libviso_torch import synthetic as tsyn
from libviso_torch.io import kitti as tkitti
from libviso_torch.utils import metrics as tmetrics


@pytest.mark.parametrize("kwargs", [
    dict(num_frames=4, num_points=300, seed=3, width=416, height=160),
    dict(num_frames=3, num_points=200, seed=5, width=320, height=120,
         imaging=dict(noise_sigma=3.0, num_occluders=2, quantize=True)),
])
def test_generate_sequence_equals_jax(kwargs):
    imaging = kwargs.pop("imaging", None)
    a = tsyn.generate_sequence(
        **kwargs, imaging=tsyn.Imaging(**imaging) if imaging else None)
    b = jsyn.generate_sequence(
        **kwargs, imaging=jsyn.Imaging(**imaging) if imaging else None)
    for (la, ra), (lb, rb) in zip(a.frames, b.frames):
        np.testing.assert_array_equal(la, lb)
        np.testing.assert_array_equal(ra, rb)
    np.testing.assert_allclose(a.gt_poses, b.gt_poses, atol=1e-6)
    np.testing.assert_allclose(a.gt_motions, b.gt_motions, atol=1e-6)
    np.testing.assert_array_equal(a.P1, b.P1)
    np.testing.assert_array_equal(a.P2, b.P2)


def test_kitti_projections_and_imaging_fields():
    for x, y in zip(tsyn.kitti_projections(), jsyn.kitti_projections()):
        np.testing.assert_array_equal(x, y)
    assert dataclasses.asdict(tsyn.Imaging()) == \
        dataclasses.asdict(jsyn.Imaging())


@pytest.fixture(scope="module")
def trajectories():
    seq = jsyn.generate_sequence(num_frames=30, num_points=50, seed=1,
                                 width=64, height=48)
    rng = np.random.default_rng(4)
    est = seq.gt_poses.astype(np.float64).copy()
    est[:, :3, 3] += np.cumsum(rng.normal(scale=0.02, size=(30, 3)), 0)
    return est, seq.gt_poses.astype(np.float64)


@pytest.mark.parametrize("align", ["none", "se3", "sim3"])
def test_ate_equals_jax(trajectories, align):
    est, gt = trajectories
    assert tmetrics.ate_rmse(est, gt, align=align) == pytest.approx(
        jmetrics.ate_rmse(est, gt, align=align), rel=1e-12)


def test_rpe_devkit_and_health_equal_jax(trajectories):
    est, gt = trajectories
    for x, y in zip(tmetrics.rpe_errors(est, gt, delta=2),
                    jmetrics.rpe_errors(est, gt, delta=2)):
        np.testing.assert_allclose(x, y, rtol=1e-12)
    assert tmetrics.kitti_trajectory_errors(est, gt, lengths=(5, 10)) == \
        jmetrics.kitti_trajectory_errors(est, gt, lengths=(5, 10))
    stats = [{"frame": t, "ok": t % 7 != 3, "num_inliers": 50 + t,
              "num_circle": 60, "sharpness": 0.1 * t,
              "motion_jump": 0.05 * (t % 9)} for t in range(30)]
    ok = np.array([s["ok"] for s in stats])
    assert tmetrics.health_summary(stats, ok) == \
        jmetrics.health_summary(stats, ok)


def test_kitti_files_round_trip(tmp_path, trajectories):
    est, _ = trajectories
    P1, P2 = tsyn.kitti_projections()
    calib = tmp_path / "calib.txt"
    calib.write_text("P0: " + " ".join(map(str, P1.reshape(-1))) + "\n"
                     + "P1: " + " ".join(map(str, P2.reshape(-1))) + "\n")
    for x, y in zip(tkitti.load_calib(str(calib)),
                    jkitti.load_calib(str(calib))):
        np.testing.assert_array_equal(x, y)
    path = tmp_path / "data" / "00.txt"
    tkitti.save_poses_kitti(str(path), est)
    np.testing.assert_array_equal(tkitti.load_poses_kitti(str(path)),
                                  jkitti.load_poses_kitti(str(path)))
    np.testing.assert_allclose(tkitti.load_poses_kitti(str(path)), est,
                               atol=1e-5)
    with tmetrics.MetricsLogger(str(tmp_path / "m.jsonl")) as ml:
        ml.log({"frame": 0})
    assert (tmp_path / "m.jsonl").read_text() == '{"frame": 0}\n'


def test_stereo_image_stream_equals_jax(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(2)
    for view in ("l", "r"):
        for i in range(3):
            Image.fromarray(rng.integers(0, 256, (20, 30), np.uint8)).save(
                tmp_path / f"{view}{i:02d}.png")
    masks = (str(tmp_path / "l%02d.png"), str(tmp_path / "r%02d.png"))
    for kw, n in ((dict(), 3), (dict(begin=1, end=1), 1),
                  (dict(prefetch=0), 3)):
        got = list(tkitti.StereoImageStream(*masks, **kw))
        want = list(jkitti.StereoImageStream(*masks, **kw))
        assert len(got) == len(want) == n
        for (a, b), (c, d) in zip(got, want):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)
