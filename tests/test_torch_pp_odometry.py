"""The staged pipeline of libviso_torch (``parallel/pp_odometry.py``)
against the port's serial run and libviso_tpu's ``run_pipelined_odometry``.

Both drivers compute the serial step's ops on the same inputs, so they
equal ``run_stereo_sequence`` bit for bit (motions, ok flags, poses).
Against JAX, on JAX's per-frame draws: ok flags exact, motions within
1e-4 (tests/test_torch_pipeline.py's tolerance).
"""

import numpy as np
import pytest

from libviso_tpu.config import DetectorConfig, PipelineConfig, RansacConfig
from libviso_tpu.parallel import make_pipe_mesh as jax_pipe_mesh
from libviso_tpu.parallel import run_pipelined_odometry as jax_pipelined
from libviso_tpu.synthetic import generate_sequence
from libviso_torch.config import Calib, from_jax_config
from libviso_torch.parallel import (
    build_pipelined_program,
    make_mesh,
    make_pipe_mesh,
    run_pipelined_odometry,
)
from libviso_torch.parallel.mesh import Mesh
from libviso_torch.parallel.pp_odometry import StreamPipeline
from libviso_torch.pipeline.stereo import run_stereo_sequence
from tests.torch_parity import jax_frame_gumbel

JAX_CFG = PipelineConfig(
    detector=DetectorConfig(max_features=240, nbinx=8, nbiny=3,
                            num_slots=256),
    ransac=RansacConfig(num_hypotheses=32, gn_iters=50))
CFG = from_jax_config(JAX_CFG)
H, N = CFG.ransac.num_hypotheses, CFG.detector.num_slots


def draws(t):
    return jax_frame_gumbel(0, t, H, N)


@pytest.fixture(scope="module")
def seq():
    return generate_sequence(num_frames=6, num_points=420, seed=3,
                             width=416, height=160)


@pytest.fixture(scope="module")
def serial(seq):
    return run_stereo_sequence(seq.frames, seq.P1, seq.P2, CFG,
                               device="cpu", draws=draws)


def test_pipelined_equals_serial_and_jax(seq, serial):
    left = np.stack([f[0] for f in seq.frames]).astype(np.float32)
    right = np.stack([f[1] for f in seq.frames]).astype(np.float32)
    poses, motions, ok = run_pipelined_odometry(
        make_pipe_mesh(["cpu", "cpu"]), seq.P1, seq.P2, left, right, CFG,
        draws=draws)
    np.testing.assert_array_equal(ok, serial.frame_ok)
    np.testing.assert_array_equal(motions, serial.motions)
    np.testing.assert_array_equal(poses, serial.poses)
    assert ok[1:].all()

    jposes, jmotions, jok = jax_pipelined(jax_pipe_mesh(), seq.P1, seq.P2,
                                          left, right, cfg=JAX_CFG, seed=0)
    np.testing.assert_array_equal(ok, jok)
    np.testing.assert_allclose(motions[1:], jmotions[1:], atol=1e-4)


def test_stream_pipeline_equals_serial(seq, serial):
    sp = StreamPipeline(seq.P1, seq.P2, CFG, devices=["cpu", "cpu"],
                        draws=draws)
    outs = [sp.push(im1, im2) for im1, im2 in seq.frames]
    assert outs[0] is None
    outs = outs[1:] + [sp.flush()]
    assert sp.flush() is None
    motions = np.stack([o.tr.numpy() for o in outs])
    ok = np.array([bool(o.ok) for o in outs])
    ok[0] = False
    np.testing.assert_array_equal(ok, serial.frame_ok)
    np.testing.assert_array_equal(motions, serial.motions)


def test_default_draws_equal_serial_default(seq):
    """Without the seam both take frame_generator(seed, t), as the serial
    run does."""
    frames = seq.frames[:3]
    ref = run_stereo_sequence(frames, seq.P1, seq.P2, CFG, seed=5,
                              device="cpu")
    _, motions, ok = run_pipelined_odometry(
        make_pipe_mesh(["cpu", "cpu"]), seq.P1, seq.P2,
        [f[0] for f in frames], [f[1] for f in frames], CFG, seed=5)
    np.testing.assert_array_equal(motions, ref.motions)
    np.testing.assert_array_equal(ok, ref.frame_ok)


def test_pipe_mesh_needs_two_devices():
    with pytest.raises(ValueError):
        make_pipe_mesh(devices=["cpu"])
    with pytest.raises(ValueError):
        StreamPipeline(np.eye(3, 4), np.eye(3, 4), CFG, devices=["cpu"])


def test_pipelined_rejects_wrong_axis_size():
    calib = Calib(f=700.0, cu=200.0, cv=80.0, base=0.5)
    mesh = Mesh(np.asarray(["cpu"] * 4, dtype=object), ("pipe",))
    with pytest.raises(ValueError, match="pipe axis"):
        build_pipelined_program(calib, np.eye(3), CFG, mesh)
    with pytest.raises(ValueError, match="pipe axis"):
        build_pipelined_program(calib, np.eye(3), CFG,
                                make_mesh(2, devices=["cpu"] * 2))


@pytest.mark.parametrize("driver", ["program", "stream"])
def test_keep_features_on_failure_rejected(driver):
    import dataclasses

    cfg = dataclasses.replace(CFG, keep_features_on_failure=True)
    calib = Calib(f=700.0, cu=200.0, cv=80.0, base=0.5)
    with pytest.raises(ValueError, match="keep_features_on_failure"):
        if driver == "program":
            build_pipelined_program(calib, np.eye(3), cfg,
                                    make_pipe_mesh(["cpu", "cpu"]))
        else:
            P = np.hstack([np.eye(3), np.zeros((3, 1))])
            StreamPipeline(P, P, cfg, devices=["cpu", "cpu"])
