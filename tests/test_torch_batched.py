"""The frame-batched window of libviso_torch (``pipeline/batched.py``)
against libviso_tpu's, and against the port's own streaming run.

With the same RANSAC draws the discrete outputs are equal (ok flags,
circle, inlier and stereo-match counts, every TrackData index and mask);
motions agree with JAX within 1e-4 (float32 normal equations summed in
different orders) and with the streaming run within 5e-6 (the batched
solve's contract).  TrackData's indices, masks, coordinates and
descriptors are exact (integer-valued Sobel patches, integer pixel
positions).  Two float fields are not: the triangulated Z = f b / d, which
PyTorch evaluates as reciprocal times constant, one rounding more than
JAX's division, and the Harris response, whose multiply-adds XLA's
compiled CPU code may contract.  Both are held to 1e-6 relative (a few
float32 ulps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libviso_tpu.config import Calib as JCalib
from libviso_tpu.config import DetectorConfig as JDetectorConfig
from libviso_tpu.config import PipelineConfig as JPipelineConfig
from libviso_tpu.config import RansacConfig as JRansacConfig
from libviso_tpu.geometry.mvg import F_from_P_host as jax_F
from libviso_tpu.pipeline.batched import build_batched_odometry as jax_build
from libviso_torch.config import Calib, from_jax_config
from libviso_torch.geometry.mvg import F_from_P_host
from libviso_torch.pipeline import batched as tbatched
from libviso_torch.pipeline.stereo import run_stereo_sequence
from libviso_torch.synthetic import generate_sequence
from tests.torch_parity import to_np, to_torch

JAX_CFG = JPipelineConfig(
    detector=JDetectorConfig(max_features=120, nbinx=6, nbiny=2,
                             num_slots=128),
    ransac=JRansacConfig(num_hypotheses=16, gn_iters=10)).with_metric("l1")
CFG = from_jax_config(JAX_CFG)
H, N = CFG.ransac.num_hypotheses, CFG.detector.num_slots
T = 5


@pytest.fixture(scope="module")
def window():
    seq = generate_sequence(num_frames=T, num_points=300, width=160,
                            height=96, f=120.0, seed=3)
    ims1 = np.stack([f[0] for f in seq.frames]).astype(np.uint8)
    ims2 = np.stack([f[1] for f in seq.frames]).astype(np.uint8)
    return seq, ims1, ims2


@pytest.fixture(scope="module")
def jax_run(window):
    """The JAX window and the draws it made: split(key, T-1), then each
    ransac_pose draws gumbel(key_t, (H, N))."""
    seq, ims1, ims2 = window
    key = jax.random.PRNGKey(5)
    fn = jax_build(JCalib.from_projections(seq.P1, seq.P2),
                   jax_F(seq.P1, seq.P2), JAX_CFG, with_tracks=True)
    out, tracks = jax.jit(fn)(jnp.asarray(ims1), jnp.asarray(ims2), key)
    draws = torch.stack([to_torch(jax.random.gumbel(k, (H, N), jnp.float32))
                         for k in jax.random.split(key, T - 1)])
    return out, tracks, draws


def _port_fn(seq, backend="dense", **kw):
    return tbatched.build_batched_odometry(
        Calib.from_projections(seq.P1, seq.P2),
        torch.as_tensor(F_from_P_host(seq.P1, seq.P2), dtype=torch.float32),
        CFG, backend=backend, **kw)


@pytest.mark.parametrize("backend", ["dense", "fused"])
def test_batched_window_equals_jax(window, jax_run, backend):
    seq, ims1, ims2 = window
    want, _, draws = jax_run
    got = _port_fn(seq, backend)(to_torch(ims1), to_torch(ims2), draws)
    for name in ("ok", "num_circle", "num_inliers", "num_lr"):
        np.testing.assert_array_equal(to_np(getattr(got, name)),
                                      np.asarray(getattr(want, name)), name)
    np.testing.assert_allclose(to_np(got.motions), np.asarray(want.motions),
                               atol=1e-4)
    assert got.motions.shape == (T, 6) and not got.motions[0].any()
    assert got.ok.tolist() == [False] + [True] * (T - 1)


def test_track_data_equals_jax(window, jax_run):
    seq, ims1, ims2 = window
    _, want, draws = jax_run
    _, got = _port_fn(seq, with_tracks=True)(to_torch(ims1), to_torch(ims2),
                                             draws)
    assert got._fields == want._fields
    for name in got._fields:
        if name in ("X", "kp1_response"):
            np.testing.assert_allclose(to_np(getattr(got, name)),
                                       np.asarray(getattr(want, name)),
                                       rtol=1e-6, atol=0, err_msg=name)
            continue
        np.testing.assert_array_equal(to_np(getattr(got, name)),
                                      np.asarray(getattr(want, name)), name)
    assert got.m11_idx.shape == (T - 1, N) and got.X.shape == (T, N, 3)


@pytest.mark.parametrize("backend", ["dense", "fused", "sweep"])
def test_batched_window_equals_streaming_run(window, jax_run, backend):
    """Frame t of the streaming run draws what transition t-1 of the
    window draws: frames 1..T-1 have the same discrete stats."""
    seq, ims1, ims2 = window
    draws = jax_run[2]
    got = _port_fn(seq, backend)(to_torch(ims1), to_torch(ims2), draws)
    stream = run_stereo_sequence(
        list(zip(ims1, ims2)), seq.P1, seq.P2, CFG, device="cpu", backend=backend,
        draws=lambda t: draws[max(t - 1, 0)])
    for t in range(1, T):
        s = stream.stats[t]
        assert (bool(got.ok[t]), int(got.num_circle[t]),
                int(got.num_inliers[t]), int(got.num_lr[t])) == \
            (s["ok"], s["num_circle"], s["num_inliers"], s["num_lr"]), t
    assert int(got.num_lr[0]) == stream.stats[0]["num_lr"]
    np.testing.assert_allclose(to_np(got.motions)[1:], stream.motions[1:],
                               rtol=0, atol=5e-6)


def test_batched_refuses_keep_features_on_failure(window):
    import dataclasses

    seq = window[0]
    with pytest.raises(ValueError, match="streaming-step feature"):
        tbatched.build_batched_odometry(
            Calib.from_projections(seq.P1, seq.P2), torch.eye(3),
            dataclasses.replace(CFG, keep_features_on_failure=True))
    with pytest.raises(ValueError, match="L1 only"):
        tbatched.build_batched_odometry(
            Calib.from_projections(seq.P1, seq.P2), torch.eye(3),
            CFG.with_metric("l2"), backend="sweep")
