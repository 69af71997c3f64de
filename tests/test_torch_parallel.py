"""The sharded odometry of libviso_torch (``parallel/mesh.py``,
``parallel/odometry.py``) against libviso_tpu's.

The port's meshes repeat the CPU device; JAX runs on the 8 virtual CPU
devices of tests/conftest.py.  The chunking arithmetic equals JAX's
exactly.  ``run_sharded_odometry`` on JAX's chunk draws has JAX's ok flags
exactly and poses within 1e-4 (the motion tolerance of
tests/test_torch_batched.py: float32 normal equations summed in another
order); the single-process multi-process driver equals the single
controller's bit for bit.
"""

import numpy as np
import pytest
import torch

from libviso_tpu.config import DetectorConfig, PipelineConfig, RansacConfig
from libviso_tpu.parallel import chunk_frames_with_halo as jax_chunk
from libviso_tpu.parallel import host_chunk_assignment as jax_assign
from libviso_tpu.parallel import make_mesh as jax_make_mesh
from libviso_tpu.parallel import run_sharded_odometry as jax_sharded
from libviso_tpu.parallel import stitch_chunk_motions as jax_stitch
from libviso_tpu.synthetic import generate_sequence
from libviso_torch.config import from_jax_config
from libviso_torch.parallel import (
    chunk_frames_with_halo,
    host_chunk_assignment,
    make_mesh,
    make_pipe_mesh,
    run_sharded_odometry,
    run_sharded_odometry_multihost,
    stitch_chunk_motions,
)
from libviso_torch.parallel.mesh import Mesh
from tests.torch_parity import jax_chunk_gumbel, to_np

JAX_CFG = PipelineConfig(
    detector=DetectorConfig(max_features=240, nbinx=8, nbiny=3,
                            num_slots=256),
    ransac=RansacConfig(num_hypotheses=32, gn_iters=50))
CFG = from_jax_config(JAX_CFG)


def test_mesh_construction():
    mesh = make_mesh(n_data=4, n_model=2, devices=["cpu"] * 8)
    assert mesh.shape == {"data": 4, "model": 2}
    assert mesh.axis_devices("model") == [torch.device("cpu")] * 2
    assert len(mesh.axis_devices("data")) == 4
    assert make_pipe_mesh(["cpu", "cpu"]).shape == {"pipe": 2}
    with pytest.raises(ValueError):
        make_mesh(n_data=4, n_model=2, devices=["cpu"] * 7)
    with pytest.raises(ValueError):
        Mesh(np.empty((2, 2), object), ("data",))


def test_default_devices_need_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(n_data=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_pipe_mesh()


@pytest.mark.parametrize("T,n_chunks", [(10, 4), (9, 4), (6, 4), (21, 4),
                                        (5, 2)])
def test_chunk_frames_with_halo_equals_jax(T, n_chunks):
    left = np.arange(T * 4 * 6, dtype=np.float32).reshape(T, 4, 6)
    right = left + 1
    got = chunk_frames_with_halo(left, right, n_chunks)
    want = jax_chunk(left, right, n_chunks)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    l, _, nv = got
    per = l.shape[1] - 1
    np.testing.assert_array_equal(l[1, 0], left[min(per, T - 1)])
    assert nv.sum() == T - 1


@pytest.mark.parametrize("n_valid", [[3, 3, 2], [3, 3, 3], [3, 1, 0]])
def test_stitch_equals_jax(rng, n_valid):
    B, L = 3, 4
    trs = (rng.standard_normal((B, L, 6)) * 0.05).astype(np.float32)
    oks = rng.random((B, L)) > 0.2
    poses, keep = stitch_chunk_motions(torch.from_numpy(trs),
                                       torch.from_numpy(oks),
                                       torch.tensor(n_valid))
    jposes, jkeep = jax_stitch(trs, oks, np.asarray(n_valid))
    np.testing.assert_array_equal(to_np(keep), np.asarray(jkeep))
    assert int(keep.sum()) == 1 + sum(n_valid)
    # JAX chains with an associative scan, the port in sequence
    np.testing.assert_allclose(to_np(poses), np.asarray(jposes), atol=1e-5)


def test_stitch_identity_motions():
    poses, keep = stitch_chunk_motions(torch.zeros(3, 4, 6),
                                       torch.ones(3, 4, dtype=torch.bool),
                                       torch.tensor([3, 3, 2]))
    assert int(keep.sum()) == 1 + 8
    np.testing.assert_allclose(to_np(poses[keep]),
                               np.eye(4)[None].repeat(9, 0), atol=1e-6)


@pytest.mark.parametrize("total,chunks,procs", [
    (9, 4, 2), (17, 8, 4), (6, 4, 4), (12, 2, 1)])
def test_host_chunk_assignment_equals_jax(total, chunks, procs):
    owned = []
    for p in range(procs):
        got = host_chunk_assignment(total, chunks, p, procs)
        want = jax_assign(total, chunks, p, procs)
        assert got.keys() == want.keys()
        for key in got:
            np.testing.assert_array_equal(got[key], want[key])
        for s, nv in zip(got["chunk_starts"], got["n_valid"]):
            owned.extend(range(s + 1, s + 1 + nv))
    assert sorted(owned) == list(range(1, total))


def test_host_chunk_assignment_validates_divisibility():
    with pytest.raises(ValueError, match="divisible"):
        host_chunk_assignment(10, 4, 0, 3)


@pytest.fixture(scope="module")
def seq():
    return generate_sequence(num_frames=9, num_points=420, seed=3,
                             width=416, height=160)


def test_sharded_odometry_equals_jax(seq):
    left = np.stack([f[0] for f in seq.frames])
    right = np.stack([f[1] for f in seq.frames])
    jposes, jkeep = jax_sharded(jax_make_mesh(n_data=4, n_model=1), seq.P1,
                                seq.P2, left, right, JAX_CFG, seed=0)
    H, N = CFG.ransac.num_hypotheses, CFG.detector.num_slots
    mesh = make_mesh(n_data=4, devices=["cpu"] * 4)
    poses, keep = run_sharded_odometry(
        mesh, seq.P1, seq.P2, left, right, CFG,
        draws=lambda c, n: jax_chunk_gumbel(0, 4, c, n, H, N))
    np.testing.assert_array_equal(keep, np.asarray(jkeep))
    assert poses.shape == (9, 4, 4)
    np.testing.assert_allclose(poses, np.asarray(jposes), atol=1e-4)
    # every frame moved: the trajectory is not the identity chain
    assert np.linalg.norm(poses[-1][:3, 3]) > 0.1

    # one process of the multi-process driver: the same result bit for bit
    plan = host_chunk_assignment(len(left), 4, 0, 1)
    span = slice(plan["frame_start"], plan["frame_stop"])
    got, got_keep = run_sharded_odometry_multihost(
        mesh, seq.P1, seq.P2, left[span], right[span], len(left), CFG,
        draws=lambda c, n: jax_chunk_gumbel(0, 4, c, n, H, N))
    np.testing.assert_array_equal(got_keep, keep)
    np.testing.assert_array_equal(got, poses)


def test_multihost_rejects_wrong_span(seq):
    left = np.stack([f[0] for f in seq.frames])
    mesh = make_mesh(n_data=4, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="must pass frames"):
        run_sharded_odometry_multihost(mesh, seq.P1, seq.P2, left[:2],
                                       left[:2], total_frames=len(left),
                                       cfg=CFG)
