"""Multi-process launch and per-process placement of libviso_torch
(``parallel/distributed.py``), the cases of tests/test_distributed.py, and
one real two-process gloo run of ``run_sharded_odometry_multihost``.

The two processes rendezvous through ``initialize_from_env`` (the VISO_*
variables, a free localhost port), each runs its chunk of a 5-frame
416x160 sequence (two chunks of 3 frames) on the CPU, and they exchange
the chunks' motions with ``all_gather``.  Both must return the
single-process ``run_sharded_odometry`` poses bit for bit: every process
stitches the same gathered values with the same ops.
"""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from libviso_tpu.parallel.distributed import (
    host_frame_range as jax_host_frame_range,
)
from libviso_torch.config import DetectorConfig, PipelineConfig, RansacConfig
from libviso_torch.parallel import make_mesh, run_sharded_odometry
from libviso_torch.parallel.distributed import (
    describe,
    global_frame_array,
    host_frame_range,
    initialize_from_env,
)
from libviso_torch.synthetic import generate_sequence

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_initialize_noop_single_process(monkeypatch):
    monkeypatch.delenv("VISO_NUM_PROCESSES", raising=False)
    assert initialize_from_env() is False
    monkeypatch.setenv("VISO_NUM_PROCESSES", "1")
    assert initialize_from_env() is False


def test_initialize_needs_coordinator(monkeypatch):
    monkeypatch.setenv("VISO_NUM_PROCESSES", "2")
    monkeypatch.delenv("VISO_COORDINATOR", raising=False)
    with pytest.raises(ValueError, match="VISO_COORDINATOR"):
        initialize_from_env()


@pytest.mark.parametrize("num_frames,num_hosts", [
    (11, 2), (12, 3), (100, 7), (5, 4), (2, 1)])
def test_host_ranges_cover_all_motions(num_frames, num_hosts):
    owned = []
    for h in range(num_hosts):
        start, stop = host_frame_range(num_frames, num_hosts, h, halo=1)
        assert (start, stop) == jax_host_frame_range(num_frames, num_hosts,
                                                     h, halo=1)
        assert 0 <= start < stop <= num_frames
        owned.extend(range(start + 1, stop))
    assert sorted(owned) == list(range(1, num_frames))


def test_host_range_halo_zero():
    s0, e0 = host_frame_range(10, 3, 0, halo=0)
    s1, e1 = host_frame_range(10, 3, 1, halo=0)
    assert s1 == e0
    s1h, _ = host_frame_range(10, 3, 1, halo=1)
    assert s1h == s1 - 1


def test_host_range_validates():
    with pytest.raises(ValueError):
        host_frame_range(10, 2, 5)


def test_balanced_within_one():
    sizes = [e - s for s, e in (host_frame_range(103, 5, h, halo=0)
                                for h in range(5))]
    assert max(sizes) - min(sizes) <= 1


def test_global_frame_array_single_process(rng):
    mesh = make_mesh(n_data=8, devices=["cpu"] * 8)
    frames = rng.standard_normal((8, 4, 6)).astype(np.float32)
    shard = global_frame_array(mesh, frames)
    assert shard.global_shape == (8, 4, 6) and shard.offset == 0
    np.testing.assert_array_equal(shard.frames.numpy(), frames)


def test_describe_keys():
    d = describe()
    assert d["process_count"] == 1 and d["process_index"] == 0
    assert d["local_devices"] >= 1
    assert d["global_devices"] == d["local_devices"]
    assert d["device_kind"]


_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    from libviso_torch.config import (
        DetectorConfig, PipelineConfig, RansacConfig)
    from libviso_torch.parallel import (
        host_chunk_assignment, make_mesh, run_sharded_odometry_multihost)
    from libviso_torch.parallel.distributed import (
        describe, initialize_from_env, process_index)
    from libviso_torch.synthetic import generate_sequence

    torch.set_num_threads(1)
    assert initialize_from_env(), "multi-process init expected"
    info = describe()
    assert info["process_count"] == 2, info
    seq = generate_sequence(num_frames=5, num_points=420, seed=3,
                            width=416, height=160)
    CFG = PipelineConfig(
        detector=DetectorConfig(max_features=240, nbinx=8, nbiny=3,
                                num_slots=256),
        ransac=RansacConfig(num_hypotheses=32, gn_iters=50))
    plan = host_chunk_assignment(5, 2, process_index(), 2)
    span = slice(plan["frame_start"], plan["frame_stop"])
    left = np.stack([f[0] for f in seq.frames])[span]
    right = np.stack([f[1] for f in seq.frames])[span]
    poses, keep = run_sharded_odometry_multihost(
        make_mesh(n_data=2, devices=["cpu"] * 2), seq.P1, seq.P2, left,
        right, total_frames=5, cfg=CFG, seed=0)
    np.save(sys.argv[1], poses)
""")


# the worker's configuration
CFG = PipelineConfig(
    detector=DetectorConfig(max_features=240, nbinx=8, nbiny=3,
                            num_slots=256),
    ransac=RansacConfig(num_hypotheses=32, gn_iters=50))


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_sharded_odometry(tmp_path):
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ, VISO_COORDINATOR=f"localhost:{port}",
                   VISO_NUM_PROCESSES="2", VISO_PROCESS_ID=str(pid),
                   JAX_PLATFORMS="cpu",
                   PYTHONPATH=ROOT + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(tmp_path / f"p{pid}.npy")],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    try:
        logs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]

    seq = generate_sequence(num_frames=5, num_points=420, seed=3,
                            width=416, height=160)
    ref, keep = run_sharded_odometry(
        make_mesh(n_data=2, devices=["cpu"] * 2), seq.P1, seq.P2,
        np.stack([f[0] for f in seq.frames]),
        np.stack([f[1] for f in seq.frames]), CFG, seed=0)
    assert keep.all() and ref.shape == (5, 4, 4)
    for pid in range(2):
        np.testing.assert_array_equal(np.load(tmp_path / f"p{pid}.npy"), ref)
