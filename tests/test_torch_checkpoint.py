"""Chunked and checkpointed runs of libviso_torch.

Everything here is bitwise: a chunked run steps the same frames through the
same step with the same draws, and a resumed run restores the state's
tensors exactly and draws frame t from (seed, t) alone.  So motions, poses
and every stat (the float ones too) are compared with ``==``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from libviso_torch.config import (
    DetectorConfig,
    PipelineConfig,
    RansacConfig,
)
from libviso_torch.pipeline import multistream as tms
from libviso_torch.pipeline import stereo as tstereo
from libviso_torch.solvers.ransac import frame_generator, sample_gumbel
from libviso_torch.synthetic import generate_sequence
from libviso_torch.utils.checkpoint import (
    Checkpoint,
    CheckpointManager,
    config_fingerprint,
)

torch.set_num_threads(1)   # the suite runs in several processes at once

CFG = PipelineConfig(
    detector=DetectorConfig(max_features=120, nbinx=6, nbiny=2,
                            num_slots=128),
    ransac=RansacConfig(num_hypotheses=16, gn_iters=10)).with_metric("l1")
H, N = CFG.ransac.num_hypotheses, CFG.detector.num_slots


@pytest.fixture(scope="module")
def seq():
    return generate_sequence(num_frames=10, num_points=300, width=160,
                             height=96, f=120.0, seed=3)


@pytest.fixture(scope="module")
def seq_b():
    return generate_sequence(num_frames=7, num_points=260, width=160,
                             height=96, f=140.0, seed=11, speed=0.6)


@pytest.fixture(scope="module")
def whole(seq):
    return tstereo.run_stereo_sequence(seq.frames, seq.P1, seq.P2, CFG,
                                       seed=4, device="cpu")


def _assert_same(got, want):
    assert got.stats == want.stats
    np.testing.assert_array_equal(got.motions, want.motions)
    np.testing.assert_array_equal(got.frame_ok, want.frame_ok)
    np.testing.assert_array_equal(got.poses, want.poses)


@pytest.mark.parametrize("chunk", [1, 3, 4])
@pytest.mark.parametrize("backend", ["dense", "sweep"])
def test_chunked_run_equals_per_frame_run(seq, chunk, backend):
    """10 frames: chunk 3 leaves a tail of 1, chunk 4 a tail of 2."""
    want = tstereo.run_stereo_sequence(seq.frames, seq.P1, seq.P2, CFG,
                                       seed=4, device="cpu", backend=backend)
    seen = []
    got = tstereo.run_stereo_sequence(
        seq.frames, seq.P1, seq.P2, CFG, seed=4, device="cpu", chunk=chunk,
        backend=backend, on_frame=lambda t, out: seen.append(t))
    _assert_same(got, want)
    assert seen == list(range(10)) and got.processed == 10
    assert want.frame_ok[1:].all()


def test_frame_chunk_equals_separate_steps(seq):
    calib = tstereo.Calib.from_projections(seq.P1, seq.P2)
    F = torch.as_tensor(tstereo.F_from_P_host(seq.P1, seq.P2),
                        dtype=torch.float32)
    step = tstereo.build_frame_step(calib, F, CFG)
    cstep = tstereo.build_frame_chunk(calib, F, CFG, 3)
    lefts = torch.tensor(np.stack([f[0] for f in seq.frames[:3]]))
    rights = torch.tensor(np.stack([f[1] for f in seq.frames[:3]]))
    g = torch.stack([sample_gumbel((H, N), frame_generator(0, t))
                     for t in range(3)])
    state, outs = cstep(tstereo.empty_state(CFG), lefts, rights, g)
    st = tstereo.empty_state(CFG)
    for t in range(3):
        st, out = step(st, lefts[t], rights[t], g[t])
        assert all(torch.equal(a[t], b) for a, b in zip(outs, out))
    assert all(torch.equal(a, b) for a, b in zip(
        tstereo.state_leaves(state), tstereo.state_leaves(st)))
    assert outs.tr.shape == (3, 6)
    with pytest.raises(ValueError, match="3 frames"):
        cstep(st, lefts[:2], rights[:2], g[:2])


@pytest.mark.parametrize("chunk,cut,expect", [
    (1, 4, ["ckpt_00000002.npz", "ckpt_00000004.npz"]),
    # chunk 3, every 2: the boundaries fall inside chunks, snapshots at
    # the chunks' ends (3 and 6), then the cut run's final one at 7
    (3, 7, ["ckpt_00000006.npz", "ckpt_00000007.npz"]),
])
def test_resumed_run_equals_uninterrupted_run(seq, whole, tmp_path, chunk,
                                              cut, expect):
    mgr = CheckpointManager(str(tmp_path), every=2)
    first = tstereo.run_stereo_sequence(
        seq.frames[:cut], seq.P1, seq.P2, CFG, seed=4, device="cpu",
        chunk=chunk, checkpoint=mgr)
    assert first.processed == cut
    assert sorted(p.name for p in tmp_path.iterdir()) == expect
    seen = []
    resumed = tstereo.run_stereo_sequence(
        seq.frames, seq.P1, seq.P2, CFG, seed=4, device="cpu", chunk=chunk,
        checkpoint=mgr, on_frame=lambda t, out: seen.append(t))
    _assert_same(resumed, whole)
    assert seen == list(range(cut, 10)) and resumed.processed == 10 - cut
    # a rerun of a finished sequence computes nothing
    again = tstereo.run_stereo_sequence(
        seq.frames, seq.P1, seq.P2, CFG, seed=4, device="cpu", chunk=chunk,
        checkpoint=mgr)
    _assert_same(again, whole)
    assert again.processed == 0


def test_resume_skips_the_decode_of_covered_frames(seq, whole, tmp_path):
    class Frames:
        """A stream with ``skipped``, as io.kitti.StereoImageStream."""

        def __init__(self, frames, begin=0):
            self.frames, self.begin, self.read = frames, begin, []

        def skipped(self, n):
            self.child = Frames(self.frames, self.begin + n)
            return self.child

        def __iter__(self):
            for i in range(self.begin, len(self.frames)):
                self.read.append(i)
                yield self.frames[i]

    mgr = CheckpointManager(str(tmp_path), every=3)
    tstereo.run_stereo_sequence(Frames(seq.frames[:6]), seq.P1, seq.P2, CFG,
                                seed=4, device="cpu", checkpoint=mgr)
    stream = Frames(seq.frames)
    resumed = tstereo.run_stereo_sequence(stream, seq.P1, seq.P2, CFG,
                                          seed=4, device="cpu",
                                          checkpoint=mgr)
    _assert_same(resumed, whole)
    assert stream.read == [] and stream.child.read == [6, 7, 8, 9]


@pytest.mark.parametrize("change", ["cfg", "seed", "backend", "scope"])
def test_changed_run_refuses_the_checkpoint(seq, tmp_path, change):
    mgr = CheckpointManager(str(tmp_path), every=2)
    kwargs = dict(cfg=CFG, seed=4, backend="dense", fingerprint_scope="0:9")
    tstereo.run_stereo_sequence(seq.frames[:2], seq.P1, seq.P2, device="cpu",
                                checkpoint=mgr, **kwargs)
    kwargs.update({
        "cfg": dict(cfg=dataclasses.replace(CFG, min_circle_matches=4)),
        "seed": dict(seed=5), "backend": dict(backend="fused"),
        "scope": dict(fingerprint_scope="1:9")}[change])
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        tstereo.run_stereo_sequence(seq.frames, seq.P1, seq.P2, device="cpu",
                                    checkpoint=mgr, **kwargs)


def test_checkpoint_file_round_trip_and_pruning(tmp_path):
    mgr = CheckpointManager(str(tmp_path), every=5, keep=2)
    fp = config_fingerprint(CFG, 1, "dense", scope="x")
    assert fp != config_fingerprint(CFG, 1, "dense", scope="y")
    for n in (5, 10, 15):
        mgr.save(Checkpoint(
            next_frame=n, motions=np.ones((n, 6), np.float32),
            oks=np.ones(n, bool),
            state_leaves=[np.arange(4, dtype=np.int32), np.zeros((2, 3))],
            stats=[{"frame": i} for i in range(n)], fingerprint=fp))
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "ckpt_00000010.npz", "ckpt_00000015.npz"]
    ck = mgr.latest()
    assert ck.next_frame == 15 and ck.fingerprint == fp
    assert ck.state_leaves[0].dtype == np.int32 and len(ck.stats) == 15
    assert CheckpointManager(str(tmp_path / "empty")).latest() is None


def _serve(seq, seq_b, n_a, n_b, **kwargs):
    return tms.run_multistream(
        [seq.frames[:n_a], seq_b.frames[:n_b]], [seq.P1, seq_b.P1],
        [seq.P2, seq_b.P2], CFG, seeds=[4, 9], device="cpu",
        backend="fused", **kwargs)


def test_serving_resume_equals_uninterrupted_run(seq, seq_b, tmp_path):
    """Streams of 10 and 7 frames, cut at timestep 4, then at 8 (past the
    shorter stream's end), then run to the end."""
    want = _serve(seq, seq_b, 10, 7)
    mgr = CheckpointManager(str(tmp_path), every=4)
    first = _serve(seq, seq_b, 4, 4, checkpoint=mgr)
    assert [r.processed for r in first] == [4, 4]
    second = _serve(seq, seq_b, 8, 7, checkpoint=mgr)
    assert [r.processed for r in second] == [4, 3]
    resumed = _serve(seq, seq_b, 10, 7, checkpoint=mgr)
    assert [r.processed for r in resumed] == [2, 0]
    for got, w in zip(resumed, want):
        _assert_same(got, w)
    assert [len(r.poses) for r in resumed] == [10, 7]


def test_serving_refuses_another_stream_set(seq, seq_b, tmp_path):
    mgr = CheckpointManager(str(tmp_path), every=2)
    _serve(seq, seq_b, 2, 2, checkpoint=mgr)
    with pytest.raises(ValueError, match="different stream set"):
        tms.run_multistream([seq.frames[:4], seq_b.frames[:4]],
                            [seq.P1, seq_b.P1], [seq.P2, seq_b.P2], CFG,
                            seeds=[4, 10], device="cpu", backend="fused",
                            checkpoint=mgr)
    with pytest.raises(ValueError, match="different stream set"):
        tms.run_multistream([seq.frames[:4]], [seq.P1], [seq.P2], CFG,
                            seeds=[4], device="cpu", backend="fused",
                            checkpoint=mgr)


def test_multistream_chunk_equals_the_stream_step(seq, seq_b):
    """S = 2 streams x K = 3 frames in one call against three S-stream
    steps; stream 1 idles on the chunk's last frame."""
    step = tms.build_multistream_step(CFG, "sweep")
    cstep = tms.build_multistream_chunk(CFG, 3, "sweep")
    calibs = [tstereo.Calib.from_projections(s.P1, s.P2)
              for s in (seq, seq_b)]
    F = torch.as_tensor(np.stack([tstereo.F_from_P_host(s.P1, s.P2)
                                  for s in (seq, seq_b)]),
                        dtype=torch.float32)
    lefts = torch.tensor(np.stack([[f[0] for f in s.frames[:3]]
                                   for s in (seq, seq_b)]))
    rights = torch.tensor(np.stack([[f[1] for f in s.frames[:3]]
                                    for s in (seq, seq_b)]))
    assert lefts.shape == (2, 3, 96, 160)
    g = [[sample_gumbel((H, N), frame_generator(s, t)) for t in range(3)]
         for s in range(2)]
    g[1][2] = None
    empty = tms.stack_states([tstereo.empty_state(CFG) for _ in range(2)])
    states, outs = cstep(calibs, F, empty, lefts, rights, g)
    st = empty
    for k in range(3):
        st, want = step(calibs, F, st, lefts[:, k], rights[:, k],
                        [g[0][k], g[1][k]])
        for s in range(2):
            if want[s] is None:
                assert outs[s][k] is None
            else:
                assert all(torch.equal(a, b)
                           for a, b in zip(outs[s][k], want[s]))
    assert all(torch.equal(a, b) for a, b in zip(
        tstereo.state_leaves(states), tstereo.state_leaves(st)))
    assert bool(outs[0][2].ok) and outs[1][2] is None
