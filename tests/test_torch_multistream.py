"""Multi-stream serving of the port (``pipeline/multistream.py``, ``cli
serve``).

The contract is the JAX package's (tests/test_multistream.py): stream s of
a multi-stream run equals its solo run in every discrete per-frame stat,
motions within atol 5e-6 and poses within 5e-5.  With the JAX package's
RANSAC draws injected, the port's run_multistream equals JAX's on the
discrete stats and within atol 5e-6 on the motions.  ``cli serve`` is
tests/test_torch_serve_cli.py's; the card's run is
tests/test_torch_cuda.py's and chip_smoke.py's.  The stream axis split
over a mesh (``jit_multistream_sharded``) equals the unsharded step bit
for bit.
"""

import numpy as np
import pytest
import torch

from libviso_tpu.config import DetectorConfig as JDetectorConfig
from libviso_tpu.config import PipelineConfig as JPipelineConfig
from libviso_tpu.config import RansacConfig as JRansacConfig
from libviso_tpu.pipeline.multistream import run_multistream as jax_multi
from libviso_torch.config import Calib, from_jax_config
from libviso_torch.geometry.mvg import F_from_P_host
from libviso_torch.parallel import make_mesh
from libviso_torch.pipeline import multistream as tms
from libviso_torch.pipeline.stereo import run_stereo_sequence
from libviso_torch.solvers.ransac import frame_generator, sample_gumbel
from libviso_torch.synthetic import generate_sequence
from tests.torch_parity import jax_frame_gumbel

STATS = ("frame", "ok", "num_kp1", "num_lr", "num_circle", "num_inliers")
# the tiny configuration of tests/test_multistream.py, with metric l1
JAX_CFG = JPipelineConfig(
    detector=JDetectorConfig(max_features=120, nbinx=6, nbiny=2,
                             num_slots=128),
    ransac=JRansacConfig(num_hypotheses=16, gn_iters=10)).with_metric("l1")
CFG = from_jax_config(JAX_CFG)


@pytest.fixture(scope="module")
def seqs():
    a = generate_sequence(num_frames=6, num_points=300, width=160,
                          height=96, f=120.0, seed=3)
    b = generate_sequence(num_frames=4, num_points=260, width=160,
                          height=96, f=140.0, seed=11, speed=0.6)
    c = generate_sequence(num_frames=4, num_points=280, width=160,
                          height=96, f=130.0, seed=21, speed=0.7)
    return a, b, c


def _assert_contract(got, want, motion_atol=5e-6):
    assert len(got.stats) == len(want.stats)
    assert [{k: s[k] for k in STATS} for s in got.stats] == \
        [{k: s[k] for k in STATS} for s in want.stats]
    np.testing.assert_array_equal(got.frame_ok, want.frame_ok)
    np.testing.assert_allclose(got.motions, want.motions, rtol=0,
                               atol=motion_atol)
    np.testing.assert_allclose(got.poses, want.poses, rtol=0, atol=5e-5)


@pytest.mark.parametrize("backend", ["dense", "fused", "sweep"])
def test_multistream_matches_solo_runs(seqs, backend):
    """Two streams of different scene, length, seed and focal length; the
    shorter one idles on its last frame."""
    a, b, _ = seqs
    solos = [run_stereo_sequence(sq.frames, sq.P1, sq.P2, CFG, seed=s,
                                 device="cpu", backend=backend)
             for s, sq in enumerate((a, b))]
    multi = tms.run_multistream([a.frames, b.frames], [a.P1, b.P1],
                                [a.P2, b.P2], CFG, seeds=[0, 1],
                                device="cpu", backend=backend)
    for got, solo in zip(multi, solos):
        _assert_contract(got, solo)
    assert solos[0].frame_ok[1:].all()


def test_multistream_matches_jax_with_injected_draws(seqs):
    a, b, _ = seqs
    args = ([a.frames, b.frames], [a.P1, b.P1], [a.P2, b.P2])
    jres = jax_multi(*args, JAX_CFG, seeds=[5, 9])
    H, N = CFG.ransac.num_hypotheses, CFG.detector.num_slots
    seeds = [5, 9]
    tres = tms.run_multistream(
        *args, CFG, seeds=seeds, device="cpu", backend="fused",
        draws=lambda s, t: jax_frame_gumbel(seeds[s], t, H, N))
    for got, want in zip(tres, jres):
        _assert_contract(got, want)


def test_stream_pool_replacement_gives_solo_results(seqs):
    """Slot 1 finishes first and is re-seeded with a third sequence; every
    sequence, original and replacement, reproduces its solo run."""
    a, b, c = seqs
    b_frames = b.frames[:3]
    solos = {
        "a": run_stereo_sequence(a.frames, a.P1, a.P2, CFG, seed=0,
                                 device="cpu"),
        "b": run_stereo_sequence(b_frames, b.P1, b.P2, CFG, seed=1,
                                 device="cpu"),
        "c": run_stereo_sequence(c.frames, c.P1, c.P2, CFG, seed=2,
                                 device="cpu"),
    }
    pool = tms.StreamPool(CFG, slots=2, device="cpu")
    pool.attach(0, a.frames, a.P1, a.P2, seed=0)
    pool.attach(1, b_frames, b.P1, b.P2, seed=1)
    results = {}
    while 1 not in pool.finished():
        pool.step()
    results["b"] = pool.detach(1)
    pool.attach(1, c.frames, c.P1, c.P2, seed=2)
    while pool.active():
        pool.step()
    results["a"] = pool.detach(0)
    results["c"] = pool.detach(1)
    for name, solo in solos.items():
        _assert_contract(results[name], solo)
    with pytest.raises(ValueError, match="not attached"):
        pool.detach(0)
    with pytest.raises(ValueError, match="pool shape"):
        pool.attach(0, [(np.zeros((8, 8)), np.zeros((8, 8)))], a.P1, a.P2)


def test_on_stage_marks_every_stage_of_every_step(seqs):
    a, b, _ = seqs
    stages = []
    tms.run_multistream([a.frames, b.frames], [a.P1, b.P1], [a.P2, b.P2],
                        CFG, device="cpu", on_stage=stages.append)
    assert stages == ["front_end", "match", "correspondences",
                      "solves"] * len(a.frames)


def test_stack_states_round_trip():
    states = [tms.empty_state(CFG) for _ in range(3)]
    stacked = tms.stack_states(states)
    assert stacked.kp1.xy.shape == (3, 128, 2)
    assert stacked.fail_age.shape == (3,)


def test_options_not_ported_raise(seqs):
    """Nothing of serving is left unported: the sharded step and metric
    'l2q8', which used to raise NotImplementedError, now run; each 'l2q8'
    stream equals its solo 'l2q8' run."""
    a, b, _ = seqs
    cfg = CFG.with_metric("l2q8")
    mesh = make_mesh(n_data=2, devices=["cpu"] * 2)
    assert callable(tms.jit_multistream_sharded(mesh, CFG))
    multi = tms.run_multistream([a.frames, b.frames], [a.P1, b.P1],
                                [a.P2, b.P2], cfg, seeds=[0, 1],
                                device="cpu")
    for res, seq, seed in zip(multi, (a, b), (0, 1)):
        _assert_contract(res, run_stereo_sequence(
            seq.frames, seq.P1, seq.P2, cfg, seed=seed, device="cpu"))
        assert res.frame_ok[1:].all()
    assert callable(tms.build_multistream_chunk(cfg, 2))


def _leaves_equal(x, y):
    return all(torch.equal(u, v) for u, v in zip(
        tms.state_leaves(x), tms.state_leaves(y)))


@pytest.mark.parametrize("chunk", [1, 2])
def test_sharded_step_equals_unsharded_bitwise(seqs, chunk):
    """4 streams over 2 entries of a CPU mesh: every stream's new state
    and output equal the unsharded step's bit for bit, at each step."""
    a, b, c = seqs
    streams = [a, b, c, a]
    S, K = len(streams), chunk
    calibs = [Calib.from_projections(s.P1, s.P2) for s in streams]
    F = torch.as_tensor(np.stack([F_from_P_host(s.P1, s.P2)
                                  for s in streams]), dtype=torch.float32)
    shape = (CFG.ransac.num_hypotheses, CFG.detector.num_slots)
    mesh = make_mesh(n_data=2, devices=["cpu"] * 2)
    sharded = tms.jit_multistream_sharded(mesh, CFG, chunk=chunk)
    plain = (tms.build_multistream_chunk(CFG, chunk) if chunk > 1
             else tms.build_multistream_step(CFG))
    st_p = st_s = tms.stack_states([tms.empty_state(CFG)] * S)
    for t0 in range(0, 4, K):
        ims = [torch.as_tensor(np.stack([np.stack(
            [s.frames[t][v] for t in range(t0, t0 + K)]) for s in streams]))
            for v in (0, 1)]
        if chunk == 1:
            ims = [x[:, 0] for x in ims]
        g = [[sample_gumbel(shape, frame_generator(i, t))
              for t in range(t0, t0 + K)] for i in range(S)]
        if chunk == 1:
            g = [x[0] for x in g]
        st_p, out_p = plain(calibs, F, st_p, *ims, g)
        st_s, out_s = sharded(calibs, F, st_s, *ims, g)
        assert _leaves_equal(st_p, st_s)
        flat = (lambda o: [x for xs in o for x in xs]) if chunk > 1 else list
        for op, os_ in zip(flat(out_p), flat(out_s)):
            assert all(torch.equal(u, v) for u, v in zip(op, os_))
    with pytest.raises(ValueError, match="split"):
        tms.jit_multistream_sharded(make_mesh(n_data=3,
                                              devices=["cpu"] * 3), CFG)(
            calibs, F, st_p, *ims, g)
