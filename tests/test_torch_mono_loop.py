"""The mono Sim(3) loop back-end of libviso_torch against libviso_tpu.

One JAX run of ``run_mono_sim3_loop`` on the two-lap plaza circuit of
``tests/test_sim3.py`` (81 frames of 416x160, ``mono_config()`` with
subpixel corners, metric l2, a keyframe every 4 frames, min_gap 20, seed
0): 80/80 solved and 3 loops, 28 -> 68, 32 -> 72 and 36 -> 76.  The port
runs the same frames on the CPU with the JAX package's per-frame and
verification draws and its 5-point null basis injected.

The front-end is the port's mono path, whose float32 stages agree with
XLA's only to the last bits, so among RANSAC candidates of near-equal
quality another can win; on this rotation-dominated circuit (9 degrees a
frame) the winners' inlier sets differ more than on
``tests/test_torch_mono.py``'s straight drive, and the propagated scale,
which wanders 2-3x a lap in both packages, wanders apart.  Measured:
every frame's ``ok``, the keyframes and the temporal match counts equal;
inliers at most 21 % apart (frame 21), scale support 2 of 33 apart; the
same three loop pairs with inliers at most 13 % apart and relative scales 3.90 / 2.53 / 1.67 against JAX's
3.37 / 2.00 / 1.12.  Held: ``ok``, keyframes, match counts and loop pairs
equal, inliers within 25 %, loop inliers within 20 %, the corrected
Sim(3) ATE within max(1.5 J, J + 0.02 m) of JAX's J and not above 1.01x
the port's open chain (``tests/test_sim3.py:285``), a node scale above
1.3.  The port's own loop edges weigh at most 0.14 after the annealed
knee (JAX's 0.85), as their scales differ; so the edge weight property
is held where the back-end gets JAX's edges.

The back-end's pieces are held on the JAX run's own data: the keyframe
summary of a JAX MonoState, the Sim(3) verification of JAX's keyframes
with JAX's draws (the same inlier count, Z within 1e-4), and the Sim(3)
graph on JAX's open chain and loop edges (``close_sim3_graph``: poses,
node scales, edge weights and costs of the JAX run).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libviso_tpu.pipeline.mono_loop as jml
from libviso_tpu.config import MonoConfig as JMonoConfig
from libviso_tpu.synthetic_world import generate_plaza_sequence
from libviso_tpu.utils.metrics import ate_rmse
from libviso_torch.config import from_jax_config
from libviso_torch.pipeline import mono as tmono
from libviso_torch.pipeline import mono_loop as tml
from libviso_torch.synthetic import generate_sequence
from tests.test_mono import mono_config
from tests.torch_parity import (
    jax_mono_gumbel,
    jax_null_basis,
    jax_sim3_verify_gumbel,
    to_np,
    to_torch,
)

KW = dict(keyframe_every=4, min_gap=20, seed=0)


def _config():
    cfg = mono_config()
    return dataclasses.replace(cfg, detector=dataclasses.replace(
        cfg.detector, subpixel=True))


JCFG = _config()
CFG = from_jax_config(JCFG)


def _port_kw(seed=0):
    h1, h2 = tmono.mono_hypotheses(from_jax_config(JMonoConfig()))
    n = CFG.detector.num_slots
    return dict(draws=lambda t: jax_mono_gumbel(seed, t, h1, h2, n),
                verify_draws=lambda q: jax_sim3_verify_gumbel(seed, q, 128,
                                                              256),
                null_basis=jax_null_basis)


@pytest.fixture(scope="module")
def plaza():
    return generate_plaza_sequence(num_frames=81, seed=5, circuits=2)


@pytest.fixture(scope="module")
def jax_run(plaza):
    """The JAX run, recording each keyframe summary (with the MonoState it
    summarized) and each Sim(3) verification call."""
    summaries, verifications = [], []
    real_summarize, real_verifier = (jml._build_kf_summarize,
                                     jml._build_sim3_verifier)

    def summarize_factory(*a):
        fn = real_summarize(*a)

        def recording(state):
            out = fn(state)
            summaries.append((state, [np.asarray(x) for x in out]))
            return out
        return recording

    def verifier_factory(*a):
        fn = real_verifier(*a)

        def recording(key, *args):
            out = fn(key, *args)
            verifications.append((key, [np.asarray(x) for x in args],
                                  [np.asarray(x) for x in out]))
            return out
        return recording

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jml, "_build_kf_summarize", summarize_factory)
        mp.setattr(jml, "_build_sim3_verifier", verifier_factory)
        res = jml.run_mono_sim3_loop([f[0] for f in plaza.frames],
                                     plaza.P1[:, :3], JCFG, **KW)
    return res, summaries, verifications


@pytest.fixture(scope="module")
def port_run(plaza):
    return tml.run_mono_sim3_loop([f[0] for f in plaza.frames],
                                  plaza.P1[:, :3], CFG, device="cpu", **KW,
                                  **_port_kw())


def test_mono_loop_matches_jax(plaza, jax_run, port_run):
    jres, _, _ = jax_run
    tres = port_run
    np.testing.assert_array_equal(tres.frame_ok, jres.frame_ok)
    assert tres.frame_ok[1:].all()
    np.testing.assert_array_equal(tres.kf_frames, jres.kf_frames)
    for a, b in zip(tres.stats, jres.stats):
        assert a["num_matches"] == b["num_matches"], a["frame"]
        assert abs(a["num_inliers"] - b["num_inliers"]) <= \
            0.25 * b["num_inliers"], a["frame"]
    pairs = [(le.frame_old, le.frame_new) for le in jres.loops]
    assert [(le.frame_old, le.frame_new) for le in tres.loops] == pairs
    assert pairs == [(28, 68), (32, 72), (36, 76)]
    for a, b in zip(tres.loops, jres.loops):
        assert abs(a.num_inliers - b.num_inliers) <= 0.2 * b.num_inliers
        assert a.num_inliers >= 20
    gt = plaza.gt_poses
    j = ate_rmse(jres.poses, gt, align="sim3")
    ate_c = ate_rmse(tres.poses, gt, align="sim3")
    assert ate_c <= max(1.5 * j, j + 0.02)
    assert ate_c <= 1.01 * ate_rmse(tres.poses_vo, gt, align="sim3")
    assert tres.graph_cost[1] <= tres.graph_cost[0]
    assert tres.node_scales.max() > 1.3
    nodes = {0, len(gt) - 1} | set(tres.kf_frames.tolist())
    assert len(tres.node_scales) == len(nodes)
    assert len(tres.edge_scale) == len(tres.loops)


def test_kf_summarize_matches_jax(jax_run):
    """The summary of the JAX MonoState of three keyframes: the same
    slots, depths and validity; descriptors (normalized, x1024) within
    1e-3."""
    _, summaries, _ = jax_run
    import jax

    summarize = tml._build_kf_summarize(256, CFG.detector.descriptor_dim)
    for state, want in summaries[::7]:
        st = tmono.mono_state_from_jax(
            [np.asarray(x) for x in jax.tree_util.tree_leaves(state)])
        got = summarize(st)
        for k, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_allclose(to_np(g), w,
                                       atol=1e-3 if k == 1 else 0.0)


def test_sim3_verifier_matches_jax(plaza, jax_run):
    """Every Sim(3) verification of the JAX run, on its keyframes and
    draws: the same inlier and candidate counts, Z within 1e-4."""
    import jax

    _, _, verifications = jax_run
    verify = tml._build_sim3_verifier(plaza.P1[:, :3], 256, 128, 0.5)
    assert len(verifications) >= 3
    for key, args, (Z, n_inl, n_pv) in verifications:
        gumbel = to_torch(jax.random.gumbel(key, (128, 256), jnp.float32))
        gZ, g_inl, g_pv = verify(gumbel, *map(to_torch, args))
        assert int(g_inl) == int(n_inl) and int(g_pv) == int(n_pv)
        np.testing.assert_allclose(to_np(gZ), Z, atol=1e-4)


def test_sim3_back_end_matches_jax(jax_run):
    """The Sim(3) graph on the JAX run's own open chain, keyframes and
    loop edges (z, frames): the corrected poses, node scales, loop edge
    weights and costs of the JAX run, and the properties
    ``tests/test_sim3.py`` pins (an edge weight above 0.5, a node scale
    above 1.3).

    Poses and node scales are held to the Sim(3) Cauchy tolerance of
    ``tests/test_torch_pose_graph.py`` (measured 6.4e-4 and 8.7e-5).  The
    edge weights are not held to its 1e-4: the last knee, 0.05, turns a
    residual gap of about 2e-4 (float32 rounding over three solves) into
    a weight gap 12x larger; measured 2.1e-3 (0.8440 against JAX's
    0.8461), held within 5e-3.  Costs measured within 4.5e-4 relative."""
    jres, _, _ = jax_run
    poses, cost, node_scales, edge_scale = tml.close_sim3_graph(
        jres.poses_vo, jres.kf_frames.tolist(), jres.loops, device="cpu")
    np.testing.assert_allclose(poses, jres.poses, atol=2e-3)
    np.testing.assert_allclose(node_scales, jres.node_scales, atol=2e-3)
    np.testing.assert_allclose(edge_scale, jres.edge_scale, atol=5e-3)
    np.testing.assert_allclose(cost, jres.graph_cost, rtol=1e-3)
    assert edge_scale.max() > 0.5 and node_scales.max() > 1.3


def test_no_loop_returns_the_open_chain():
    seq = generate_sequence(num_frames=8, num_points=600, seed=13,
                            width=416, height=160, speed=0.6, yaw_rate=0.01)
    res = tml.run_mono_sim3_loop([f[0] for f in seq.frames],
                                 seq.P1[:, :3], CFG, device="cpu",
                                 keyframe_every=2, min_gap=50)
    assert res.loops == [] and res.graph_cost == (0.0, 0.0)
    np.testing.assert_array_equal(res.poses, res.poses_vo)
    assert list(res.kf_frames) == [2, 4, 6]
    np.testing.assert_array_equal(res.node_scales, np.ones(3, np.float32))
    assert res.frame_ok[1:].all()


def test_cuda_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tml.run_mono_sim3_loop([np.zeros((16, 16), np.uint8)],
                               np.eye(3), CFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tml.close_sim3_graph(np.tile(np.eye(4, dtype=np.float32), (3, 1, 1)),
                             [1], [])
