"""Loop closure of libviso_torch against libviso_tpu.

One JAX run of ``run_with_loop_closure`` on the 48-frame circle of
``tests/test_loop_closure.py`` (its ``tiny_config()``, keyframe_every 4,
min_gap 24, min_matches 40, min_inliers 20, seed 0) is the reference; the
port runs the same frames on the CPU with the JAX package's per-frame and
verification draws injected (``tests/torch_parity.py``).  Measured: the
per-frame discrete stats, the candidate list and the loop edge (44 -> 0,
28 inliers) equal, poses within 2e-5 m, graph costs within 1e-4 relative.
Held: discrete stats, candidates, loop pairs and ``ok``s equal, inliers
within 2 %, poses within 1e-3 m, the optimized endpoint closer to the
truth than the open chain's (``tests/test_loop_closure.py:58``).

The engine's pieces are held on the JAX run's own data: ``LoopEngine.offer``
from the JAX store at frame 44 (``loop_state_from_jax``),
``summarize_keyframe`` on its frame state, the candidate and guided
matchers under each backend's plain version at l1 and dense at l2, and
``_spatial_evict_slot``.  Port-only: the straight drive closes no loop, a
loop-mode resume is bit-exact, and spatial and fifo eviction keep the JAX
package's counts.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libviso_tpu.pipeline.loop as jl
import libviso_tpu.pipeline.stereo as jstereo
from libviso_tpu.config import Calib as JCalib
from libviso_torch.config import Calib, from_jax_config
from libviso_torch.pipeline import loop as tl
from libviso_torch.pipeline.stereo import state_from_leaves
from libviso_torch.synthetic import generate_sequence
from libviso_torch.utils.checkpoint import CheckpointManager
from tests.test_loop_closure import _circle_sequence, tiny_config
from tests.torch_parity import (
    jax_frame_gumbel,
    jax_loop_verify_gumbel,
    to_np,
    to_torch,
)

KW = dict(keyframe_every=4, min_gap=24, min_matches=40, min_inliers=20,
          seed=0)
STATS = ("ok", "num_kp1", "num_lr", "num_circle", "num_inliers")
JCFG = tiny_config()
CFG = from_jax_config(JCFG)
H, N = CFG.ransac.num_hypotheses, CFG.detector.num_slots
VERIFY_H = max(256, H)
PROBE_T = 44     # the keyframe that closes the loop


def _draws(seed=0):
    return dict(
        draws=lambda t: jax_frame_gumbel(seed, t, H, N),
        verify_draws=lambda t, it: jax_loop_verify_gumbel(
            seed, t, it, VERIFY_H, min(256, N)))


@pytest.fixture(scope="module")
def circle():
    return _circle_sequence()


@pytest.fixture(scope="module")
def jax_run(circle):
    """The JAX run, with each frame's output and, at keyframe PROBE_T, the
    frame state, the store and the keyframe it offers."""
    outs, probe = [], {}
    real_step_factory = jstereo._jitted_step
    real_offer = jl.LoopEngine.offer

    def step_factory(*args):
        step = real_step_factory(*args)

        def recording(state, *a):
            new_state, out = step(state, *a)
            outs.append(out)
            probe["state"] = new_state
            return new_state, out
        return recording

    def offer(self, t, xy, desc, obs, X, valid, pos_fn):
        if t == PROBE_T:
            probe.update(
                leaves=[np.array(x) for x in self.state_leaves()],
                loop_stats=self.loop_stats(),
                keyframe=[np.asarray(a) for a in (xy, desc, obs, X, valid)],
                frame_state=[np.asarray(x) for x in
                             jax.tree_util.tree_leaves(probe["state"])],
                n_candidates=len(self.candidates))
        return real_offer(self, t, xy, desc, obs, X, valid, pos_fn)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jstereo, "_jitted_step", step_factory)
        mp.setattr(jl.LoopEngine, "offer", offer)
        res = jl.run_with_loop_closure(list(circle.frames), circle.P1,
                                       circle.P2, cfg=JCFG, **KW)
    stats = [{"ok": bool(o.ok) and t > 0, "num_kp1": int(o.num_kp1),
              "num_lr": int(o.num_lr), "num_circle": int(o.num_circle),
              "num_inliers": int(o.num_inliers)}
             for t, o in enumerate(outs)]
    return res, stats, probe


@pytest.fixture(scope="module")
def port_run(circle):
    return tl.run_with_loop_closure(list(circle.frames), circle.P1,
                                    circle.P2, CFG, device="cpu", **KW,
                                    **_draws())


def _pairs(loops):
    return [(le.frame_new, le.frame_old) for le in loops]


def _candidate_keys(cands):
    return [(c["frame_new"], c["frame_old"], c["score"], c["ok"])
            for c in cands]


def test_loop_run_matches_jax(circle, jax_run, port_run):
    jres, jstats, _ = jax_run
    tres = port_run
    assert [{k: s[k] for k in STATS} for s in tres.stats] == jstats
    np.testing.assert_array_equal(tres.frame_ok, jres.frame_ok)
    assert _candidate_keys(tres.candidates) == \
        _candidate_keys(jres.candidates)
    assert _pairs(tres.loops) == _pairs(jres.loops) == [(44, 0)]
    for a, b in zip(tres.loops, jres.loops):
        assert abs(a.num_inliers - b.num_inliers) <= 0.02 * b.num_inliers
        assert a.num_matches == b.num_matches
    np.testing.assert_allclose(tres.poses_vo, jres.poses_vo, atol=1e-3)
    np.testing.assert_allclose(tres.poses, jres.poses, atol=1e-3)
    np.testing.assert_allclose(tres.graph_cost, jres.graph_cost, rtol=1e-3)
    np.testing.assert_allclose(tres.loop_edge_scale, jres.loop_edge_scale,
                               atol=1e-4)
    assert tres.graph_cost[1] < tres.graph_cost[0]
    gt = circle.gt_poses
    err_vo = np.linalg.norm(tres.poses_vo[:, :3, 3] - gt[:, :3, 3], axis=1)
    err_opt = np.linalg.norm(tres.poses[:, :3, 3] - gt[:, :3, 3], axis=1)
    assert err_opt[-1] < err_vo[-1]
    assert tres.keyframes_offered == jres.keyframes_offered == 12
    assert tres.processed == len(gt)


def test_offer_from_the_jax_store(circle, jax_run):
    """The port's engine, given the JAX store before keyframe 44 and the
    JAX keyframe, verifies the same candidate into the same loop edge."""
    jres, _, probe = jax_run
    eng = tl.LoopEngine(CFG, Calib.from_projections(circle.P1, circle.P2),
                        0, device="cpu", keyframe_every=4, min_gap=24,
                        min_matches=40, min_inliers=20,
                        verify_draws=_draws()["verify_draws"])
    eng.restore(probe["leaves"], probe["loop_stats"])
    assert eng.n_kf == 11 and len(eng.loops) == 0
    xy, desc, obs, X, valid = map(to_torch, probe["keyframe"])
    eng.offer(PROBE_T, xy, desc, obs, X, valid,
              lambda: np.zeros(3, np.float32))
    want = jres.candidates[probe["n_candidates"]:]
    assert [{k: c[k] for k in ("frame_new", "frame_old", "score", "ok",
                               "num_inliers", "refined_inliers",
                               "refine_trace")} for c in eng.candidates] == \
        [{k: c[k] for k in ("frame_new", "frame_old", "score", "ok",
                            "num_inliers", "refined_inliers",
                            "refine_trace")} for c in want]
    assert len(eng.loops) == 1
    np.testing.assert_allclose(eng.loops[0].tr, jres.loops[0].tr, atol=1e-4)
    # the new keyframe went into slot n_kf of the ring
    assert eng.kf_frames[11] == PROBE_T and eng.n_kf == 12
    leaves = eng.state_leaves()
    assert [x.dtype for x in leaves] == [np.asarray(x).dtype
                                        for x in probe["leaves"]]


def test_summarize_keyframe_matches_jax(jax_run):
    _, _, probe = jax_run
    st = state_from_leaves(probe["frame_state"])
    for normalize in (True, False):
        got = tl._build_summarize(256, CFG.detector.descriptor_dim,
                                  normalize)(st)
        want = jl._build_summarize(256, JCFG.detector.descriptor_dim,
                                   normalize)(
            jstereo.FrameState(*jax.tree_util.tree_unflatten(
                jax.tree_util.tree_structure(jstereo.empty_state(JCFG)),
                [jnp.asarray(x) for x in probe["frame_state"]])))
        for g, w in zip(got, want):
            np.testing.assert_allclose(to_np(g), np.asarray(w), rtol=1e-6,
                                       atol=1e-6 if not normalize else 1e-3)
    # the keyframe the JAX run offered is its normalized summary
    got = tl._build_summarize(256, CFG.detector.descriptor_dim, True)(st)
    for g, w in zip(got, probe["keyframe"]):
        np.testing.assert_allclose(to_np(g), w, atol=1e-3)


# (metric, backend of the port): each backend's plain version under l1,
# dense under l2 and l2q8; the JAX package's dense ("xla") matcher is the
# reference
MATCHERS = [("l1", "dense"), ("l1", "fused"), ("l1", "sweep"),
            ("l2", "dense"), ("l2q8", "dense")]
STORE = 16   # the first 16 store slots (11 hold keyframes at frame 44)


@pytest.mark.parametrize("metric,backend", MATCHERS)
def test_candidate_matcher_matches_jax(jax_run, metric, backend):
    _, _, probe = jax_run
    xy, desc, _, _, valid = probe["keyframe"]
    kf_xy, kf_desc, kf_valid = (x[:STORE] for x in probe["leaves"][:3])
    args = (xy, desc, valid, kf_xy, kf_desc, kf_valid)
    want = jl._build_candidate_matcher(JCFG.with_metric(metric), STORE, 256,
                                       "xla", 0.8)(*map(jnp.asarray, args))
    got = tl._build_candidate_matcher(CFG.with_metric(metric), STORE, 256,
                                      backend, 0.8)(*map(to_torch, args))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_np(g), np.asarray(w))
    assert int(got[2].max()) >= 40


@pytest.mark.parametrize("metric,backend", MATCHERS)
def test_guided_matcher_matches_jax(circle, jax_run, metric, backend):
    jres, _, probe = jax_run
    xy, desc, _, X, valid = probe["keyframe"]
    slot = int(np.nonzero(probe["leaves"][4] == 0)[0][0])
    X_old = probe["leaves"][3][slot]
    d_old, v_old = probe["leaves"][1][slot], probe["leaves"][2][slot]
    tr = np.asarray(jres.loops[0].tr, np.float32)
    jcal = JCalib.from_projections(circle.P1, circle.P2)
    tcal = Calib.from_projections(circle.P1, circle.P2)
    for args in ((tr, X_old, d_old, v_old, xy, desc, valid),
                 (-tr, X, desc, valid, probe["leaves"][0][slot], d_old,
                  v_old)):
        want = jl._build_guided_matcher(JCFG.with_metric(metric), 256,
                                        "xla", jcal, 16.0)(
            *map(jnp.asarray, args))
        got = tl._build_guided_matcher(CFG.with_metric(metric), 256,
                                       backend, tcal, 16.0)(
            *map(to_torch, args))
        np.testing.assert_array_equal(to_np(got[1]), np.asarray(want[1]))
        ok = np.asarray(want[1])
        np.testing.assert_array_equal(to_np(got[0]), np.asarray(want[0]))
        # l2 distances come from |a|^2 + |b|^2 - 2ab on descriptors of
        # norm 1024: the matmuls' rounding differs by up to 1.5e-4 of the
        # distance (measured); l1 sums agree within 1e-6
        np.testing.assert_allclose(to_np(got[2])[ok], np.asarray(want[2])[ok],
                                   rtol=1e-6 if metric == "l1" else 1e-3)
    assert ok.sum() > 16


def test_spatial_evict_slot_matches_jax():
    rng = np.random.default_rng(0)
    for trial in range(20):
        n = int(rng.integers(2, 40))
        pos = rng.normal(size=(n, 3)).astype(np.float32)
        if trial % 3 == 0:
            pos[rng.integers(n)] = pos[rng.integers(n)]    # a duplicate
        frames = rng.permutation(1000)[:n].astype(np.int64)
        new = (pos[rng.integers(n)] if trial % 4 == 0
               else rng.normal(size=3).astype(np.float32))
        assert tl._spatial_evict_slot(pos, frames, new) == \
            jl._spatial_evict_slot(pos, frames, new)


@pytest.fixture(scope="module")
def straight():
    return generate_sequence(num_frames=16, num_points=500, seed=5,
                             width=416, height=160)


def test_no_loops_on_straight_drive(straight):
    res = tl.run_with_loop_closure(list(straight.frames), straight.P1,
                                   straight.P2, CFG, keyframe_every=4,
                                   min_gap=24, seed=0, device="cpu")
    assert res.loops == [] and res.graph_cost == (0.0, 0.0)
    np.testing.assert_array_equal(res.poses, res.poses_vo)
    assert res.frame_ok[1:].all()


@pytest.mark.parametrize("eviction", ["spatial", "fifo"])
def test_eviction_counts_match_jax(straight, eviction):
    """A 3-slot store on the straight drive, a keyframe every 2 frames:
    the same evictions and skips as the JAX package's, poses within 1e-3
    m.  Spatial eviction evicts or skips once the store is full, fifo
    neither counts."""
    frames = list(straight.frames)[:12]
    kw = dict(keyframe_every=2, min_gap=24, max_keyframes=3, seed=0,
              eviction=eviction)
    jres = jl.run_with_loop_closure(frames, straight.P1, straight.P2,
                                    cfg=JCFG, **kw)
    tres = tl.run_with_loop_closure(frames, straight.P1, straight.P2, CFG,
                                    device="cpu", **kw, **_draws())
    assert (tres.evictions, tres.store_skipped, tres.keyframes_offered) == \
        (jres.evictions, jres.store_skipped, jres.keyframes_offered)
    assert tres.keyframes_offered == 6
    if eviction == "spatial":
        assert tres.evictions + tres.store_skipped == 3
    else:
        assert tres.evictions == tres.store_skipped == 0
    np.testing.assert_allclose(tres.poses, jres.poses, atol=1e-3)


def test_bad_eviction_raises():
    with pytest.raises(ValueError, match="eviction"):
        tl.LoopEngine(CFG, Calib(1.0, 0.0, 0.0, 1.0), eviction="lru",
                      device="cpu")


def test_resume_is_bit_exact(circle, port_run, tmp_path):
    """Cut at frame 30 (snapshots at 20 and 30) and resumed: the
    uninterrupted run's loops, candidates, stats and poses, bit for bit;
    the store and the loop edge (found at frame 44) come back from the
    snapshot."""
    frames = list(circle.frames)
    mgr = CheckpointManager(str(tmp_path), every=20)
    cut = tl.run_with_loop_closure(frames[:30], circle.P1, circle.P2, CFG,
                                   device="cpu", checkpoint=mgr, **KW,
                                   **_draws())
    assert cut.processed == 30 and cut.loops == []
    resumed = tl.run_with_loop_closure(frames, circle.P1, circle.P2, CFG,
                                       device="cpu", checkpoint=mgr, **KW,
                                       **_draws())
    assert resumed.processed == len(frames) - 30
    assert resumed.stats == port_run.stats
    assert resumed.candidates == port_run.candidates
    assert _pairs(resumed.loops) == _pairs(port_run.loops)
    for a, b in zip(resumed.loops, port_run.loops):
        np.testing.assert_array_equal(a.tr, b.tr)
    np.testing.assert_array_equal(resumed.poses, port_run.poses)
    np.testing.assert_array_equal(resumed.motions, port_run.motions)
    assert resumed.graph_cost == port_run.graph_cost
    # a rerun restores everything and computes nothing
    again = tl.run_with_loop_closure(frames, circle.P1, circle.P2, CFG,
                                     device="cpu", checkpoint=mgr, **KW,
                                     **_draws())
    assert again.processed == 0
    np.testing.assert_array_equal(again.poses, port_run.poses)
    # another knob is another fingerprint
    with pytest.raises(ValueError, match="fingerprint"):
        tl.run_with_loop_closure(frames, circle.P1, circle.P2, CFG,
                                 device="cpu", checkpoint=mgr,
                                 **{**KW, "min_gap": 20})


def test_cuda_device_without_a_card_raises(circle, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tl.run_with_loop_closure(list(circle.frames)[:2], circle.P1,
                                 circle.P2, CFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tl.close_graph(np.tile(np.eye(4, dtype=np.float32), (3, 1, 1)), [1],
                       [])


def test_loop_state_from_jax_round_trip(jax_run):
    _, _, probe = jax_run
    st = tl.loop_state_from_jax(probe["leaves"], [
        {"new": 9, "old": 1, "tr": [0.1] * 6, "inliers": 30,
         "matches": 70}])
    assert st.kf_desc.dtype == torch.float32 and st.kf_valid.dtype == \
        torch.bool
    assert st.n_kf == 11 and st.loops[0].frame_old == 1
    assert st.kf_frames.dtype == np.int64 and st.kf_X.dtype == np.float32
    eng = tl.LoopEngine(dataclasses.replace(CFG), Calib(1.0, 0.0, 0.0, 1.0),
                        device="cpu")
    eng.restore(probe["leaves"], [])
    for a, b in zip(eng.state_leaves(), probe["leaves"]):
        np.testing.assert_array_equal(a, b)
