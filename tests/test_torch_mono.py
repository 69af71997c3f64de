"""The monocular slice of libviso_torch against libviso_tpu.

Both packages run ``tests/test_mono.py``'s 8-frame 416x160 sequence under
its ``mono_config()``; the port gets the JAX package's RANSAC draws and
5-point null-space basis (``tests/torch_parity.py``).  The float32 stages
agree with XLA's only to the last bits (``tests/test_torch_five_point.py``
says why), so among RANSAC candidates of near-equal quality (about 1400 a
pass) another one can win, and its refit lands on another inlier set of
about the same size.  Per frame ``ok`` and the temporal match count are
equal; the inlier count is within 3 %, the scale support within 2 %, the
unit-translation transforms within 1e-2 and the Sim(3) ATE within
max(1.5 J, J + 0.02 m) of JAX's J.  (Measured with JAX's draws of seeds
0-3: inliers at most 2.4 % apart, scale support 1.2 %, transforms 4.2e-3,
ATE 1.7 %; most frames equal.)  With the port's own basis and draws,
``ok`` and the same ATE bound hold.

Also one step from the JAX package's state (``mono_state_from_jax``).
The options of the slice are in ``tests/test_torch_mono_options.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libviso_tpu.config import MonoConfig as JMonoConfig
from libviso_tpu.pipeline import mono as jmono
from libviso_tpu.synthetic import generate_sequence
from libviso_tpu.utils.metrics import ate_rmse
from libviso_torch.config import from_jax_config
from libviso_torch.pipeline import mono as tmono
from tests.test_mono import mono_config
from tests.torch_parity import jax_mono_gumbel, jax_null_basis

STATS = ("frame", "ok", "num_matches")


@pytest.fixture(scope="module")
def seq():
    return generate_sequence(num_frames=8, num_points=600, seed=13,
                             width=416, height=160, speed=0.6,
                             yaw_rate=0.01)


def _jax_run(frames, K, cfg, mono=None):
    """The JAX package's run_mono_sequence, step by step: returns its
    per-frame states (numpy leaves, state t = after frame t), outputs and
    chained result."""
    mono = mono or JMonoConfig()
    step = jmono._jitted_mono_step(
        np.ascontiguousarray(K, np.float64).tobytes(), cfg, mono, "xla",
        None)
    key = jax.random.PRNGKey(0)
    state = jmono.empty_mono_state(cfg)
    states, outs = [], []
    for t, im in enumerate(frames):
        state, out = step(state, jnp.asarray(im), jax.random.fold_in(key, t))
        states.append([np.asarray(x) for x in jax.tree_util.tree_leaves(
            state)])
        outs.append(out)
    poses, oks, speeds, stats = jmono.chain_mono_outputs(outs, mono)
    return states, outs, jmono.MonoResult(poses=poses, frame_ok=oks,
                                          stats=stats, speeds=speeds)


def _draws(cfg, mono=None):
    h1, h2 = tmono.mono_hypotheses(from_jax_config(mono or JMonoConfig()))
    n = cfg.detector.num_slots
    return lambda t: jax_mono_gumbel(0, t, h1, h2, n)


@pytest.fixture(scope="module")
def runs(seq):
    K = seq.P1[:, :3]
    frames = [f[0] for f in seq.frames]
    cfg = mono_config()
    states, outs, jres = _jax_run(frames, K, cfg)
    tres = tmono.run_mono_sequence(
        frames, K, from_jax_config(cfg), seed=0, device="cpu",
        draws=_draws(cfg), null_basis=jax_null_basis)
    return states, outs, jres, tres


def _unit_steps(poses, speeds):
    """Per-frame transforms with unit translation, from chained poses."""
    out = []
    for k in range(1, len(poses)):
        d = np.linalg.inv(poses[k - 1]) @ poses[k]
        d[:3, 3] /= max(speeds[k], 1e-12)
        out.append(d)
    return np.stack(out)


def _ate_bound(j):
    return max(1.5 * j, j + 0.02)


def test_slice_equals_jax_with_injected_draws_and_basis(seq, runs):
    _, _, jres, tres = runs
    for a, b in zip(tres.stats, jres.stats):
        assert {k: a[k] for k in STATS} == {k: b[k] for k in STATS}, a
        assert abs(a["num_inliers"] - b["num_inliers"]) <= \
            0.03 * b["num_inliers"], (a, b)
        assert abs(a["scale_support"] - b["scale_support"]) <= \
            0.02 * b["scale_support"], (a, b)
    assert tres.frame_ok[1:].all()
    err = np.abs(_unit_steps(tres.poses, tres.speeds)
                 - _unit_steps(jres.poses, jres.speeds)).max()
    J = ate_rmse(jres.poses, seq.gt_poses, align="sim3")
    ate = ate_rmse(tres.poses, seq.gt_poses, align="sim3")
    print(f"unit transforms max difference {err}; Sim(3) ATE {ate} m, "
          f"JAX {J} m; inliers {[s['num_inliers'] for s in tres.stats]} / "
          f"{[s['num_inliers'] for s in jres.stats]}")
    assert err <= 1e-2
    assert ate <= _ate_bound(J)


def test_slice_with_own_basis_and_draws(seq, runs):
    _, _, jres, _ = runs
    res = tmono.run_mono_sequence([f[0] for f in seq.frames], seq.P1[:, :3],
                                  from_jax_config(mono_config()), seed=0,
                                  device="cpu")
    np.testing.assert_array_equal(res.frame_ok, jres.frame_ok)
    J = ate_rmse(jres.poses, seq.gt_poses, align="sim3")
    ate = ate_rmse(res.poses, seq.gt_poses, align="sim3")
    print(f"own draws and basis: Sim(3) ATE {ate} m, JAX {J} m")
    assert ate <= _ate_bound(J)


def test_step_from_jax_state(seq, runs):
    """Frame 4 stepped from the JAX package's state after frame 3."""
    states, outs, _, _ = runs
    cfg = mono_config()
    step = tmono.build_mono_step(seq.P1[:, :3], from_jax_config(cfg),
                                 null_basis=jax_null_basis)
    state = tmono.mono_state_from_jax(states[3])
    _, out = step(state, torch.tensor(seq.frames[4][0]), _draws(cfg)(4))
    want = outs[4]
    assert bool(out.ok) == bool(want.ok)
    assert int(out.num_matches) == int(want.num_matches)
    assert int(out.span) == int(want.span) == 1
    for k, tol in (("num_inliers", 0.03), ("scale_support", 0.02)):
        a, b = int(getattr(out, k)), int(getattr(want, k))
        assert abs(a - b) <= tol * b, (k, a, b)
    err = float(np.abs(out.transform.numpy()
                       - np.asarray(want.transform)).max())
    rel = abs(float(out.scale_ratio) / float(want.scale_ratio) - 1.0)
    print(f"step 4: transform max difference {err}, scale ratio relative "
          f"{rel}")
    assert err <= 1e-2 and rel <= 1e-2


def test_cuda_device_without_a_card_raises(seq, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tmono.run_mono_sequence([f[0] for f in seq.frames[:2]],
                                seq.P1[:, :3])
