"""The leading batch axis of ``gauss_newton`` and ``ransac_pose``.

A stack of S problems solved as one call equals the S unbatched calls:
every discrete field exactly and ``tr`` within 1e-6 (on the CPU the
batched matrix products may sum in another order than the single ones).
The batch is also held against ``jax.vmap(ransac_pose)`` fed the same
draws: discrete fields equal, ``tr`` within 1e-4 (float32 normal equations
summed in different orders by the two frameworks, as in
tests/test_torch_solvers.py).
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libviso_tpu.config import Calib as JCalib
from libviso_tpu.config import RansacConfig as JRansacConfig
from libviso_torch.config import Calib, from_jax_config
from libviso_torch.solvers import gauss_newton as tgn
from libviso_torch.solvers import ransac as transac
from tests.torch_parity import jax_frame_gumbel, to_np, to_torch

jgn = importlib.import_module("libviso_tpu.solvers.gauss_newton")
jransac = importlib.import_module("libviso_tpu.solvers.ransac")

# one calibration per row, as serving has one per stream
JCALIBS = [JCalib(f=718.856, cu=607.1928, cv=185.2157, base=0.5371657),
           JCalib(f=707.0912, cu=601.8873, cv=183.1104, base=0.5379045),
           JCalib(f=721.5377, cu=609.5593, cv=172.854, base=0.5327119),
           JCalib(f=718.856, cu=607.1928, cv=185.2157, base=0.5371657)]
CALIBS = [from_jax_config(c) for c in JCALIBS]
TRUE_TRS = np.array([[0.01, -0.02, 0.005, 0.1, -0.05, -0.8],
                     [0.0, 0.03, 0.0, -0.2, 0.02, -1.2],
                     [-0.02, 0.0, 0.01, 0.0, 0.0, -0.3],
                     [0.0, 0.0, 0.0, 0.0, 0.0, -0.5]], np.float32)
N = 200


def _problem(rng, row, n=N, outliers=0.25, noise=0.3):
    X = np.stack([rng.uniform(-20, 20, n), rng.uniform(-3, 2, n),
                  rng.uniform(5, 60, n)], -1).astype(np.float32)
    pred, _ = jgn.stereo_predict(jnp.asarray(TRUE_TRS[row]), jnp.asarray(X),
                                 JCALIBS[row])
    obs = np.asarray(pred) + rng.normal(scale=noise, size=(n, 4))
    obs[:, 3] = obs[:, 1]
    bad = rng.random(n) < outliers
    obs[bad] += rng.uniform(-40, 40, size=(bad.sum(), 4))
    valid = rng.random(n) > 0.1
    return X, obs.astype(np.float32), valid


def _stacked_calib(rows):
    """One Calib of (S,) tensors: the layout of config.Calib."""
    return Calib(*(torch.tensor([getattr(CALIBS[r], k) for r in rows])
                   for k in ("f", "cu", "cv", "base")))


@pytest.fixture(scope="module")
def problems():
    rng = np.random.default_rng(11)
    probs = [_problem(rng, r) for r in range(4)]
    # row 3 has no valid correspondence at all
    probs[3] = (probs[3][0], probs[3][1], np.zeros(N, bool))
    return probs


def _draws(cfg, rows):
    return torch.stack([jax_frame_gumbel(40 + r, 2, cfg.num_hypotheses, N)
                        for r in rows])


def _assert_rows_equal(batch, singles):
    for i, one in enumerate(singles):
        assert bool(batch.ok[i]) == bool(one.ok)
        assert int(batch.best_hypothesis[i]) == int(one.best_hypothesis)
        assert int(batch.num_inliers[i]) == int(one.num_inliers)
        assert torch.equal(batch.inliers[i], one.inliers)
        np.testing.assert_allclose(to_np(batch.tr[i]), to_np(one.tr),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(float(batch.rms[i]), float(one.rms),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("method", ["procrustes", "gn"])
@pytest.mark.parametrize("unroll", [1, 2, 4])
def test_ransac_batch_equals_unbatched_calls(problems, method, unroll):
    """Per-row calibrations, a row without a valid point, rows that
    converge at different iterations; for every gn_unroll."""
    cfg = from_jax_config(JRansacConfig(hypothesis_method=method,
                                        gn_unroll=unroll))
    rows = [0, 1, 2, 3]
    g = _draws(cfg, rows)
    X, obs, valid = (to_torch(np.stack(x)) for x in zip(*problems))
    batch = transac.ransac_pose(X, obs, valid, _stacked_calib(rows), cfg,
                                gumbel=g)
    singles = [transac.ransac_pose(X[i], obs[i], valid[i], CALIBS[r], cfg,
                                   gumbel=g[i]) for i, r in enumerate(rows)]
    assert batch.tr.shape == (4, 6) and batch.inliers.shape == (4, N)
    _assert_rows_equal(batch, singles)
    assert [bool(o) for o in batch.ok] == [True, True, True, False]
    np.testing.assert_allclose(to_np(batch.tr[:3]), TRUE_TRS[:3], atol=0.02)


def test_a_row_does_not_depend_on_its_batch(problems):
    """Row 1 solved with rows {0, 1}, {1, 3} and {3, 2, 1, 0} is bitwise
    the same lane every time the products are: held to 1e-6."""
    cfg = from_jax_config(JRansacConfig())
    results = []
    for rows in ([0, 1], [1, 3], [3, 2, 1, 0]):
        X, obs, valid = (to_torch(np.stack([problems[r][k] for r in rows]))
                         for k in range(3))
        res = transac.ransac_pose(X, obs, valid, _stacked_calib(rows), cfg,
                                  gumbel=_draws(cfg, rows))
        i = rows.index(1)
        results.append(type(res)(*(x[i] for x in res)))
    _assert_rows_equal(type(results[0])(*(torch.stack(xs) for xs in
                                          zip(*results[1:]))),
                       [results[0], results[0]])


@pytest.mark.parametrize("method", ["procrustes", "gn"])
def test_ransac_batch_equals_jax_vmap(problems, method):
    jcfg = JRansacConfig(hypothesis_method=method)
    cfg = from_jax_config(jcfg)
    rows = [0, 1, 2]
    calib4 = jnp.asarray([[c.f, c.cu, c.cv, c.base]
                          for c in JCALIBS[:3]], jnp.float32)
    keys = jnp.stack([jax.random.PRNGKey(7 + r) for r in rows])
    X, obs, valid = (np.stack(x) for x in zip(*problems[:3]))

    def one(key, c4, X, obs, valid):
        return jransac.ransac_pose(
            key, X, obs, valid,
            JCalib(f=c4[0], cu=c4[1], cv=c4[2], base=c4[3]), jcfg)

    want = jax.vmap(one)(keys, calib4, jnp.asarray(X), jnp.asarray(obs),
                         jnp.asarray(valid))
    g = torch.stack([to_torch(jax.random.gumbel(
        k, (cfg.num_hypotheses, N), jnp.float32)) for k in keys])
    got = transac.ransac_pose(to_torch(X), to_torch(obs), to_torch(valid),
                              _stacked_calib(rows), cfg, gumbel=g)
    np.testing.assert_array_equal(to_np(got.ok), np.asarray(want.ok))
    np.testing.assert_array_equal(to_np(got.best_hypothesis),
                                  np.asarray(want.best_hypothesis))
    np.testing.assert_array_equal(to_np(got.inliers),
                                  np.asarray(want.inliers))
    np.testing.assert_array_equal(to_np(got.num_inliers),
                                  np.asarray(want.num_inliers))
    np.testing.assert_allclose(to_np(got.tr), np.asarray(want.tr),
                               atol=1e-4)
    np.testing.assert_allclose(to_np(got.rms), np.asarray(want.rms),
                               rtol=1e-4)


@pytest.mark.parametrize("unroll", [1, 2, 4])
def test_gauss_newton_batch_of_stacks(problems, unroll):
    """(S, H) lanes with (S,) calibrations equal the S calls on (H,) lanes
    with float calibrations, whatever gn_unroll; the lanes stop at
    different iterations."""
    rng = np.random.default_rng(5)
    cfg = from_jax_config(JRansacConfig(gn_iters=30, gn_unroll=unroll))
    idx = rng.integers(0, N, size=(3, 8, 3))
    Xs = np.stack([problems[r][0][idx[r]] for r in range(3)])
    obs = np.stack([problems[r][1][idx[r]] for r in range(3)])
    w = torch.ones(3, 8, 3)
    tr0 = torch.zeros(3, 8, 6)
    batch = tgn.gauss_newton(to_torch(Xs), to_torch(obs), w, tr0,
                             _stacked_calib([0, 1, 2]), cfg)
    assert batch.tr.shape == (3, 8, 6)
    assert len(set(batch.iters.flatten().tolist())) > 1
    for r in range(3):
        one = tgn.gauss_newton(to_torch(Xs[r]), to_torch(obs[r]), w[r],
                               tr0[r], CALIBS[r].on("cpu"), cfg)
        assert torch.equal(batch.converged[r], one.converged)
        assert torch.equal(batch.iters[r], one.iters)
        ok = one.converged
        np.testing.assert_allclose(to_np(batch.tr[r][ok]), to_np(one.tr[ok]),
                                   rtol=0, atol=1e-6)


def test_best_hypothesis_is_the_lowest_index_among_tied_supports():
    """Duplicated draws give hypotheses with equal supports: the lowest
    index wins, as JAX's argmax."""
    rng = np.random.default_rng(3)
    X, obs, valid = _problem(rng, 0, outliers=0.0, noise=0.0)
    jcfg = JRansacConfig(num_hypotheses=8)
    cfg = from_jax_config(jcfg)
    g = jax_frame_gumbel(1, 1, 4, N)
    g = torch.cat([g, g])                  # hypotheses 4..7 repeat 0..3
    res = transac.ransac_pose(to_torch(X), to_torch(obs), to_torch(valid),
                              CALIBS[0], cfg, gumbel=g)
    both = transac.ransac_pose(
        to_torch(np.stack([X, X])), to_torch(np.stack([obs, obs])),
        to_torch(np.stack([valid, valid])), _stacked_calib([0, 0]), cfg,
        gumbel=torch.stack([g, g.flip(0)]))
    assert int(res.best_hypothesis) < 4
    assert int(both.best_hypothesis[0]) == int(res.best_hypothesis)
    assert int(both.best_hypothesis[1]) < 4
    assert bool(res.ok)


def test_calib_layout_helpers():
    c = _stacked_calib([0, 1])
    padded = c.against(3)
    assert padded.f.shape == (2, 1, 1) and CALIBS[0].against(3) == CALIBS[0]
    on = CALIBS[0].on("cpu")
    assert on.f.shape == () and on.f.dtype == torch.float32
    assert CALIBS[0].on("cpu") is on            # made once
    assert float(on.base) == np.float32(CALIBS[0].base)
    assert dataclasses.is_dataclass(on)
