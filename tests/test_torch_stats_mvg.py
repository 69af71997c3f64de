"""The mono slice's small helpers in libviso_torch against libviso_tpu:
masked robust statistics, top-k with lax.top_k's ties, the lowest-index
argmax, the projective-geometry leftovers, DLT triangulation and the
mono configuration's validation.

Tolerances: the statistics, top-k and argmax pick existing values, so they
are exact; the geometry is float32 arithmetic in another order (products
of 3- and 4-vectors, 4x4 determinants), held to 1e-5 relative of the
values' scale.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libviso_tpu import config as jconfig
from libviso_tpu.geometry import mvg as jmvg
from libviso_tpu.geometry import triangulate as jtri
from libviso_tpu.utils import stats as jstats
from libviso_torch import config as tconfig
from libviso_torch.geometry import mvg as tmvg
from libviso_torch.geometry import triangulate as ttri
from libviso_torch.ops.topk import first_argmax, topk_sorted
from libviso_torch.utils import stats as tstats
from tests.torch_parity import to_np, to_torch


@pytest.mark.parametrize("q", [0.0, 0.25, 0.5, 0.9, 1.0])
@pytest.mark.parametrize("n_valid", [0, 1, 2, 7, 64])
def test_masked_quantile_equals_jax(q, n_valid):
    rng = np.random.default_rng(n_valid)
    x = rng.normal(size=64).astype(np.float32)
    x[5] = np.inf                       # non-finite values sort last
    valid = np.zeros(64, bool)
    valid[rng.permutation(64)[:n_valid]] = True
    got = to_np(tstats.masked_quantile(to_torch(x), to_torch(valid), q))
    want = np.asarray(jstats.masked_quantile(jnp.asarray(x),
                                             jnp.asarray(valid), q))
    np.testing.assert_array_equal(got, want)
    if n_valid == 0:
        assert got == np.inf


def test_masked_median_abs_equals_jax_batched_rows():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(5, 40)).astype(np.float32)
    valid = rng.random((5, 40)) < 0.6
    got = to_np(tstats.masked_median_abs(to_torch(x), to_torch(valid)))
    want = np.stack([np.asarray(jstats.masked_median_abs(
        jnp.asarray(x[i]), jnp.asarray(valid[i]))) for i in range(5)])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        to_np(tstats.masked_median(to_torch(x[0]), to_torch(valid[0]))),
        np.asarray(jstats.masked_median(jnp.asarray(x[0]),
                                        jnp.asarray(valid[0]))))


@pytest.mark.parametrize("k", [1, 4, 10])
def test_topk_sorted_equals_lax_top_k_on_ties(k):
    """Rows of ties, -inf ties included (real_roots_deg10's score rows):
    values and indices exactly lax.top_k's."""
    rng = np.random.default_rng(k)
    x = rng.integers(-3, 3, (6, 31)).astype(np.float32)
    x[rng.random((6, 31)) < 0.5] = -np.inf
    x[0] = -np.inf
    vals, idx = topk_sorted(to_torch(x), k)
    jv, ji = jax.lax.top_k(jnp.asarray(x), k)
    np.testing.assert_array_equal(to_np(vals), np.asarray(jv))
    np.testing.assert_array_equal(to_np(idx), np.asarray(ji))


def test_first_argmax_takes_lowest_index():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0], [5.0, 5.0, 5.0, 5.0]])
    assert first_argmax(x).tolist() == [1, 0]
    assert first_argmax(x, dim=0).tolist() == [1, 1, 1, 1]
    rng = np.random.default_rng(0)
    y = rng.integers(0, 3, (20, 9)).astype(np.float32)
    np.testing.assert_array_equal(to_np(first_argmax(to_torch(y))),
                                  np.asarray(jnp.argmax(jnp.asarray(y), -1)))


def _cameras(rng):
    K = np.array([[700.0, 0.2, 600], [0, 690, 180], [0, 0, 1]], np.float32)
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    R = (R * np.sign(np.linalg.det(R))).astype(np.float32)
    t = rng.normal(size=3).astype(np.float32)
    return K, R, t


def _close(got, want, rel=1e-5):
    got, want = to_np(got), np.asarray(want)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    print(f"max relative error {err}")
    assert err <= rel, err


def test_projection_helpers_equal_jax():
    rng = np.random.default_rng(1)
    K, R, t = _cameras(rng)
    P = tmvg.P_from_KRt(to_torch(K), to_torch(R), to_torch(t))
    jP = jmvg.P_from_KRt(jnp.asarray(K), jnp.asarray(R), jnp.asarray(t))
    _close(P, jP)
    X = rng.uniform([-5, -2, 4], [5, 2, 30], (50, 3)).astype(np.float32)
    _close(tmvg.project(P, to_torch(X)), jmvg.project(jP, jnp.asarray(X)))
    X2 = rng.normal(size=(4, 7, 3)).astype(np.float32)
    X1 = X2 + rng.normal(size=(4, 7, 3)).astype(np.float32) * 0.1
    _close(tmvg.rms(to_torch(X1), to_torch(X2)),
           jmvg.rms(jnp.asarray(X1), jnp.asarray(X2)))


def test_fundamental_and_algebraic_distance_equal_jax():
    rng = np.random.default_rng(2)
    K, R, t = _cameras(rng)
    P1 = np.concatenate([K, np.zeros((3, 1), np.float32)], 1) / 100.0
    P2 = (K @ np.concatenate([R, t[:, None]], 1)).astype(np.float32) / 100.0
    F = tmvg.F_from_P(to_torch(P1), to_torch(P2))
    jF = jmvg.F_from_P(jnp.asarray(P1), jnp.asarray(P2))
    _close(F, jF, rel=1e-4)
    # batched cameras
    Fb = tmvg.F_from_P(to_torch(np.stack([P1, P1])),
                       to_torch(np.stack([P2, P1])))
    _close(Fb[0], jF, rel=1e-4)
    x1 = rng.uniform(0, 600, (30, 2)).astype(np.float32)
    x2 = rng.uniform(0, 600, (30, 2)).astype(np.float32)
    Fh = np.asarray(jF)
    _close(tmvg.algebraic_distance(to_torch(Fh), to_torch(x1), to_torch(x2)),
           jmvg.algebraic_distance(jnp.asarray(Fh), jnp.asarray(x1),
                                   jnp.asarray(x2)))


def test_triangulate_dlt_equals_jax():
    rng = np.random.default_rng(4)
    K, R, t = _cameras(rng)
    P1 = np.concatenate([K, np.zeros((3, 1), np.float32)], 1)
    P2 = (K @ np.concatenate([R, t[:, None]], 1)).astype(np.float32)
    X = rng.uniform([-3, -2, 5], [3, 2, 20], (40, 3))
    X = X[(X @ R.T + t)[:, 2] > 1].astype(np.float32)   # in front of both
    x1 = np.asarray(jmvg.project(jnp.asarray(P1), jnp.asarray(X)))
    x2 = np.asarray(jmvg.project(jnp.asarray(P2), jnp.asarray(X)))
    got = ttri.triangulate_dlt(to_torch(x1), to_torch(x2), to_torch(P1),
                               to_torch(P2))
    want = jtri.triangulate_dlt(jnp.asarray(x1), jnp.asarray(x2),
                                jnp.asarray(P1), jnp.asarray(P2))
    _close(got, want, rel=1e-3)
    _close(got, X, rel=1e-3)


@pytest.mark.parametrize("kw", [
    dict(method="7pt"), dict(first_pass="5pt"), dict(scoring="lo"),
    dict(scale_estimator="mean")])
def test_mono_config_validation_equals_jax(kw):
    if "scoring" not in kw:   # the JAX class does not validate scoring
        with pytest.raises(ValueError):
            jconfig.MonoConfig(**kw)
    with pytest.raises(ValueError):
        tconfig.MonoConfig(**kw)


@pytest.mark.parametrize("kw", [dict(), dict(method="8pt"),
                                dict(num_hypotheses=32),
                                dict(method="8pt", num_hypotheses=5)])
def test_mono_config_hypotheses_equal_jax(kw):
    jc = jconfig.MonoConfig(**kw)
    tc = tconfig.from_jax_config(jc)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.resolved_hypotheses() == jc.resolved_hypotheses()
