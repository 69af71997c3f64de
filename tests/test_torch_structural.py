"""The structural place-recognition primitives of libviso_torch against
libviso_tpu.

``ops/structural.py`` on the clouds of ``tests/test_structural.py``: the
k-NN distance descriptors with the same usable mask, within 1e-4 (the
squared distances come from |a|^2 + |b|^2 - 2ab with |a|^2 about 100, so
the matmul's rounding, which differs between the two packages, reaches
1e-5 of the squared distance: measured 2.1e-5 on distances of about 1), the
store matcher's indices, masks and scores equal, and the ICP refiner's
pairs equal with its transform within 1e-4, from the same seed pose (a
180 degree yaw with 90 % overlap and 5 cm noise).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from libviso_tpu.ops import structural as js
from libviso_torch.ops import structural as ts
from tests.test_structural import _cloud, _rigid
from tests.torch_parity import to_np, to_torch


@pytest.fixture(scope="module")
def scene():
    """tests/test_structural.py's 180 degree revisit: the old and new
    clouds, and a store of 4 keyframes whose slot 2 is the revisit."""
    rng = np.random.default_rng(2)
    B, n_shared, n_own = 256, 230, 26
    shared = _cloud(rng, n_shared, span=8.0)
    T_true = _rigid(180.0, [0.0, 0.0, 16.0])
    X_old = np.concatenate([shared, _cloud(rng, n_own, span=8.0)])
    X_new = np.concatenate([shared @ T_true[:3, :3].T + T_true[:3, 3]
                            + rng.normal(0, 0.05, (n_shared, 3)),
                            _cloud(rng, n_own, span=8.0)]).astype(np.float32)
    X_new = X_new[rng.permutation(B)]
    valid = np.ones(B, bool)
    valid[-9:] = False                   # a few padded slots
    store = [_cloud(np.random.default_rng(10 + i), B, span=8.0)
             for i in range(4)]
    store[2] = X_old
    return dict(X_old=X_old, X_new=X_new, valid=valid, store=store,
                T_true=T_true)


@pytest.mark.parametrize("k,max_depth", [(8, 1e9), (12, 15.0), (4, 50.0)])
def test_knn_descriptors_match_jax(scene, k, max_depth):
    for X in (scene["X_old"], scene["X_new"]):
        dj, uj = js.knn_distance_descriptors(
            jnp.asarray(X), jnp.asarray(scene["valid"]), k=k,
            max_depth=max_depth)
        dt, ut = ts.knn_distance_descriptors(
            to_torch(X), to_torch(scene["valid"]), k=k, max_depth=max_depth)
        np.testing.assert_array_equal(to_np(ut), np.asarray(uj))
        np.testing.assert_allclose(to_np(dt), np.asarray(dj), atol=1e-4)


def _descriptors(X, valid, k=8):
    d, u = js.knn_distance_descriptors(jnp.asarray(X), jnp.asarray(valid),
                                       k=k, max_depth=1e9)
    return np.asarray(d), np.asarray(u)


@pytest.mark.parametrize("ratio", [0.85, 0.95])
def test_structural_matcher_matches_jax(scene, ratio):
    """The same descriptors through both matchers: idx, validity and
    scores equal."""
    B, k = 256, 8
    q, qu = _descriptors(scene["X_new"], scene["valid"])
    kf = [_descriptors(X, scene["valid"]) for X in scene["store"]]
    kd, ku = np.stack([d for d, _ in kf]), np.stack([u for _, u in kf])
    want = js.build_structural_matcher(4, B, k, ratio)(
        jnp.asarray(q), jnp.asarray(qu), jnp.asarray(kd), jnp.asarray(ku))
    got = ts.build_structural_matcher(4, B, k, ratio)(
        to_torch(q), to_torch(qu), to_torch(kd), to_torch(ku))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_np(g), np.asarray(w))
    assert int(got[2][2]) >= 20          # the revisit is a candidate


@pytest.mark.parametrize("case", ["seeded", "collapse"])
def test_icp_refiner_matches_jax(scene, case):
    if case == "seeded":
        # a seed 2 degrees and 0.2 m off the true pose
        T0 = _rigid(182.0, [0.1, 0.0, 16.15])
        radius, iters = 0.4, 3
    else:
        T0 = _rigid(90.0, [500.0, 0.0, 0.0])
        radius, iters = 0.2, 2
    args = (scene["X_old"], scene["valid"], scene["X_new"], scene["valid"])
    want = js.build_icp_refiner(radius, iters)(
        jnp.asarray(T0), *map(jnp.asarray, args))
    got = ts.build_icp_refiner(radius, iters)(to_torch(T0),
                                              *map(to_torch, args))
    np.testing.assert_allclose(to_np(got[0]), np.asarray(want[0]),
                               atol=1e-4)
    ok = np.asarray(want[2])
    np.testing.assert_array_equal(to_np(got[2]), ok)
    np.testing.assert_array_equal(to_np(got[1])[ok], np.asarray(want[1])[ok])
    assert int(got[3]) == int(want[3])
    if case == "seeded":
        assert int(got[3]) >= 100
    else:
        assert int(got[3]) == 0
        np.testing.assert_allclose(to_np(got[0]), T0, atol=1e-5)
