"""The 3D-3D solvers of libviso_torch against libviso_tpu.

``geometry/procrustes.py``: the Kabsch and Umeyama solves on unit-scale
clouds (transforms within 1e-5), weighted and batched, and both RANSACs
with the JAX package's Gumbel draws injected (the same inlier masks and
counts, transforms within 1e-4).  The clouds are those of
``tests/test_procrustes.py`` and ``tests/test_sim3.py``, scaled to unit
size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from libviso_tpu.geometry import procrustes as jp
from libviso_tpu.geometry.se3 import pose_vector_to_matrix
from libviso_torch.geometry import procrustes as tp
from tests.torch_parity import jax_key_gumbel, to_np, to_torch


def _cloud_pair(seed, n=60, scale=1.0, noise=0.0, batch=()):
    """B ~ N(0, 1) clouds and A = s R B + t, float32."""
    rng = np.random.default_rng(seed)
    tr = rng.uniform(-0.3, 0.3, batch + (6,))
    T = np.asarray(pose_vector_to_matrix(jnp.asarray(tr, jnp.float32)))
    B = rng.normal(size=batch + (n, 3)).astype(np.float32)
    A = scale * B @ np.swapaxes(T[..., :3, :3], -1, -2) + T[..., None, :3, 3]
    A = (A + noise * rng.normal(size=A.shape)).astype(np.float32)
    return A, B


@pytest.mark.parametrize("solver", ["solve_rigid_motion",
                                    "solve_similarity"])
@pytest.mark.parametrize("case", ["plain", "weighted", "batched"])
def test_solvers_match_jax(solver, case):
    scale = 1.0 if solver == "solve_rigid_motion" else 0.8
    batch = (5,) if case == "batched" else ()
    A, B = _cloud_pair(1, scale=scale, batch=batch,
                       noise=0.0 if case == "plain" else 0.01)
    w = None
    if case == "weighted":
        w = np.random.default_rng(2).uniform(0, 1, A.shape[:-1])
        w[:10] = 0.0
        w = w.astype(np.float32)
    want = getattr(jp, solver)(jnp.asarray(A), jnp.asarray(B),
                               None if w is None else jnp.asarray(w))
    got = getattr(tp, solver)(to_torch(A), to_torch(B),
                              None if w is None else to_torch(w))
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-5)


def test_similarity_recovers_the_scale():
    A, B = _cloud_pair(3, scale=1.37)
    from libviso_torch.geometry.sim3 import sim3_scale

    assert abs(float(sim3_scale(tp.solve_similarity(to_torch(A),
                                                    to_torch(B)))) - 1.37) \
        < 1e-5


@pytest.mark.parametrize("name", ["ransac_rigid_motion",
                                  "ransac_similarity"])
@pytest.mark.parametrize("seed", [0, 1])
def test_ransacs_match_jax_on_the_same_draws(name, seed):
    """30 % outliers and 16 padded slots; JAX's draws injected."""
    n = 100
    A, B = _cloud_pair(10 + seed, n=n, noise=0.005,
                       scale=1.0 if name == "ransac_rigid_motion" else 1.2)
    rng = np.random.default_rng(20 + seed)
    out = rng.uniform(size=n) < 0.3
    A[out] += rng.normal(size=(out.sum(), 3)).astype(np.float32) * 3.0
    valid = np.arange(n) < n - 16
    A[~valid] = 1e6
    key = jax.random.PRNGKey(seed)
    H = 64
    T_j, m_j, n_j = getattr(jp, name)(key, jnp.asarray(A), jnp.asarray(B),
                                      valid=jnp.asarray(valid),
                                      num_hypotheses=H, inlier_thresh=0.05)
    T_t, m_t, n_t = getattr(tp, name)(
        to_torch(A), to_torch(B), valid=to_torch(valid), num_hypotheses=H,
        inlier_thresh=0.05, gumbel=jax_key_gumbel(key, (H, n)))
    np.testing.assert_array_equal(to_np(m_t), np.asarray(m_j))
    assert int(n_t) == int(n_j) > 40
    np.testing.assert_allclose(to_np(T_t), np.asarray(T_j), atol=1e-4)
    assert not to_np(m_t)[~valid].any()


def test_ransac_draws_from_a_generator():
    import torch

    A, B = _cloud_pair(7, n=50)
    T, mask, count = tp.ransac_rigid_motion(
        to_torch(A), to_torch(B), num_hypotheses=16,
        generator=torch.Generator().manual_seed(0))
    assert int(count) == 50 and bool(mask.all())
    with pytest.raises(ValueError, match="gumbel or a generator"):
        tp.ransac_similarity(to_torch(A), to_torch(B))
