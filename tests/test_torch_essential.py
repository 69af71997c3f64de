"""Two-view geometry of the mono slice in libviso_torch against
libviso_tpu: normalization, the 8-point solver, decomposition, depths,
pose recovery, the batched RANSAC (both solvers, both scorings) and the
refiners.

Inputs are made with numpy from seeds (``tests/test_essential.py``'s
``make_mono_problem``); RANSAC gets JAX's Gumbel draws and, for the
5-point solver, JAX's null-space basis (``tests/torch_parity.py``).
Tolerances, each printed with the measured value: coordinates and
distances 1e-5 relative (the signed residual, which cancels terms of order
1, 1e-6 absolute); E up to sign, R and t within 1e-4; masks equal;
the refiners' R and t within 1e-4, a scale within 1e-4 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libviso_tpu.geometry import essential as je
from libviso_tpu.geometry.mvg import sampson_distance as jsampson
from libviso_torch.geometry import essential as te
from tests.test_essential import make_mono_problem
from tests.torch_parity import jax_null_basis, to_np, to_torch


def _err(got, want):
    return float(np.abs(to_np(got) - np.asarray(want)).max())


def _sign_err(got, want):
    got, want = to_np(got), np.asarray(want)
    return min(np.abs(got - want).max(), np.abs(got + want).max())


def _problem(seed, n=120, noise=1e-4, outliers=0.25):
    rng = np.random.default_rng(seed)
    x1, x2, R, t = make_mono_problem(rng, n=n, noise=noise)
    x1, x2 = np.asarray(x1, np.float32), np.asarray(x2, np.float32)
    bad = rng.random(n) < outliers
    x2 = np.where(bad[:, None], x2 + rng.normal(size=x2.shape) * 0.2,
                  x2).astype(np.float32)
    return x1, x2, np.asarray(R, np.float32), np.asarray(t, np.float32), bad


def test_normalize_and_undistort_equal_jax():
    rng = np.random.default_rng(0)
    K = np.array([[700.0, 0.3, 600], [0, 690, 180], [0, 0, 1]], np.float32)
    D = np.array([-0.3, 0.1, 1e-3, -5e-4], np.float32)
    x = rng.uniform(0, [1200, 370], (200, 2)).astype(np.float32)
    got = te.normalize_points(to_torch(x), to_torch(K))
    want = je.normalize_points(jnp.asarray(x), jnp.asarray(K))
    print("normalize", _err(got, want))
    assert _err(got, want) <= 1e-6
    got = te.undistort_points(to_torch(x), to_torch(K), to_torch(D))
    want = je.undistort_points(jnp.asarray(x), jnp.asarray(K),
                               jnp.asarray(D))
    print("undistort", _err(got, want))
    assert _err(got, want) <= 1e-5
    np.testing.assert_array_equal(
        to_np(te.undistort_points(to_torch(x), to_torch(K), None)),
        to_np(te.normalize_points(to_torch(x), to_torch(K))))


def test_eight_point_and_sampson_equal_jax():
    x1, x2, R, t, _ = _problem(1, outliers=0.0)
    E = te.eight_point_E(to_torch(x1), to_torch(x2))
    jE = je.eight_point_E(jnp.asarray(x1), jnp.asarray(x2))
    print("eight_point_E up to sign", _sign_err(E, jE))
    assert _sign_err(E, jE) <= 1e-4
    # a batch of minimal 8-point samples: a minimal system's null vector is
    # ill-conditioned in float32 (1e-4 apart between the packages on this
    # batch), so both are held to the float64 solution, within 5e-4
    idx = np.argsort(np.random.default_rng(2).random((16, len(x1))),
                     -1)[:, :8]    # distinct points: a 1-dim null space
    Eb = te.eight_point_E(to_torch(x1[idx]), to_torch(x2[idx]))
    jEb = np.asarray(je.eight_point_E(jnp.asarray(x1[idx]),
                                      jnp.asarray(x2[idx])))
    E64 = to_np(te.eight_point_E(to_torch(x1[idx]).double(),
                                 to_torch(x2[idx]).double()))
    errs = [(_sign_err(Eb[i], E64[i]), _sign_err(jEb[i], E64[i]))
            for i in range(16)]
    print("batched eight_point_E from float64, port / JAX", errs)
    assert max(max(e) for e in errs) <= 5e-4
    w = np.random.default_rng(3).random(len(x1)).astype(np.float32)
    Ew = te.eight_point_E(to_torch(x1), to_torch(x2), to_torch(w))
    jEw = je.eight_point_E(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(w))
    assert _sign_err(Ew, jEw) <= 1e-4
    # Sampson distance and signed residual under a noisy E, (M, N) broadcast
    Ej = np.asarray(jEb)
    s = te.sampson_distance(to_torch(Ej)[:, None], to_torch(x1)[None],
                            to_torch(x2)[None])
    js = jsampson(jnp.asarray(Ej)[:, None], jnp.asarray(x1)[None],
                  jnp.asarray(x2)[None])
    rel = _err(s, js) / float(np.abs(np.asarray(js)).max())
    print("sampson relative", rel)
    assert rel <= 1e-5
    r = te._sampson_residual(to_torch(Ej[0]), to_torch(x1), to_torch(x2))
    jr = je._sampson_residual(jnp.asarray(Ej[0]), jnp.asarray(x1),
                              jnp.asarray(x2))
    # x2' E x1 cancels terms of order 1: float32 rounding of those terms
    print("signed residual", _err(r, jr))
    assert _err(r, jr) <= 1e-6


def test_decompose_depths_and_recover_pose_equal_jax():
    x1, x2, R, t, _ = _problem(4, outliers=0.0, noise=0.0)
    jE = np.asarray(je.eight_point_E(jnp.asarray(x1), jnp.asarray(x2)))
    Rs, ts = te.decompose_E(to_torch(jE))
    jRs, jts = map(np.asarray, je.decompose_E(jnp.asarray(jE)))
    # the same four candidates (the SVD's signs may order them otherwise)
    for k in range(4):
        d = min(max(np.abs(to_np(Rs[i]) - jRs[k]).max(),
                    np.abs(to_np(ts[i]) - jts[k]).max()) for i in range(4))
        assert d <= 1e-4, (k, d)
    z1, z2 = te.two_view_depths(to_torch(R), to_torch(t), to_torch(x1),
                                to_torch(x2))
    jz1, jz2 = je.two_view_depths(jnp.asarray(R), jnp.asarray(t),
                                  jnp.asarray(x1), jnp.asarray(x2))
    assert _err(z1, jz1) <= 1e-5 * float(np.abs(np.asarray(jz1)).max())
    assert _err(z2, jz2) <= 1e-5 * float(np.abs(np.asarray(jz2)).max())
    valid = np.arange(len(x1)) % 7 != 0
    got = te.recover_pose(to_torch(jE), to_torch(x1), to_torch(x2),
                          to_torch(valid))
    want = je.recover_pose(jnp.asarray(jE), jnp.asarray(x1), jnp.asarray(x2),
                           jnp.asarray(valid))
    print("recover_pose R, t", _err(got[0], want[0]), _err(got[1], want[1]))
    assert _err(got[0], want[0]) <= 1e-4 and _err(got[1], want[1]) <= 1e-4
    np.testing.assert_array_equal(to_np(got[2]), np.asarray(want[2]))
    assert int(got[3]) == int(want[3])


@pytest.mark.parametrize("method", ["8pt", "5pt"])
@pytest.mark.parametrize("scoring,soft", [("msac", False), ("magsac", True)])
def test_ransac_essential_equals_jax(method, scoring, soft):
    """Injected draws (and basis for 5pt): equal inlier masks, counts and
    ok flags; E up to sign within 1e-4."""
    x1, x2, R, t, bad = _problem(5)
    N = len(x1)
    valid = np.arange(N) < N - 6      # padded tail slots
    H = 64 if method == "5pt" else 128
    key = jax.random.PRNGKey(7)
    gumbel = jax.random.gumbel(key, (H, N), jnp.float32)
    kw = dict(num_hypotheses=H, sampson_thresh=2e-6, method=method,
              scoring=scoring, soft_refit=soft)
    want = je.ransac_essential(key, jnp.asarray(x1), jnp.asarray(x2),
                               valid=jnp.asarray(valid), **kw)
    got = te.ransac_essential(to_torch(x1), to_torch(x2),
                              valid=to_torch(valid), gumbel=to_torch(gumbel),
                              null_basis=jax_null_basis, **kw)
    print(f"E up to sign {_sign_err(got.E, want.E)}, inliers "
          f"{int(got.num_inliers)} / {int(want.num_inliers)}")
    np.testing.assert_array_equal(to_np(got.inliers),
                                  np.asarray(want.inliers))
    assert int(got.num_inliers) == int(want.num_inliers)
    assert bool(got.ok) == bool(want.ok) is True
    assert _sign_err(got.E, want.E) <= 1e-4
    assert not to_np(got.inliers)[~valid].any()
    assert to_np(got.inliers)[bad & valid].mean() < 0.1


def test_ransac_essential_validates_method_and_draws():
    x = torch.rand(30, 2)
    with pytest.raises(ValueError, match="unknown method"):
        te.ransac_essential(x, x, gumbel=torch.zeros(4, 30), method="7pt")
    with pytest.raises(ValueError, match="gumbel or a generator"):
        te.ransac_essential(x, x)


def _refine_inputs(seed):
    x1, x2, R, t, bad = _problem(seed, n=150, noise=3e-4, outliers=0.1)
    w = (~bad).astype(np.float32)
    # a start a little off the truth
    dR = np.asarray(je._expm_so3(jnp.asarray([0.01, -0.02, 0.015],
                                             jnp.float32)))
    R0 = (R @ dR).astype(np.float32)
    t0 = (t + np.array([0.05, -0.03, 0.02])).astype(np.float32)
    return x1, x2, R0, t0, w


def test_refine_relative_pose_equals_jax():
    x1, x2, R0, t0, w = _refine_inputs(6)
    got = te.refine_relative_pose(*map(to_torch, (R0, t0, x1, x2, w)))
    want = je.refine_relative_pose(*map(jnp.asarray, (R0, t0, x1, x2, w)))
    print("refine_relative_pose R, t", _err(got[0], want[0]),
          _err(got[1], want[1]))
    assert _err(got[0], want[0]) <= 1e-4 and _err(got[1], want[1]) <= 1e-4


def test_depth_log_grads_equal_jax():
    x1, x2, R, t, _ = _problem(8, outliers=0.0)
    g1, g2 = te.depth_log_grads(*map(to_torch, (R, t, x1, x2)))
    j1, j2 = je.depth_log_grads(*map(jnp.asarray, (R, t, x1, x2)))
    scale = max(np.abs(np.asarray(j1)).max(), np.abs(np.asarray(j2)).max())
    print("depth_log_grads relative", max(_err(g1, j1), _err(g2, j2)) / scale)
    assert max(_err(g1, j1), _err(g2, j2)) <= 1e-4 * scale


def test_pnp_refine_pose_equals_jax():
    rng = np.random.default_rng(9)
    x1, x2, R, t, _ = _problem(9, outliers=0.0, noise=2e-4)
    z1, _ = je.two_view_depths(jnp.asarray(R), jnp.asarray(t),
                               jnp.asarray(x1), jnp.asarray(x2))
    # the landmarks in camera 2, scaled by 1.3, are the previous camera's;
    # x1 observes them in the current camera: X_prev = R X_cur + 1.3 t
    X1 = np.asarray(z1)[:, None] * np.concatenate(
        [x1, np.ones_like(x1[:, :1])], 1)
    X_prev = (1.3 * ((X1 @ R.T) + t)).astype(np.float32)
    Rs, ts = R.astype(np.float32), (1.3 * t).astype(np.float32)
    w = (rng.random(len(x1)) < 0.9).astype(np.float32)
    seed_t = (ts * 0.9).astype(np.float32)
    got = te.pnp_refine_pose(*map(to_torch, (Rs, seed_t, X_prev, x1, w)))
    want = je.pnp_refine_pose(*map(jnp.asarray, (Rs, seed_t, X_prev, x1, w)))
    s_got = float(torch.linalg.vector_norm(got[1]))
    s_want = float(jnp.linalg.norm(want[1]))
    print("pnp R, t", _err(got[0], want[0]), _err(got[1], want[1]),
          "scale", s_got, s_want)
    assert _err(got[0], want[0]) <= 1e-4 and _err(got[1], want[1]) <= 1e-4
    assert abs(s_got - s_want) <= 1e-4 * s_want
    assert abs(s_want - 1.3) < 0.02


def test_three_view_bundle_equals_jax():
    """Three frames a, b, c with b the anchor: pair 1 b -> a with |t1| = 1,
    pair 2 c -> b with |t2| = 0.8 (the scale the bundle recovers)."""
    rng = np.random.default_rng(10)
    n = 160
    Xb = rng.uniform([-5, -2, 6], [5, 2, 30], (n, 3))
    R1 = np.asarray(je._expm_so3(jnp.asarray([0.01, 0.02, -0.01])),
                    np.float64)
    t1 = np.array([0.1, -0.05, 0.99])
    t1 /= np.linalg.norm(t1)
    R2 = np.asarray(je._expm_so3(jnp.asarray([-0.015, 0.01, 0.005])),
                    np.float64)
    t2 = np.array([0.05, 0.02, 1.0])
    t2 = 0.8 * t2 / np.linalg.norm(t2)
    Xa = Xb @ R1.T + t1
    Xc = (Xb - t2) @ R2               # X_b = R2 X_c + t2
    noise = lambda: rng.normal(size=(n, 2)) * 5e-4  # noqa: E731
    x_a = (Xa[:, :2] / Xa[:, 2:] + noise()).astype(np.float32)
    x_b = (Xb[:, :2] / Xb[:, 2:] + noise()).astype(np.float32)
    x_c = (Xc[:, :2] / Xc[:, 2:] + noise()).astype(np.float32)
    z0 = (Xb[:, 2] * rng.uniform(0.9, 1.1, n)).astype(np.float32)
    w = (rng.random(n) < 0.9).astype(np.float32)
    R1f, R2f = R1.astype(np.float32), R2.astype(np.float32)
    t1s = (t1 + [0.02, 0.0, -0.01]).astype(np.float32)
    t2s = (t2 * 0.9).astype(np.float32)
    args = (R1f, t1s, x_a, R2f, t2s, x_b, x_c, z0, w)
    got = te.three_view_bundle(*map(to_torch, args))
    want = je.three_view_bundle(*map(jnp.asarray, args))
    errs = [_err(g, w_) for g, w_ in zip(got[:4], want[:4])]
    s_got = float(torch.linalg.vector_norm(got[3]))
    s_want = float(jnp.linalg.norm(want[3]))
    print("bundle R1, t1, R2, t2", errs, "scale", s_got, s_want)
    assert max(errs) <= 1e-4
    assert abs(s_got - s_want) <= 1e-4 * s_want
    assert abs(s_want - 0.8) < 0.02
