"""Essential-matrix estimation, pose recovery and the mono refiners (port of
``libviso_tpu/geometry/essential.py``).

Normalized coordinates throughout (x2' E x1 = 0, x2 ~ R x1 + t).  Both
minimal solvers run inside one batched RANSAC: the 8-point estimator (one
batched SVD over all hypotheses) and the Nister 5-point
(``geometry/five_point.py``, up to 22 candidates a sample).  The Gumbel
scores that draw the samples are an argument, as in ``solvers/ransac.py``,
so a run's draws can be fixed from outside.  The refiners' Jacobians come
from ``torch.func.jacfwd``; their guarded steps ("keep the step only if
the cost fell") are ``torch.where`` selections, so no step waits for the
host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from libviso_torch.geometry.mvg import e2h
from libviso_torch.ops.topk import first_argmax, topk_iterative
from libviso_torch.utils.stats import masked_median_abs


def normalize_points(x, K):
    """Pixel -> normalized camera coordinates through K^-1 (no
    distortion); K is a (3, 3) tensor."""
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    skew = K[0, 1]
    y = (x[..., 1] - cy) / fy
    xn = (x[..., 0] - cx - skew * y) / fx
    return torch.stack([xn, y], dim=-1)


def undistort_points(x, K, D, iters: int = 5):
    """Pixel -> normalized coordinates with Brown-Conrady undistortion,
    D = (k1, k2, p1, p2) as a tensor (None: no distortion): OpenCV's
    ``undistortPoints`` fixed-point inversion of the distortion model."""
    if D is None:
        D = torch.zeros(4, dtype=x.dtype, device=x.device)
    k1, k2, p1, p2 = D[0], D[1], D[2], D[3]
    xd = normalize_points(x, K)
    u = xd
    for _ in range(iters):
        r2 = (u * u).sum(-1, keepdim=True)
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        ux = u[..., 0:1]
        uy = u[..., 1:2]
        tang = torch.cat(
            [2 * p1 * ux * uy + p2 * (r2 + 2 * ux * ux),
             p1 * (r2 + 2 * uy * uy) + 2 * p2 * ux * uy], dim=-1)
        u = (xd - tang) / radial
    return u


def _outer_rows(x1, x2):
    """(..., N, 9) rows kron(x2_h, x1_h): vec(E) row-major dotted with a
    row is x2' E x1."""
    h1 = e2h(x1)
    h2 = e2h(x2)
    return (h2[..., :, None] * h1[..., None, :]).reshape(
        *x1.shape[:-1], 9)


def eight_point_E(x1, x2, weights=None):
    """Essential matrix from >= 8 normalized correspondences (batched over
    leading dims), projected onto the essential manifold (singular values
    (s, s, 0), s the mean of the two largest).  ``weights`` (..., N) scales
    the rows (0 excludes one)."""
    A = _outer_rows(x1, x2)
    if weights is not None:
        A = A * weights[..., None]
    # the null vector is the last right singular vector: a minimal 8x9
    # system needs the full Vh for it, N >= 9 rows give it in the thin one
    # (and no N x N U nothing reads)
    vh = torch.linalg.svd(A, full_matrices=A.shape[-2] < 9).Vh
    E = vh[..., -1, :].reshape(*x1.shape[:-2], 3, 3)
    U, s, Vh = torch.linalg.svd(E)
    sm = (s[..., 0] + s[..., 1]) / 2.0
    S = torch.zeros_like(E)
    S[..., 0, 0] = sm
    S[..., 1, 1] = sm
    return (U @ S) @ Vh


def decompose_E(E):
    """The four (R, t) candidates of an essential matrix: (Rs (..., 4, 3, 3),
    ts (..., 4, 3)), |t| = 1, convention x2 ~ R x1 + t."""
    U, _, Vh = torch.linalg.svd(E)
    # proper rotations (the sign flips on U's last column are absorbed by
    # the +-t candidates)
    u_sign = torch.where(torch.linalg.det(U) < 0, -1.0, 1.0).to(E.dtype)
    v_sign = torch.where(torch.linalg.det(Vh) < 0, -1.0, 1.0).to(E.dtype)
    U = torch.cat([U[..., :, :2], U[..., :, 2:] * u_sign[..., None, None]],
                  dim=-1)
    Vh = torch.cat([Vh[..., :2, :], Vh[..., 2:, :] * v_sign[..., None, None]],
                   dim=-2)
    W = torch.tensor([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]], dtype=E.dtype,
                     device=E.device)
    Ra = (U @ W) @ Vh
    Rb = (U @ W.T) @ Vh
    t = U[..., :, 2]
    t = t / torch.linalg.vector_norm(t, dim=-1, keepdim=True)
    return (torch.stack([Ra, Ra, Rb, Rb], dim=-3),
            torch.stack([t, -t, t, -t], dim=-2))


def two_view_depths(R, t, x1, x2):
    """Per-point depths (z1, z2) of the triangulated correspondences in
    camera 1 ([I|0]) and camera 2 ([R|t]), under x2 ~ R x1 + t: z1 solves
    h2 x (R h1 z1 + t) = 0 in least squares.  R (..., 3, 3) and t (..., 3)
    broadcast against the points' leading dims."""
    h1 = e2h(x1)
    Rx1 = h1 @ R.transpose(-1, -2)                      # (..., N, 3)
    h2 = e2h(x2)
    tb = t[..., None, :].expand_as(Rx1)
    cross_R = torch.linalg.cross(h2.expand_as(Rx1), Rx1, dim=-1)
    cross_t = torch.linalg.cross(h2.expand_as(Rx1), tb, dim=-1)
    num = -(cross_R * cross_t).sum(-1)
    den = (cross_R * cross_R).sum(-1)
    z1 = num / torch.clamp(den, min=1e-12)
    X1 = h1 * z1[..., None]
    X2 = X1 @ R.transpose(-1, -2) + t[..., None, :]
    return z1, X2[..., 2]


def _epipolar_terms(E, x1, x2):
    """(x2' E x1, |(E x1)_xy|^2 + |(E' x2)_xy|^2) with E (..., 3, 3)
    broadcast elementwise against x1/x2 (..., 2), written out term by
    term (no (..., 3, 3) temporary per point)."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    e = [[E[..., i, j] for j in range(3)] for i in range(3)]
    a0, a1, a2 = (e[i][0] * u1 + e[i][1] * v1 + e[i][2] for i in range(3))
    b0, b1 = (e[0][i] * u2 + e[1][i] * v2 + e[2][i] for i in range(2))
    num = u2 * a0 + v2 * a1 + a2
    return num, a0 ** 2 + a1 ** 2 + b0 ** 2 + b1 ** 2


def sampson_distance(E, x1, x2):
    """Sampson distance (x2' E x1)^2 / (|(E x1)_xy|^2 + |(E' x2)_xy|^2),
    with E (..., 3, 3) broadcast elementwise against x1/x2 (..., 2): the
    JAX package's form (``mvg.sampson_distance``), where the matcher's
    ``geometry/mvg.py::sampson_distance`` treats the points' last-but-one
    axis as matrix rows."""
    num, den = _epipolar_terms(E, x1, x2)
    return num ** 2 / den


def _sampson_residual(E, x1, x2):
    """Signed first-order geometric (Sampson) epipolar residual
    x2' E x1 / sqrt(|(E x1)_xy|^2 + |(E' x2)_xy|^2)."""
    num, den = _epipolar_terms(E, x1, x2)
    return num / torch.sqrt(torch.clamp(den, min=1e-18))


def _skew(v):
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], dim=-1),
        torch.stack([v[..., 2], z, -v[..., 0]], dim=-1),
        torch.stack([-v[..., 1], v[..., 0], z], dim=-1)], dim=-2)


def _expm_so3(w):
    """Rodrigues exponential of a (3,) axis-angle vector."""
    th = torch.sqrt((w * w).sum() + 1e-24)
    K = _skew(w / th)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + torch.sin(th) * K + (1.0 - torch.cos(th)) * (K @ K)


def _row(x, i):
    """x[i] for a 0-d index tensor, without the host sync that indexing
    with a 0-d tensor makes."""
    return x.index_select(0, i.reshape(1))[0]


def _t_basis(t):
    """(3, 2) orthonormal basis of the plane perpendicular to t, seeded by
    the world axis least aligned with t."""
    a = _row(torch.eye(3, dtype=t.dtype, device=t.device),
             first_argmax(-t.abs()))
    b1 = torch.linalg.cross(t, a)
    b1 = b1 / torch.clamp(torch.linalg.vector_norm(b1), min=1e-12)
    b2 = torch.linalg.cross(t, b1)
    b2 = b2 / torch.clamp(torch.linalg.vector_norm(b2), min=1e-12)
    return torch.stack([b1, b2], dim=-1)


def _unit(t):
    return t / torch.clamp(torch.linalg.vector_norm(t), min=1e-12)


def _solve(A, b):
    """A^-1 b for a small system without a host sync (a singular A gives
    non-finite values, which the callers' guards reject)."""
    return torch.linalg.solve_ex(A, b).result


def refine_relative_pose(R, t, x1, x2, weights, iters: int = 8,
                         damping: float = 1e-6):
    """Gauss-Newton ML refinement of a relative pose on its 5-dof manifold
    (rotation by right-multiplied exponential coordinates, translation on
    the unit sphere through its tangent basis), minimizing the Huber-IRLS
    weighted Sampson error.  A step is kept only where the weighted cost
    fell under the same weights.

    R (3, 3), t (3,) of any nonzero norm, x1/x2 (N, 2), weights (N,)
    (0 excludes a row).  Returns (R, t) with |t| = 1.
    """
    w = weights.to(x1.dtype)
    active = w > 0
    t = _unit(t)

    def robust_w(r):
        sig = 1.4826 * masked_median_abs(r, active) + 1e-9
        knee = 1.345 * sig
        return w * torch.clamp(knee / torch.clamp(r.abs(), min=1e-18),
                               max=1.0)

    for _ in range(iters):
        B = _t_basis(t)

        def resid(p, R=R, t=t, B=B):
            Rp = R @ _expm_so3(p[:3])
            tp = _unit(t + B @ p[3:5])
            return _sampson_residual(_skew(tp) @ Rp, x1, x2)

        p0 = torch.zeros(5, dtype=x1.dtype, device=x1.device)
        r0 = resid(p0)
        wr = robust_w(r0)
        c0 = (wr * r0 * r0).sum()
        J = jacfwd(resid)(p0)                           # (N, 5)
        Jw = J * wr[:, None]
        H = J.T @ Jw
        g = (Jw * r0[:, None]).sum(0)
        lam = damping * torch.trace(H) / 5.0 + 1e-12
        eye = torch.eye(5, dtype=H.dtype, device=H.device)
        delta = -_solve(H + lam * eye, g)
        R1 = R @ _expm_so3(delta[:3])
        t1 = _unit(t + B @ delta[3:5])
        r1 = _sampson_residual(_skew(t1) @ R1, x1, x2)
        c1 = (wr * r1 * r1).sum()
        ok = torch.isfinite(c1) & (c1 < c0)
        R = torch.where(ok, R1, R)
        t = torch.where(ok, t1, t)
    return R, t


def depth_log_grads(R, t, x1, x2):
    """(g1, g2), each (N, 5): the derivatives of log z1 and log z2 (the
    depths of ``two_view_depths``) with respect to the 5-dof perturbation
    of the pose (R exp([p0:3]), t moved in its tangent basis by p3:5) at
    p = 0: the covariates of the 'regression' scale estimator."""
    B = _t_basis(t)

    def logz(p):
        Rp = R @ _expm_so3(p[:3])
        tp = _unit(t + B @ p[3:5])
        z1, z2 = two_view_depths(Rp, tp, x1, x2)
        eps = 1e-6
        return torch.stack([torch.log(torch.clamp(z1, min=eps)),
                            torch.log(torch.clamp(z2, min=eps))], dim=0)

    J = jacfwd(logz)(torch.zeros(5, dtype=x1.dtype, device=x1.device))
    return J[0], J[1]


def pnp_refine_pose(R, t, X_prev, x_cur, weights, iters: int = 8,
                    huber: float = 4e-3, damping: float = 1e-6):
    """Motion-only PnP: GN over the full 6-dof (R, t) against fixed points,
    X_prev = R X_cur + t, so a landmark of the previous camera projects
    into the current one at pi(R' (X_prev - t)).  t is free, so |t| of the
    optimum is the step length in X_prev's units.  Huber-IRLS on the
    residual norm (``huber`` in normalized units), cost-guarded steps.
    Returns (R, t)."""
    w0 = weights.to(x_cur.dtype)

    def resid_of(R, t):
        Xc = (X_prev - t[None, :]) @ R
        z = torch.clamp(Xc[..., 2], min=1e-6)
        return Xc[..., :2] / z[..., None] - x_cur       # (N, 2)

    def huber_w(r):
        nrm = torch.sqrt((r * r).sum(-1) + 1e-18)
        return torch.clamp(huber / nrm, max=1.0)

    def cost(R, t):
        r = resid_of(R, t)
        nrm2 = (r * r).sum(-1)
        nrm = torch.sqrt(nrm2 + 1e-18)
        rho = torch.where(nrm <= huber, nrm2,
                          2.0 * huber * nrm - huber * huber)
        return (w0 * rho).sum()

    c0 = cost(R, t)
    for _ in range(iters):
        def resid(p, R=R, t=t):
            return resid_of(R @ _expm_so3(p[:3]), t + p[3:6]).reshape(-1)

        p0 = torch.zeros(6, dtype=x_cur.dtype, device=x_cur.device)
        r0 = resid(p0)
        wi = (w0 * huber_w(r0.reshape(-1, 2))).repeat_interleave(2)
        J = jacfwd(resid)(p0)                           # (2N, 6)
        Jw = J * wi[:, None]
        H = J.T @ Jw
        g = (Jw * r0[:, None]).sum(0)
        lam = damping * torch.trace(H) / 6.0 + 1e-12
        eye = torch.eye(6, dtype=H.dtype, device=H.device)
        delta = -_solve(H + lam * eye, g)
        R1 = R @ _expm_so3(delta[:3])
        t1 = t + delta[3:6]
        c1 = cost(R1, t1)
        ok = torch.isfinite(c1) & (c1 < c0)
        R = torch.where(ok, R1, R)
        t = torch.where(ok, t1, t)
        c0 = torch.where(ok, c1, c0)
    return R, t


def three_view_bundle(R1, t1, x_a, R2, t2, x_b, x_c, z0, weights,
                      iters: int = 10, huber: float = 4e-3,
                      damping: float = 1e-4):
    """Three-view bundle adjustment for monocular relative scale: the ML
    estimator against the raw observations in all three frames, free of the
    errors-in-variables dilution of depth ratios.

    Camera b (the middle frame) anchors the tracks: X_a = R1 X_b + t1 with
    the gauge |t1| = 1, X_b = R2 X_c + t2 with t2 free (|t2| is the scale
    of step 2 in step-1 units), X_b_i = z_i h(x_b_i).  Unknowns: the 5-dof
    pose-1 correction, the 6-dof pose-2 correction and one log-depth per
    track; residuals the reprojections into frames a and c.  Damped GN
    with the per-track Schur complement (1x1 blocks), Tukey-biweight IRLS
    per frame observation, cost-guarded steps.

    Returns (R1, t1, R2, t2, z).
    """
    w0 = weights.to(x_b.dtype)
    t1 = _unit(t1)
    h_b = e2h(x_b)                                      # (N, 3) anchor rays
    u0 = torch.log(torch.clamp(z0, 1e-3, 1e5))
    eps = 1e-6
    active = w0 > 0
    dev, dt = x_b.device, x_b.dtype

    def resid_one(p, du, u_i, hb_i, xa_i, xc_i, R1c, t1c, R2c, t2c):
        """(4,) reprojection residual of one track under the 11-dof pose
        perturbation p and its own log-depth perturbation du."""
        B1 = _t_basis(t1c)
        R1p = R1c @ _expm_so3(p[0:3])
        t1p = _unit(t1c + B1 @ p[3:5])
        R2p = R2c @ _expm_so3(p[5:8])
        t2p = t2c + p[8:11]
        Xb = torch.exp(u_i + du) * hb_i
        Xa = R1p @ Xb + t1p
        Xc = (Xb - t2p) @ R2p
        ra = Xa[:2] / torch.clamp(Xa[2], min=eps) - xa_i
        rc = Xc[:2] / torch.clamp(Xc[2], min=eps) - xc_i
        return torch.cat([ra, rc])

    def residuals(u, R1c, t1c, R2c, t2c):
        """(N, 4) residuals of all tracks at zero perturbation."""
        Xb = torch.exp(u)[:, None] * h_b
        Xa = Xb @ R1c.T + _unit(t1c)
        Xc = (Xb - t2c) @ R2c
        ra = Xa[:, :2] / torch.clamp(Xa[:, 2:], min=eps) - x_a
        rc = Xc[:, :2] / torch.clamp(Xc[:, 2:], min=eps) - x_c
        return torch.cat([ra, rc], dim=-1)

    def frame_weights(r):
        na = torch.sqrt((r[:, :2] ** 2).sum(-1) + 1e-18)
        nc = torch.sqrt((r[:, 2:] ** 2).sum(-1) + 1e-18)

        def tukey(n):
            sig = torch.clamp(1.4826 * masked_median_abs(n, active),
                              min=huber / 4.685)
            q = n / (4.685 * sig)
            return torch.where(q < 1.0, (1.0 - q * q) ** 2, 0.0)

        wa = tukey(na)
        wc = tukey(nc)
        return w0[:, None] * torch.stack([wa, wa, wc, wc], dim=-1)

    jac = vmap(jacfwd(resid_one, argnums=(0, 1)),
               in_dims=(None, None, 0, 0, 0, 0, None, None, None, None))
    p0 = torch.zeros(11, dtype=dt, device=dev)
    du0 = torch.zeros((), dtype=dt, device=dev)
    eye = torch.eye(11, dtype=dt, device=dev)
    u = u0
    for _ in range(iters):
        r = residuals(u, R1, t1, R2, t2)                 # (N, 4)
        wf = frame_weights(r)
        c0 = (wf * r * r).sum()
        Jp, Ju = jac(p0, du0, u, h_b, x_a, x_c, R1, t1, R2, t2)
        # Jp (N, 4, 11), Ju (N, 4)
        JpW = Jp * wf[:, :, None]
        H_pp = torch.einsum("nri,nrj->ij", JpW, Jp)
        h_pu = torch.einsum("nri,nr->ni", JpW, Ju)
        h_uu = (wf * Ju * Ju).sum(-1)
        g_p = torch.einsum("nri,nr->i", JpW, r)
        g_u = (wf * Ju * r).sum(-1)

        lam = damping * torch.trace(H_pp) / 11.0 + 1e-12
        lam_u = damping * h_uu + 1e-9
        d_uu = h_uu + lam_u
        S = (H_pp + lam * eye
             - torch.einsum("ni,nj->ij", h_pu / d_uu[:, None], h_pu))
        gs = g_p - torch.einsum("ni,n->i", h_pu, g_u / d_uu)
        dp = -_solve(S, gs)
        du = -(g_u + h_pu @ dp) / d_uu

        B1 = _t_basis(t1)
        R1n = R1 @ _expm_so3(dp[0:3])
        t1n = _unit(t1 + B1 @ dp[3:5])
        R2n = R2 @ _expm_so3(dp[5:8])
        t2n = t2 + dp[8:11]
        un = torch.clamp(u + du, -7.0, 12.0)

        r1 = residuals(un, R1n, t1n, R2n, t2n)
        c1 = (wf * r1 * r1).sum()
        ok = torch.isfinite(c1) & (c1 < c0) & torch.isfinite(dp).all()
        R1 = torch.where(ok, R1n, R1)
        t1 = torch.where(ok, t1n, t1)
        R2 = torch.where(ok, R2n, R2)
        t2 = torch.where(ok, t2n, t2)
        u = torch.where(ok, un, u)
    return R1, t1, R2, t2, torch.exp(u)


def recover_pose(E, x1, x2, valid=None):
    """The (R, t) candidate of E with the most points in front of both
    cameras (the first such among equal counts).

    Returns (R (3, 3), t (3,), good (N,) cheirality mask, n_good ())."""
    if valid is None:
        valid = torch.ones(x1.shape[-2], dtype=torch.bool, device=x1.device)
    Rs, ts = decompose_E(E)                              # (4, 3, 3), (4, 3)
    z1, z2 = two_view_depths(Rs, ts, x1, x2)             # (4, N) each
    front = (z1 > 0) & (z2 > 0) & valid[None, :]
    counts = front.sum(-1)
    best = first_argmax(counts)
    return (_row(Rs, best), _row(ts, best), _row(front, best),
            _row(counts, best))


class EssentialResult(NamedTuple):
    E: torch.Tensor           # (3, 3)
    inliers: torch.Tensor     # (N,) bool
    num_inliers: torch.Tensor
    ok: torch.Tensor


def ransac_essential(x1, x2, valid=None, gumbel=None, num_hypotheses=128,
                     sampson_thresh=1e-5, min_inliers=16, sample_size=8,
                     method="8pt", scoring="msac", soft_refit=False,
                     generator=None, null_basis=None) -> EssentialResult:
    """Batched RANSAC essential-matrix estimation on normalized points.

    Every hypothesis is a lane: Gumbel-top-k samples of the valid points,
    the minimal solve of all samples at once ('8pt': one SVD each; '5pt':
    ``five_point_E``, up to 22 candidates each, all scored), Sampson
    scoring of every model against every point, then two refit rounds of
    the weighted 8-point solver on the best model's support, kept only if
    the refit scores at least as well (the LO guard).

    ``scoring``: 'msac' (truncated quadratic at the threshold) or 'magsac'
    (the MSAC quality averaged over the thresholds tau/4 .. 4 tau, each
    normalized by its own tau).  ``soft_refit``: refit weights
    max(0, 1 - s/tau) instead of 0/1.

    ``gumbel``: (num_hypotheses, N) Gumbel scores, else drawn from
    ``generator``; ``null_basis``: optional callable for ``five_point_E``.
    The best model is the lowest index among equal qualities.
    """
    N = x1.shape[0]
    if valid is None:
        valid = torch.ones(N, dtype=torch.bool, device=x1.device)
    if method == "5pt":
        sample_size = 5
    elif method != "8pt":
        raise ValueError(f"unknown method {method!r}")
    if gumbel is None:
        if generator is None:
            raise ValueError("ransac_essential needs gumbel or a generator")
        from libviso_torch.solvers.ransac import sample_gumbel

        gumbel = sample_gumbel((num_hypotheses, N), generator, x1.dtype)
    gumbel = gumbel.to(device=x1.device, dtype=x1.dtype)

    scores = torch.where(valid[None, :], gumbel, float("-inf"))
    _, idx = topk_iterative(scores, sample_size)         # (H, k)
    if method == "5pt":
        from libviso_torch.geometry.five_point import five_point_E

        Ec, cand_ok = five_point_E(x1[idx], x2[idx], null_basis=null_basis)
        E = Ec.reshape(-1, 3, 3)                         # (H * 22, 3, 3)
        cand_ok = cand_ok.reshape(-1)
        valid_f = valid[None, :] & cand_ok[:, None]
    else:
        E = eight_point_E(x1[idx], x2[idx])              # (H, 3, 3)
        valid_f = valid[None, :]
    s = sampson_distance(E[:, None], x1[None], x2[None])   # (M, N)
    inl = (s < sampson_thresh) & valid_f
    counts = inl.sum(-1)

    def quality(sd, mask):
        if scoring == "magsac":
            q = 0.0
            for ts in (0.25, 0.5, 1.0, 2.0, 4.0):
                tau = sampson_thresh * ts
                q = q + torch.where(mask & (sd < tau), 1.0 - sd / tau,
                                    0.0).sum(-1)
            return q / 5.0
        return torch.where(mask & (sd < sampson_thresh),
                           sampson_thresh - sd, 0.0).sum(-1)

    qual = quality(s, valid_f)
    best = first_argmax(qual)

    def refit_weights(sd):
        hard = (sd < sampson_thresh) & valid
        if soft_refit:
            return torch.where(hard, 1.0 - sd / sampson_thresh,
                               0.0).to(x1.dtype)
        return hard.to(x1.dtype)

    inl_b, s_b = _row(inl, best), _row(s, best)
    w = (torch.where(inl_b, 1.0 - s_b / sampson_thresh, 0.0).to(x1.dtype)
         if soft_refit else inl_b.to(x1.dtype))
    E_refit = eight_point_E(x1, x2, weights=w)
    # a second round on the refreshed support set
    s_1 = sampson_distance(E_refit, x1, x2)
    E_refit = eight_point_E(x1, x2, weights=refit_weights(s_1))
    s_f = sampson_distance(E_refit, x1, x2)
    final = (s_f < sampson_thresh) & valid
    n = final.sum()
    # the LO guard: a least-squares refit can degrade the model (planar
    # scenes); keep whichever scores better under the selection objective
    keep_refit = quality(s_f, valid) >= _row(qual, best)
    E_out = torch.where(keep_refit, E_refit, _row(E, best))
    final = torch.where(keep_refit, final, inl_b)
    n = torch.where(keep_refit, n, _row(counts, best))
    return EssentialResult(E=E_out, inliers=final, num_inliers=n,
                           ok=n >= min_inliers)
