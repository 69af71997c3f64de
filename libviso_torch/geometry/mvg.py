"""Projective geometry: homogeneous coordinates, projection, cameras, the
fundamental matrix from two cameras, and the epipolar distances.

Port of ``libviso_tpu/geometry/mvg.py``, with the stereo rig
(``Camera``, ``StereoCam``), Bouguet rectification and the rectification
warp; shape polymorphic over leading dims, the rig functions excepted.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def e2h(x):
    """Euclidean -> homogeneous along the last axis: (..., D) -> (..., D+1)."""
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def h2e(x, eps=0.0):
    """Homogeneous -> Euclidean; ``eps`` optionally guards the division."""
    w = x[..., -1:]
    if eps:
        w = torch.where(w.abs() < eps,
                        torch.where(w < 0, -eps, eps).to(w.dtype), w)
    return x[..., :-1] / w


def project(P, X):
    """Central projection of (..., N, 3) points through (..., 3, 4)
    cameras: h2e(P e2h(X))."""
    return h2e(e2h(X) @ P.transpose(-1, -2))


def P_from_KRt(K, R, t):
    """Camera matrix P = K [R | t]."""
    t = t.reshape(*R.shape[:-2], 3, 1)
    return K @ torch.cat([R, t], dim=-1)


def F_from_P(P1, P2):
    """Fundamental matrix (x2' F x1 = 0) from two (..., 3, 4) cameras in
    the tensors' dtype: F[j, i] is the determinant of [P1 without row i;
    P2 without row j], rows omitted in the order (1,2), (2,0), (0,1).
    Cancels badly in float32 at pixel scale: pipeline set-up uses
    ``F_from_P_host``."""
    keep = torch.tensor([[1, 2], [2, 0], [0, 1]], device=P1.device)
    X = P1[..., keep, :]          # (..., 3, 2, 4): X[i] = P1 without row i
    Y = P2[..., keep, :]
    lead = torch.broadcast_shapes(X.shape[:-3], Y.shape[:-3])
    Xb = X[..., None, :, :, :].expand(*lead, 3, 3, 2, 4)
    Yb = Y[..., :, None, :, :].expand(*lead, 3, 3, 2, 4)
    return torch.linalg.det(torch.cat([Xb, Yb], dim=-2))


def F_from_P_host(P1, P2):
    """Float64 numpy fundamental matrix (x2' F x1 = 0) from two 3x4
    cameras, normalized by F[2,2] when that is positive (the f32
    determinant construction cancels catastrophically at pixel scale)."""
    P1 = np.asarray(P1, dtype=np.float64)
    P2 = np.asarray(P2, dtype=np.float64)
    keep = np.array([[1, 2], [2, 0], [0, 1]])
    F = np.empty((3, 3), dtype=np.float64)
    for j in range(3):
        for i in range(3):
            M = np.concatenate([P1[keep[i]], P2[keep[j]]], axis=0)
            F[j, i] = np.linalg.det(M)
    if F[2, 2] > np.finfo(np.float64).tiny:
        F = F / F[2, 2]
    return F


def algebraic_distance(F, x1, x2):
    """Algebraic epipolar residual x2' F x1 per point; (..., 2) pixel
    coordinates broadcast against F (..., 3, 3)."""
    Fx1 = (F @ e2h(x1)[..., None])[..., 0]
    return (e2h(x2) * Fx1).sum(-1)


def sampson_distance(F, x1, x2):
    """First-order epipolar distance
    (x2'Fx1)^2 / ((Fx1)_0^2 + (Fx1)_1^2 + (F'x2)_0^2 + (F'x2)_1^2).

    ``x1``/``x2`` are (..., 2) pixel coordinates broadcast against each
    other; F is (3, 3).  A zero denominator gives NaN or inf, which
    callers reject.
    """
    x1h = e2h(x1)
    x2h = e2h(x2)
    Fx1 = x1h @ F.transpose(-1, -2)     # (..., 3): F @ x1
    Ftx2 = x2h @ F                      # (..., 3): F' @ x2
    num = (x2h * Fx1).sum(-1) ** 2
    den = (Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2
           + Ftx2[..., 1] ** 2)
    return num / den


def rms(X1, X2):
    """Per-column root-sum-of-squares of the difference, over axis -2 (no
    mean: the reference's "rms")."""
    d = X1 - X2
    return torch.sqrt((d * d).sum(-2))


def _as_tensor(x):
    """A tensor as it is; anything else as float32 (JAX's default
    dtype)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x), dtype=torch.float32)


@dataclasses.dataclass
class Camera:
    """Central-projection camera: intrinsics and distortion."""

    K: object                 # (3, 3) intrinsics
    D: object = None          # (4,) distortion parameters (None = zero)

    def __post_init__(self):
        self.K = _as_tensor(self.K)
        self.D = (torch.zeros(4, dtype=self.K.dtype, device=self.K.device)
                  if self.D is None else _as_tensor(self.D))


@dataclasses.dataclass
class StereoCam:
    """Stereo rig: two cameras, the c1 -> c2 transform and optional
    rectification data (R1, R2, P1, P2, Q).  ``p1()`` is [K1 | 0],
    ``p2()`` K2 [R | t], ``F()`` the pair's fundamental matrix."""

    c1: Camera
    c2: Camera
    R: object                 # (3, 3) rotation c1 -> c2
    t: object                 # (3,) translation c1 -> c2
    R1: object = None         # rectifying rotations
    R2: object = None
    P1: object = None         # rectified projection matrices
    P2: object = None
    Q: object = None          # disparity-to-depth matrix

    def __post_init__(self):
        self.R = _as_tensor(self.R)
        self.t = _as_tensor(self.t).reshape(3)

    def p1(self):
        K = self.c1.K
        return P_from_KRt(K, torch.eye(3, dtype=K.dtype, device=K.device),
                          torch.zeros(3, dtype=K.dtype, device=K.device))

    def p2(self):
        return P_from_KRt(self.c2.K, self.R, self.t)

    def F(self):
        return F_from_P(self.p1(), self.p2())


def _cross_matrix(k):
    z = torch.zeros((), dtype=k.dtype, device=k.device)
    return torch.stack([torch.stack([z, -k[2], k[1]]),
                        torch.stack([k[2], z, -k[0]]),
                        torch.stack([-k[1], k[0], z])])


def _rodrigues(axis_angle):
    """Rotation matrix of an axis-angle vector (Rodrigues)."""
    v = _as_tensor(axis_angle)
    theta = torch.linalg.vector_norm(v)
    eye = torch.eye(3, dtype=v.dtype, device=v.device)
    K = _cross_matrix(v / torch.where(theta > 1e-12, theta, 1.0))
    R = eye + torch.sin(theta) * K + (1.0 - torch.cos(theta)) * (K @ K)
    return torch.where(theta > 1e-12, R, eye)


def _log_so3(R):
    """Axis-angle vector of a rotation matrix."""
    R = _as_tensor(R)
    cos = torch.clamp((torch.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    theta = torch.arccos(cos)
    w = torch.stack([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    s = torch.where(theta > 1e-12, 2.0 * torch.sin(theta), 1.0)
    return torch.where(theta > 1e-12, w * theta / s, 0.5 * w)


def stereo_rectify(rig: StereoCam) -> StereoCam:
    """The rig with its rectification (R1, R2, P1, P2, Q) filled in, by
    Bouguet's method: each camera rotates by half the relative rotation,
    then both so that the new x-axis is the baseline, and both rectified
    projections share one K (f, cu, cv averaged), so disparity at
    infinity is zero.  Corresponding points then have equal v, the
    precondition of ``triangulate_rectified`` and the stereo pipeline's
    epipolar gate."""
    R, t = rig.R, rig.t
    dtype, dev = R.dtype, R.device

    # balanced split: R1 = A B1, R2 = A B2 with B1 = exp(r/2) and
    # B2 = exp(-r/2) = B1 R^-1, so that R2 R = R1
    r = _log_so3(R)
    B1 = _rodrigues(0.5 * r)
    B2 = _rodrigues(-0.5 * r)

    # the rectified x-axis along R2 t, signed for positive disparity
    u = B2 @ t
    e1 = -u / torch.clamp(torch.linalg.vector_norm(u), min=1e-12)
    up = torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=dev)
    e2 = torch.linalg.cross(up, e1)
    e2 = e2 / torch.clamp(torch.linalg.vector_norm(e2), min=1e-12)
    e3 = torch.linalg.cross(e1, e2)
    R_align = torch.stack([e1, e2, e3])     # rows
    R1 = R_align @ B1
    R2 = R_align @ B2

    K1, K2 = rig.c1.K, rig.c2.K
    f = (K1[1, 1] + K2[1, 1]) / 2.0
    cv = (K1[1, 2] + K2[1, 2]) / 2.0
    cu = (K1[0, 2] + K2[0, 2]) / 2.0
    baseline = torch.linalg.vector_norm(t)
    z = torch.zeros((), dtype=dtype, device=dev)
    one = torch.ones((), dtype=dtype, device=dev)
    Kr = torch.stack([torch.stack([f, z, cu]), torch.stack([z, f, cv]),
                      torch.stack([z, z, one])])
    P1 = torch.cat([Kr, torch.zeros((3, 1), dtype=dtype, device=dev)], 1)
    P2 = torch.cat([Kr, torch.stack([-f * baseline, z, z])[:, None]], 1)
    Q = torch.stack([torch.stack([one, z, z, -cu]),
                     torch.stack([z, one, z, -cv]),
                     torch.stack([z, z, z, f]),
                     torch.stack([z, z, 1.0 / baseline, z])])
    return dataclasses.replace(rig, R1=R1, R2=R2, P1=P1, P2=P2, Q=Q)


def _bilinear_sample(img, x, y):
    """Bilinear sample of (H, W) ``img`` at float coordinates; zero
    outside."""
    img = _as_tensor(img)
    H, W = img.shape
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    x0i = torch.clamp(x0.long(), 0, W - 1)
    y0i = torch.clamp(y0.long(), 0, H - 1)
    x1i = torch.clamp(x0i + 1, 0, W - 1)
    y1i = torch.clamp(y0i + 1, 0, H - 1)
    v00, v01 = img[y0i, x0i], img[y0i, x1i]
    v10, v11 = img[y1i, x0i], img[y1i, x1i]
    out = ((1 - fy) * ((1 - fx) * v00 + fx * v01)
           + fy * ((1 - fx) * v10 + fx * v11))
    inside = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
    return torch.where(inside, out, 0.0)


def rectification_warp(img, K_src, R_rect, K_rect):
    """An image warped into its rectified frame: rectified pixel p samples
    the source at ``K_src R_rect^T K_rect^-1 p`` (bilinear, zero outside).
    Apply with (rig.c1.K, rig.R1, rig.P1[:, :3]) and (rig.c2.K, rig.R2,
    ...) from ``stereo_rectify`` to feed an unrectified rig to the
    rectified stereo pipeline."""
    img = _as_tensor(img).to(torch.float32)
    H, W = img.shape
    Hmat = (_as_tensor(K_src) @ _as_tensor(R_rect).T
            @ torch.linalg.inv(_as_tensor(K_rect))).to(img)
    ys, xs = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=img.device),
        torch.arange(W, dtype=torch.float32, device=img.device),
        indexing="ij")
    src = torch.einsum("ij,jhw->ihw", Hmat,
                       torch.stack([xs, ys, torch.ones_like(xs)]))
    return _bilinear_sample(img, src[0] / src[2], src[1] / src[2])
