"""Projective geometry: homogeneous coordinates, projection, cameras, the
fundamental matrix from two cameras, and the epipolar distances.

Port of ``libviso_tpu/geometry/mvg.py`` (its rectification helpers
excepted); shape polymorphic over leading dims.
"""

from __future__ import annotations

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
