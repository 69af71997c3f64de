"""Projective geometry the stereo path needs: homogeneous coordinates, the
fundamental matrix from two cameras, and the Sampson distance.

Port of the slice's part of ``libviso_tpu/geometry/mvg.py``; shape
polymorphic over leading dims.
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
