"""Triangulation (port of ``libviso_tpu/geometry/triangulate.py``): the
closed-form rectified-stereo inverse projection of the stereo path, and
the linear (DLT) triangulation of a general camera pair."""

from __future__ import annotations

import torch

from libviso_torch.config import pad_axes


def triangulate_rectified(x, f, base, cu, cv, min_disparity=1e-4):
    """(..., N, 4) observations (u_l, v_l, u_r, v_r) -> (..., N, 3) points
    in the left camera: X = (u_l - cu) b / d, Y = (v_l - cv) b / d,
    Z = f b / d, with the disparity d clamped at ``min_disparity`` so
    padded slots stay finite.  The calibration is Python floats, or float32
    tensors shaped like x's leading batch axes (one value per row)."""
    f, base, cu, cv = (pad_axes(c, x.dim() - 1) for c in (f, base, cu, cv))
    d = torch.clamp(x[..., 0] - x[..., 2], min=min_disparity)
    X = (x[..., 0] - cu) * base / d
    Y = (x[..., 1] - cv) * base / d
    # with Python floats ``f * base / d`` runs as d.reciprocal() * (f *
    # base); written out, a tensor calibration (one row per stream) rounds
    # the same way
    Z = d.reciprocal() * (f * base)
    return torch.stack([X, Y, Z], dim=-1)


def triangulate_dlt(x1, x2, P1, P2, eps=1e-12):
    """Linear triangulation of (..., N, 2) pixel observations in two
    general (..., 3, 4) cameras: per point the right singular vector of
    least singular value of the 4x4 system x cross (P X) = 0, all points
    as one batched SVD.  A vanishing homogeneous coordinate divides by 1,
    as the reference does.  Returns (..., N, 3)."""
    P1 = P1[..., None, :, :]      # broadcast over N
    P2 = P2[..., None, :, :]
    rows = [x1[..., 0:1] * P1[..., 2, :] - P1[..., 0, :],
            x1[..., 1:2] * P1[..., 2, :] - P1[..., 1, :],
            x2[..., 0:1] * P2[..., 2, :] - P2[..., 0, :],
            x2[..., 1:2] * P2[..., 2, :] - P2[..., 1, :]]
    A = torch.stack(rows, dim=-2)                        # (..., N, 4, 4)
    Xh = torch.linalg.svd(A).Vh[..., -1, :]
    w = Xh[..., 3:4]
    w = torch.where(w.abs() < eps, torch.ones_like(w), w)
    return Xh[..., :3] / w
