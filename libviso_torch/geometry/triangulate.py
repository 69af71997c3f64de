"""Rectified-stereo triangulation (port of
``libviso_tpu/geometry/triangulate.py::triangulate_rectified``)."""

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
