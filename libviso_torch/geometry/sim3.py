"""Sim(3) utilities: scaled rigid transforms for monocular drift (port of
``libviso_tpu/geometry/sim3.py``).

A Sim(3) is a 4x4 matrix whose rotation block carries the scale,
``S = [[s R, t], [0, 1]]``, so composition is a plain matmul.  Its
7-vector coordinates extend the Euler-XYZ 6-vector of ``geometry/se3.py``
with a trailing ``log s``: ``xi = (rx, ry, rz, tx, ty, tz, log_s)``.
Every function is batched over leading dims.
"""

from __future__ import annotations

import torch

from libviso_torch.geometry.se3 import euler_to_rotation


def sim3_from_parts(s, R, t):
    """Assemble ``[[s R, t], [0, 1]]`` from s (...), R (..., 3, 3) and
    t (..., 3)."""
    top = torch.cat([s[..., None, None] * R, t[..., :, None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def sim3_vector_to_matrix(xi):
    """7-vector -> 4x4 Sim(3); ``xi[..., 6] = 0`` gives the rigid
    transform of ``se3.pose_vector_to_matrix``."""
    return sim3_from_parts(torch.exp(xi[..., 6]),
                           euler_to_rotation(xi[..., :3]), xi[..., 3:6])


def sim3_scale(S):
    """Scale of a Sim(3): ``det(s R)^(1/3) = s``; (..., 4, 4) -> (...)."""
    det = torch.linalg.det(S[..., :3, :3])
    return torch.sign(det) * torch.abs(det) ** (1.0 / 3.0)


def matrix_to_sim3_vector(S):
    """4x4 Sim(3) -> 7-vector (valid away from ry = +-pi/2)."""
    s = sim3_scale(S)
    R = S[..., :3, :3] / s[..., None, None]
    ry = torch.asin(torch.clamp(R[..., 0, 2], -1.0, 1.0))
    rx = torch.atan2(-R[..., 1, 2], R[..., 2, 2])
    rz = torch.atan2(-R[..., 0, 1], R[..., 0, 0])
    return torch.cat([torch.stack([rx, ry, rz], dim=-1), S[..., :3, 3],
                      torch.log(s)[..., None]], dim=-1)


def invert_sim3(S):
    """Closed-form inverse: ``[[s R, t]]^-1 = [[R' / s, -R' t / s]]``."""
    s = sim3_scale(S)
    A_inv = S[..., :3, :3].transpose(-1, -2) / (s * s)[..., None, None]
    top = torch.cat([A_inv, -(A_inv @ S[..., :3, 3:4])], dim=-1)
    return torch.cat([top, S[..., 3:4, :]], dim=-2)


def sim3_to_se3(S):
    """The rigid part of a Sim(3): the scale divided off the rotation
    block, the translation kept."""
    s = sim3_scale(S)
    top = torch.cat([S[..., :3, :3] / s[..., None, None], S[..., :3, 3:4]],
                    dim=-1)
    return torch.cat([top, S[..., 3:4, :]], dim=-2)
