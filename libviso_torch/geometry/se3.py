"""SE(3) utilities: Euler-XYZ parameterization and pose chaining.

Port of ``libviso_tpu/geometry/se3.py``.  A 6-vector
``tr = (rx, ry, rz, tx, ty, tz)`` maps to a 4x4 rigid transform with
R = Rx' Ry' Rz' in the element layout of the reference's ``tr2mat``.
Every function is batched over leading dims.
"""

from __future__ import annotations

import torch


def _sincos(r):
    rx, ry, rz = r[..., 0], r[..., 1], r[..., 2]
    return (torch.sin(rx), torch.cos(rx), torch.sin(ry), torch.cos(ry),
            torch.sin(rz), torch.cos(rz))


def euler_to_rotation(r):
    """(..., 3) Euler angles -> (..., 3, 3) rotation."""
    sx, cx, sy, cy, sz, cz = _sincos(r)
    row0 = torch.stack([cy * cz, -cy * sz, sy], dim=-1)
    row1 = torch.stack([sx * sy * cz + cx * sz, -sx * sy * sz + cx * cz,
                        -sx * cy], dim=-1)
    row2 = torch.stack([-cx * sy * cz + sx * sz, cx * sy * sz + sx * cz,
                        cx * cy], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def pose_vector_to_matrix(tr):
    """(..., 6) motion vector -> (..., 4, 4) homogeneous transform."""
    R = euler_to_rotation(tr[..., :3])
    top = torch.cat([R, tr[..., 3:6, None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def matrix_to_pose_vector(T):
    """(..., 4, 4) rigid transform -> (..., 6) motion vector (valid away
    from the ry = +-pi/2 gimbal lock)."""
    R = T[..., :3, :3]
    ry = torch.asin(torch.clamp(R[..., 0, 2], -1.0, 1.0))
    rx = torch.atan2(-R[..., 1, 2], R[..., 2, 2])
    rz = torch.atan2(-R[..., 0, 1], R[..., 0, 0])
    return torch.cat([torch.stack([rx, ry, rz], dim=-1), T[..., :3, 3]],
                     dim=-1)


def rotation_derivatives(r):
    """dR/drx, dR/dry, dR/drz as (..., 3, 3, 3), parameter axis first."""
    sx, cx, sy, cy, sz, cz = _sincos(r)
    zero = torch.zeros_like(sx)
    drx = torch.stack([
        torch.stack([zero, zero, zero], dim=-1),
        torch.stack([cx * sy * cz - sx * sz, -cx * sy * sz - sx * cz,
                     -cx * cy], dim=-1),
        torch.stack([sx * sy * cz + cx * sz, -sx * sy * sz + cx * cz,
                     -sx * cy], dim=-1),
    ], dim=-2)
    dry = torch.stack([
        torch.stack([-sy * cz, sy * sz, cy], dim=-1),
        torch.stack([sx * cy * cz, -sx * cy * sz, sx * sy], dim=-1),
        torch.stack([-cx * cy * cz, cx * cy * sz, -cx * sy], dim=-1),
    ], dim=-2)
    drz = torch.stack([
        torch.stack([-cy * sz, -cy * cz, zero], dim=-1),
        torch.stack([-sx * sy * sz + cx * cz, -sx * sy * cz - cx * sz,
                     zero], dim=-1),
        torch.stack([cx * sy * sz + sx * cz, cx * sy * cz - sx * sz,
                     zero], dim=-1),
    ], dim=-2)
    return torch.stack([drx, dry, drz], dim=-3)


def invert_se3(T):
    """Closed-form inverse of (..., 4, 4) rigid transforms: [R' -R't]."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    new_t = -torch.matmul(Rt, T[..., :3, 3:4])
    top = torch.cat([Rt, new_t], dim=-1)
    return torch.cat([top, T[..., 3:4, :]], dim=-2)


def chain_motions(motions, valid=None):
    """Compose (T, 4, 4) per-frame motions into cumulative poses
    ``pose_k = Tr_1^-1 @ ... @ Tr_k^-1``; invalid frames contribute the
    identity.  A sequential product (the JAX package uses an associative
    scan, which agrees up to float rounding)."""
    inv = invert_se3(motions)
    if valid is not None:
        eye = torch.eye(4, dtype=inv.dtype, device=inv.device)
        inv = torch.where(valid[:, None, None], inv, eye)
    poses = [inv[0]] if len(inv) else []
    for k in range(1, len(inv)):
        poses.append(poses[-1] @ inv[k])
    if not poses:
        return inv
    return torch.stack(poses)
