"""Closed-form 3D-3D alignment for RANSAC hypotheses (port of
``libviso_tpu/geometry/procrustes.py::solve_rigid_motion_horn``)."""

from __future__ import annotations

import torch


def solve_rigid_motion_horn(A, B, weights=None, power_iters: int = 14):
    """Weighted Kabsch via Horn's quaternion method, no SVD.

    Finds T (..., 4, 4) with ``T @ B ~= A`` for (..., N, 3) point sets.
    The rotation is the dominant eigenvector of Horn's 4x4 quaternion
    matrix, found by repeated squaring of the shifted matrix (a proper
    rotation by construction).  Near-degenerate samples give an arbitrary
    rotation that RANSAC scoring rejects.
    """
    if weights is None:
        weights = torch.ones_like(A[..., 0])
    w = weights[..., None]
    wsum = torch.clamp(w.sum(-2, keepdim=True), min=1e-12)
    mean_a = (A * w).sum(-2, keepdim=True) / wsum
    mean_b = (B * w).sum(-2, keepdim=True) / wsum
    Ac = (A - mean_a) * torch.sqrt(w)
    Bc = (B - mean_b) * torch.sqrt(w)
    S = Ac.transpose(-1, -2) @ Bc                       # (..., 3, 3)
    # only S's direction matters; normalizing keeps the squarings finite
    S = S / torch.clamp(torch.sqrt((S * S).sum((-2, -1), keepdim=True)),
                        min=1e-30)

    sxx, sxy, sxz = S[..., 0, 0], S[..., 0, 1], S[..., 0, 2]
    syx, syy, syz = S[..., 1, 0], S[..., 1, 1], S[..., 1, 2]
    szx, szy, szz = S[..., 2, 0], S[..., 2, 1], S[..., 2, 2]
    r0 = torch.stack([sxx + syy + szz, syz - szy, szx - sxz, sxy - syx], -1)
    r1 = torch.stack([syz - szy, sxx - syy - szz, sxy + syx, szx + sxz], -1)
    r2 = torch.stack([szx - sxz, sxy + syx, syy - sxx - szz, syz + szy], -1)
    r3 = torch.stack([sxy - syx, szx + sxz, syz + szy, szz - sxx - syy], -1)
    Nq = torch.stack([r0, r1, r2, r3], dim=-2)          # (..., 4, 4)

    # |lambda(N)| <= sqrt(3)|S|_F: N + shift I is PSD with the target
    # eigenvalue on top; each squaring squares the eigengap
    shift = torch.sqrt(3.0 * (S * S).sum((-2, -1), keepdim=True)) + 1e-6
    M = Nq + shift * torch.eye(4, dtype=Nq.dtype, device=Nq.device)
    for _ in range(max(1, min(power_iters, 16))):
        M = M @ M
        M = M / torch.clamp(
            torch.sqrt((M * M).sum((-2, -1), keepdim=True)), min=1e-30)
    # M ~ v v^T: its largest-norm column is the dominant eigenvector
    best = torch.argmax((M * M).sum(-2), dim=-1)
    v = torch.take_along_dim(M, best[..., None, None].expand(
        *best.shape, 4, 1), dim=-1)[..., 0]
    v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                        min=1e-30)
    # conjugate: this N recovers the A->B rotation, we return B->A
    qw, qx, qy, qz = v[..., 0], -v[..., 1], -v[..., 2], -v[..., 3]

    R = torch.stack([
        torch.stack([1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz),
                     2 * (qx * qz + qw * qy)], -1),
        torch.stack([2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz),
                     2 * (qy * qz - qw * qx)], -1),
        torch.stack([2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx),
                     1 - 2 * (qx * qx + qy * qy)], -1),
    ], dim=-2)
    t = mean_a[..., 0, :] - (R @ mean_b[..., 0, :, None])[..., 0]
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)
