"""3D-3D alignment: Procrustes/Kabsch, Umeyama, Horn, and their batched
RANSAC (port of ``libviso_tpu/geometry/procrustes.py``).

Every solver finds T with ``T @ B ~= A`` for (..., N, 3) point sets and is
batched over leading dims; the RANSACs solve all hypotheses as one batch.
Samples are a Gumbel top-k over the validity mask: the Gumbel scores are
an input (``gumbel``) or drawn from a ``torch.Generator``, as in
``solvers/ransac.py``, since torch cannot reproduce ``jax.random``.
"""

from __future__ import annotations

import torch

from libviso_torch.ops.topk import first_argmax, topk_iterative


def _centered(A, B, weights):
    """Weighted means and the sqrt-weighted centred clouds."""
    if weights is None:
        weights = torch.ones_like(A[..., 0])
    w = weights[..., None]
    wsum = torch.clamp(w.sum(-2, keepdim=True), min=1e-12)
    mean_a = (A * w).sum(-2, keepdim=True) / wsum
    mean_b = (B * w).sum(-2, keepdim=True) / wsum
    return (mean_a, mean_b, (A - mean_a) * torch.sqrt(w),
            (B - mean_b) * torch.sqrt(w))


def _homogeneous(M, t):
    """[[M, t], [0, 1]] from (..., 3, 3) and (..., 3)."""
    top = torch.cat([M, t[..., :, None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def _rotation_and_svd(Ac, Bc):
    """R of the Kabsch solve (det-corrected U D Vt of the cross-covariance
    with rows over the A axes), the singular values and the det sign."""
    C = Ac.transpose(-1, -2) @ Bc
    U, sv, Vt = torch.linalg.svd(C)
    det = torch.linalg.det(U @ Vt)
    d = torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1)
    R = (U * d[..., None, :]) @ Vt
    return R, sv, d


def solve_rigid_motion(A, B, weights=None):
    """Weighted orthogonal Procrustes: R, t minimizing sum w |R b + t - a|^2
    for (..., N, 3) clouds and optional (..., N) weights (0 masks a point
    out).  Returns the (..., 4, 4) transform with ``T @ B ~= A``."""
    mean_a, mean_b, Ac, Bc = _centered(A, B, weights)
    R, _, _ = _rotation_and_svd(Ac, Bc)
    t = mean_a[..., 0, :] - (R @ mean_b[..., 0, :, None])[..., 0]
    return _homogeneous(R, t)


def _apply(T, X):
    """T (..., 4, 4) applied to X (..., N, 3)."""
    return X @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]


def solve_similarity(A, B, weights=None):
    """Weighted Umeyama: s, R, t minimizing sum w |s R b + t - a|^2.
    Returns the (..., 4, 4) Sim(3) ``[[s R, t], [0, 1]]`` with ``T @ B ~=
    A`` (the scale folded into the rotation block, as in
    ``geometry/sim3.py``)."""
    mean_a, mean_b, Ac, Bc = _centered(A, B, weights)
    R, sv, d = _rotation_and_svd(Ac, Bc)
    var_b = torch.clamp((Bc * Bc).sum((-2, -1)), min=1e-12)
    s = (sv * d).sum(-1) / var_b
    t = mean_a[..., 0, :] - s[..., None] * (
        R @ mean_b[..., 0, :, None])[..., 0]
    return _homogeneous(s[..., None, None] * R, t)


def _ransac(solve, A, B, valid, num_hypotheses, inlier_thresh, model_size,
            gumbel, generator):
    """The RANSAC of both 3D-3D solvers: ``model_size`` samples a
    hypothesis, support within ``inlier_thresh`` in the A frame, the
    largest support (the lowest hypothesis among equal counts) refit on
    its points with ``solve``."""
    from libviso_torch.solvers.ransac import sample_gumbel

    N = A.shape[0]
    if valid is None:
        valid = torch.ones(N, dtype=torch.bool, device=A.device)
    if gumbel is None:
        if generator is None:
            raise ValueError("a 3D-3D RANSAC needs gumbel or a generator")
        gumbel = sample_gumbel((num_hypotheses, N), generator, A.dtype)
    gumbel = gumbel.to(device=A.device, dtype=A.dtype)
    scores = torch.where(valid[None, :], gumbel,
                         torch.full_like(gumbel, float("-inf")))
    _, sample_idx = topk_iterative(scores, model_size)     # (H, k)
    T = solve(A[sample_idx], B[sample_idx])                 # (H, 4, 4)
    thr2 = inlier_thresh ** 2
    resid = ((_apply(T, B[None]) - A[None]) ** 2).sum(-1)   # (H, N)
    inl = (resid < thr2) & valid[None, :]
    best = first_argmax(inl.sum(-1))
    T_refit = solve(A, B, weights=inl[best].to(A.dtype))
    resid_f = ((_apply(T_refit, B) - A) ** 2).sum(-1)
    final_mask = (resid_f < thr2) & valid
    return T_refit, final_mask, final_mask.sum()


def ransac_rigid_motion(A, B, valid=None, num_hypotheses=100,
                        inlier_thresh=0.1, model_size=3, gumbel=None,
                        generator: torch.Generator | None = None):
    """RANSAC over rigid alignments of (N, 3) clouds (``T @ B ~= A``);
    ``valid`` (N,) marks real points.  ``gumbel`` (num_hypotheses, N)
    scores pick the samples, else they are drawn from ``generator``.
    Returns (T (4, 4), inlier mask (N,), inlier count ())."""
    return _ransac(solve_rigid_motion, A, B, valid, num_hypotheses,
                   inlier_thresh, model_size, gumbel, generator)


def ransac_similarity(A, B, valid=None, num_hypotheses=100,
                      inlier_thresh=0.1, model_size=3, gumbel=None,
                      generator: torch.Generator | None = None):
    """``ransac_rigid_motion`` with the Umeyama solver: returns (T (4, 4)
    Sim(3), inlier mask (N,), inlier count ())."""
    return _ransac(solve_similarity, A, B, valid, num_hypotheses,
                   inlier_thresh, model_size, gumbel, generator)


def solve_rigid_motion_horn(A, B, weights=None, power_iters: int = 14):
    """Weighted Kabsch via Horn's quaternion method, no SVD.

    Finds T (..., 4, 4) with ``T @ B ~= A`` for (..., N, 3) point sets.
    The rotation is the dominant eigenvector of Horn's 4x4 quaternion
    matrix, found by repeated squaring of the shifted matrix (a proper
    rotation by construction).  Near-degenerate samples give an arbitrary
    rotation that RANSAC scoring rejects.
    """
    mean_a, mean_b, Ac, Bc = _centered(A, B, weights)
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
    return _homogeneous(R, t)
