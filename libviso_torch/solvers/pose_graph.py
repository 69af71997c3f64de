"""Pose-graph optimization, the loop-closure back-end (port of
``libviso_tpu/solvers/pose_graph.py``).

Given node poses and relative-pose constraints (the sequential odometry
edges and the loop edges of ``pipeline/loop.py``), find the poses that
minimize the weighted residual over all edges at once:

    r_ij = vec( inv(Z_ij) @ inv(T_i) @ T_j )          (6-dof per edge)

The parameters are per-node deltas, ``T_i = T0_i @ M(xi_i)`` with ``xi``
starting at zero, so they stay near the identity whatever headings the
trajectory visits.  All edges evaluate as one batched gather and matmul;
the Jacobian of the residual vector is ``torch.func.jacfwd``'s, and the
normal equations are solved densely by Cholesky under Levenberg-Marquardt
damping, trivial at the few hundred nodes the loop driver builds.  Node 0
is pinned (the gauge).  The iterations are a Python loop with no host
sync inside: a step is kept by ``torch.where``.  The matmuls are float32
(TF32 stays off, PyTorch's default for matmul).

``optimize_sim3_graph`` (``solvers/pose_graph_sim3.py``) is the same
solve over 7-dof Sim(3) nodes; both share ``_optimize``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from libviso_torch.geometry.se3 import (
    invert_se3,
    matrix_to_pose_vector,
    pose_vector_to_matrix,
)


class PoseGraphResult(NamedTuple):
    poses: torch.Tensor       # (T, 4, 4) optimized absolute poses
    cost0: torch.Tensor       # () initial weighted squared residual
    cost: torch.Tensor        # () final (both under the final IRLS scaling)
    ok: torch.Tensor          # () bool: finite and not above cost0
    edge_scale: torch.Tensor  # (M,) final robust IRLS weight per edge


def _robust_mask(robust, robust_mask, M, device):
    if robust not in ("cauchy", "huber", "none"):
        raise ValueError(f"unknown robust kernel {robust!r}")
    if robust == "none":
        return torch.zeros(M, dtype=torch.bool, device=device)
    if robust_mask is None:
        return torch.ones(M, dtype=torch.bool, device=device)
    return torch.as_tensor(robust_mask, dtype=torch.bool, device=device)


def _optimize(S0, edges_i, edges_j, z_inv, w, dof: int,
              to_matrix: Callable, to_vector: Callable, invert: Callable,
              iters, damping, robust, rmask, robust_delta):
    """The LM-damped IRLS Gauss-Newton shared by the SE(3) and Sim(3)
    graphs.  ``w`` (M, dof) weights each residual component; ``to_matrix``
    / ``to_vector`` / ``invert`` are the group's coordinate maps.
    Returns (poses, cost0, cost, ok, edge_scale)."""
    Tn = S0.shape[0]
    zero_row = torch.zeros((1, dof), dtype=S0.dtype, device=S0.device)

    def apply_delta(xf):
        xi = torch.cat([zero_row, xf.reshape(Tn, dof)[1:]])  # node 0 pinned
        return S0 @ to_matrix(xi)

    def edge_res(xf):
        """(M, dof) weighted per-edge residuals."""
        S = apply_delta(xf)
        rel = z_inv @ invert(S[edges_i]) @ S[edges_j]
        return w * to_vector(rel)

    d2 = robust_delta * robust_delta

    def irls_scale(r):
        """(M,) sqrt IRLS weight from each edge's residual norm: GN on
        sqrt(w_irls) r with w_irls = rho'(s) / s, s = |r|^2."""
        s = (r * r).sum(-1)
        if robust == "huber":
            wr = torch.clamp(torch.sqrt(d2 / torch.clamp(s, min=1e-18)),
                             max=1.0)
        else:   # cauchy: rho = d2 log(1 + s / d2)
            wr = 1.0 / (1.0 + s / d2)
        return torch.where(rmask, torch.sqrt(wr), torch.ones_like(wr))

    def cost_of(xf, sc):
        r = (sc[:, None] * edge_res(xf)).reshape(-1)
        return (r * r).sum()

    n = dof * Tn
    eye = torch.eye(n, dtype=S0.dtype, device=S0.device)
    xf = torch.zeros(n, dtype=S0.dtype, device=S0.device)
    xf0 = xf
    for _ in range(iters):
        # IRLS: the robust scaling frozen at the current residuals, one
        # damped GN step on the reweighted quadratic, judged under the same
        # frozen scaling
        sc = irls_scale(edge_res(xf))

        def flat_res(x, sc=sc):
            return (sc[:, None] * edge_res(x)).reshape(-1)

        r = flat_res(xf)
        J = torch.func.jacfwd(flat_res)(xf)              # (dof M, dof T)
        A = J.T @ r
        H = J.T @ J
        H = H + damping * torch.diag(torch.diagonal(H)) + 1e-8 * eye
        L, info = torch.linalg.cholesky_ex(H)
        step = torch.cholesky_solve(A[:, None], L)[:, 0]
        # a failed factorization gives no step (Cholesky of a matrix that
        # is not positive definite is NaN in the reference)
        step = torch.where(info == 0, step, torch.full_like(step, torch.nan))
        x_new = xf - step
        c_new = cost_of(x_new, sc)
        better = torch.isfinite(c_new) & (c_new <= cost_of(xf, sc))
        xf = torch.where(better, x_new, xf)
    sc = irls_scale(edge_res(xf))
    cost = cost_of(xf, sc)
    # cost0 under the final scaling too: the two are one objective
    cost0 = cost_of(xf0, sc)
    out = apply_delta(xf)
    ok = torch.isfinite(cost) & (cost <= cost0)
    return torch.where(ok, out, S0), cost0, cost, ok, sc * sc


def optimize_pose_graph(poses, edges_i, edges_j, z, weights=None,
                        iters: int = 10, damping: float = 1e-4,
                        robust: str = "cauchy", robust_mask=None,
                        robust_delta: float = 0.05) -> PoseGraphResult:
    """Gauss-Newton (LM-damped) over the SE(3) pose graph.

    Edges selected by ``robust_mask`` (the loop edges; odometry is
    trusted) pass through a robust kernel by IRLS: each iteration scales
    the edge's weight from its current residual, so a false loop edge's
    influence decays toward zero while consistent edges keep about unit
    scale.  Cauchy (default) redescends; 'huber' only caps.

    Args:
      poses: (T, 4, 4) initial absolute poses (node 0 stays fixed).
      edges_i, edges_j: (M,) endpoint indices per constraint.
      z: (M, 4, 4) measured relative poses, ``T_i^-1 T_j ~= z``.
      weights: optional (M,) per-edge weights.
      iters: Gauss-Newton iterations.
      damping: LM factor on diag(H).
      robust: 'cauchy' | 'huber' | 'none'.
      robust_mask: optional (M,) bool, the edges the kernel applies to;
        None means all.
      robust_delta: kernel knee on the 6-dof residual norm.

    Every tensor lives on the device of ``poses``.
    """
    T0 = torch.as_tensor(poses)
    dev, dt = T0.device, T0.dtype
    ei = torch.as_tensor(edges_i, dtype=torch.long, device=dev)
    ej = torch.as_tensor(edges_j, dtype=torch.long, device=dev)
    z_inv = invert_se3(torch.as_tensor(z, dtype=dt, device=dev))
    M = ei.shape[0]
    if weights is None:
        weights = torch.ones(M, dtype=dt, device=dev)
    w = torch.sqrt(torch.as_tensor(weights, dtype=dt, device=dev))[:, None]
    rmask = _robust_mask(robust, robust_mask, M, dev)
    return PoseGraphResult(*_optimize(
        T0, ei, ej, z_inv, w, 6, pose_vector_to_matrix,
        matrix_to_pose_vector, invert_se3, iters, damping, robust, rmask,
        robust_delta))


def odometry_edges(poses):
    """Sequential edges (i, i+1) with z from the trajectory itself."""
    Tn = poses.shape[0]
    i = torch.arange(Tn - 1, dtype=torch.long, device=poses.device)
    return i, i + 1, invert_se3(poses[:-1]) @ poses[1:]


def segment_of_frames(node_frames, Tn: int):
    """(T,) index of the node at or before each frame (0 before the
    first): ``searchsorted(side="right") - 1``, clipped."""
    nf = torch.as_tensor(node_frames, dtype=torch.long)
    seg = torch.searchsorted(nf, torch.arange(Tn, device=nf.device),
                             right=True) - 1
    return torch.clamp(seg, 0, nf.shape[0] - 1)


def reanchor_segments(poses_full, node_frames, node_poses_opt):
    """Propagate optimized node poses to every frame in between: frames in
    segment [node_k, node_{k+1}) keep their relative motion to node_k,
    ``T_f' = P_k' @ inv(P_k) @ T_f``; frames past the last node anchor to
    it.  poses_full (T, 4, 4), node_frames (K,) increasing, node_poses_opt
    (K, 4, 4) -> (T, 4, 4)."""
    poses_full = torch.as_tensor(poses_full)
    nf = torch.as_tensor(node_frames, dtype=torch.long,
                         device=poses_full.device)
    seg = segment_of_frames(nf, poses_full.shape[0])
    fix = torch.as_tensor(node_poses_opt)[seg] @ invert_se3(
        poses_full[nf[seg]])
    return fix @ poses_full
