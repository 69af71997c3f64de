"""Sim(3) pose-graph optimization, the scale-drift-aware mono back-end
(port of ``libviso_tpu/solvers/pose_graph_sim3.py``).

The SE(3) graph cannot express "this loop came back 12 % smaller"; this
one optimizes the same graph over Sim(3) nodes (``geometry/sim3.py``),
with 7-dof residuals ``r_ij = vec7( inv(Z_ij) @ inv(S_i) @ S_j )``.
Odometry edges carry s = 1, loop edges the measured relative scale
(``pipeline/mono_loop.py``).  The solve is ``solvers/pose_graph.py``'s:
per-node deltas, ``torch.func.jacfwd``, LM-damped Cholesky, Cauchy IRLS
on the masked (loop) edges, node 0 pinned.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from libviso_torch.geometry.se3 import invert_se3
from libviso_torch.geometry.sim3 import (
    invert_sim3,
    matrix_to_sim3_vector,
    sim3_to_se3,
    sim3_vector_to_matrix,
)
from libviso_torch.solvers.pose_graph import (
    _optimize,
    _robust_mask,
    segment_of_frames,
)


class Sim3GraphResult(NamedTuple):
    poses: torch.Tensor       # (T, 4, 4) optimized Sim(3) node poses
    cost0: torch.Tensor       # () initial weighted squared residual
    cost: torch.Tensor        # () final (both under the final IRLS scaling)
    ok: torch.Tensor          # () bool: finite and not above cost0
    edge_scale: torch.Tensor  # (M,) final robust IRLS weight per edge


def optimize_sim3_graph(poses, edges_i, edges_j, z, weights=None,
                        iters: int = 10, damping: float = 1e-4,
                        robust: str = "cauchy", robust_mask=None,
                        robust_delta: float = 0.05,
                        scale_weight: float = 1.0) -> Sim3GraphResult:
    """LM-damped Gauss-Newton over the Sim(3) graph.

    Arguments as ``optimize_pose_graph``'s, with ``poses`` (T, 4, 4)
    Sim(3) (plain SE(3) matrices are Sim(3) with s = 1), ``z`` (M, 4, 4)
    measured ``inv(S_i) S_j``, and ``scale_weight`` the weight of the
    log-scale residual component against the rotation and translation
    ones.
    """
    S0 = torch.as_tensor(poses)
    dev, dt = S0.device, S0.dtype
    ei = torch.as_tensor(edges_i, dtype=torch.long, device=dev)
    ej = torch.as_tensor(edges_j, dtype=torch.long, device=dev)
    z_inv = invert_sim3(torch.as_tensor(z, dtype=dt, device=dev))
    M = ei.shape[0]
    if weights is None:
        weights = torch.ones(M, dtype=dt, device=dev)
    comp_w = torch.ones(7, dtype=dt, device=dev)
    comp_w[6] = scale_weight
    w = torch.sqrt(torch.as_tensor(weights, dtype=dt,
                                   device=dev))[:, None] * comp_w
    rmask = _robust_mask(robust, robust_mask, M, dev)
    return Sim3GraphResult(*_optimize(
        S0, ei, ej, z_inv, w, 7, sim3_vector_to_matrix,
        matrix_to_sim3_vector, invert_sim3, iters, damping, robust, rmask,
        robust_delta))


def reanchor_segments_sim3(poses_full, node_frames, node_sim3_opt):
    """Propagate optimized Sim(3) node poses to every frame: frames in
    segment [node_k, node_{k+1}) keep their rigid motion relative to
    node_k through the node's correction, ``T_f' = se3( S'_k @ inv(P_k) @
    T_f )`` (the node's scale multiplies the local translation offsets and
    is then divided off the rotation block).  poses_full (T, 4, 4) SE(3),
    node_frames (K,) increasing, node_sim3_opt (K, 4, 4) -> (T, 4, 4)
    SE(3)."""
    poses_full = torch.as_tensor(poses_full)
    nf = torch.as_tensor(node_frames, dtype=torch.long,
                         device=poses_full.device)
    seg = segment_of_frames(nf, poses_full.shape[0])
    fix = torch.as_tensor(node_sim3_opt)[seg] @ invert_se3(
        poses_full[nf[seg]])
    return sim3_to_se3(fix @ poses_full)
