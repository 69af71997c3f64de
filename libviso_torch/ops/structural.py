"""Structural (3D-geometric) place recognition primitives (port of
``libviso_tpu/ops/structural.py``).

Pairwise distances between a keyframe's triangulated landmarks are
invariant under any rigid camera motion, a 180 degree heading flip
included, which patch appearance is not.  The pieces:

  1. per-landmark descriptor: the sorted distances to its k nearest
     co-visible landmarks (``knn_distance_descriptors``);
  2. store-wide candidate scoring: one batched 2-NN ratio and mutual
     match of a keyframe's descriptors against every stored keyframe,
     squared L2 through the |a|^2 + |b|^2 - 2ab expansion
     (``build_structural_matcher``);
  3. a seed pose from the matches by ``geometry/procrustes.py``'s
     ``ransac_rigid_motion``;
  4. fixed-iteration ICP from the seed: radius-gated mutual nearest
     neighbours and a weighted Kabsch re-solve (``build_icp_refiner``).

Plain PyTorch on the device of the inputs.  The k smallest and every
argmin keep the lowest index among equal values, as ``lax.top_k`` and
JAX's argmin do.
"""

from __future__ import annotations

import torch

from libviso_torch.geometry.procrustes import solve_rigid_motion
from libviso_torch.ops.topk import first_argmax, topk_sorted

_BIG = 1e30


def _first_argmin(x, dim):
    """Index of the smallest value along ``dim``, the lowest among ties."""
    return first_argmax(-x, dim)


def knn_distance_descriptors(X, valid, k: int = 12,
                             max_depth: float = 60.0):
    """Per-landmark rigid-invariant descriptor: sorted k-NN distances.

    X (B, 3) landmarks in the keyframe's camera frame, valid (B,) slots;
    landmarks deeper than ``max_depth`` are dropped (stereo depth noise
    grows as z^2).  Returns (desc (B, k) ascending neighbour distances,
    usable (B,)); a row needs k real neighbours, and rows that are not
    usable are zero.
    """
    usable = valid & (X[:, 2] > 0.0) & (X[:, 2] <= max_depth)
    n2 = (X * X).sum(-1)
    d2 = torch.clamp(n2[:, None] + n2[None, :] - 2.0 * (X @ X.T), min=0.0)
    pair_ok = usable[:, None] & usable[None, :]
    B = X.shape[0]
    eye = torch.eye(B, dtype=torch.bool, device=X.device)
    d2 = torch.where(pair_ok & ~eye, d2, torch.full_like(d2, _BIG))
    neg_top, _ = topk_sorted(-d2, k)           # the k smallest, ascending
    desc = torch.sqrt(torch.clamp(-neg_top, min=0.0))
    usable = usable & (pair_ok.sum(-1) > k)     # self included
    return torch.where(usable[:, None], desc, torch.zeros_like(desc)), usable


def build_structural_matcher(max_kf: int, budget: int, k: int,
                             ratio: float):
    """match_all(q_desc (B, k), q_valid (B,), kf_desc (K, B, k),
    kf_valid (K, B)) -> (idx (K, B), valid (K, B), scores (K,)): per stored
    keyframe a best target per query slot, the 2-NN ratio test on squared
    distances and the mutual check, and the count of matches, as the
    appearance candidate matcher of ``pipeline/loop.py`` returns them."""

    def match_all(q_desc, q_valid, kf_desc, kf_valid):
        qn = (q_desc * q_desc).sum(-1)                  # (B,)
        tn = (kf_desc * kf_desc).sum(-1)                # (K, B)
        cross = torch.einsum("ik,Kjk->Kij", q_desc, kf_desc)
        cost = qn[None, :, None] + tn[:, None, :] - 2.0 * cross
        cost = torch.where(q_valid[None, :, None] & kf_valid[:, None, :],
                           torch.clamp(cost, min=0.0),
                           torch.full_like(cost, _BIG))
        neg2, idx2 = topk_sorted(-cost, 2)
        best, second = -neg2[..., 0], -neg2[..., 1]
        idx = idx2[..., 0]
        ok = (best < _BIG) & (best <= (ratio * ratio) * second)
        r_idx = _first_argmin(cost, 1)                  # (K, B) target->query
        mutual = (torch.gather(r_idx, 1, idx)
                  == torch.arange(budget, device=cost.device)[None, :])
        vmatch = ok & mutual & q_valid[None, :]
        return idx, vmatch, vmatch.sum(1, dtype=torch.int32)

    return match_all


def build_icp_refiner(radius: float, iters: int = 3):
    """refine(T0 (4, 4), X_old (B, 3), o_valid (B,), X_new (B, 3),
    n_valid (B,)) -> (T, old -> new index (B,), pair mask (B,), pair
    count): ``iters`` rounds of transforming the old cloud by T, pairing
    radius-gated mutual nearest neighbours and re-solving weighted Kabsch
    on the pairs; T is held where fewer than 3 pairs remain."""

    def nn_pairs(Xo, o_valid, Xn, n_valid):
        n2o = (Xo * Xo).sum(-1)
        n2n = (Xn * Xn).sum(-1)
        d2 = n2o[:, None] + n2n[None, :] - 2.0 * (Xo @ Xn.T)
        d2 = torch.where(o_valid[:, None] & n_valid[None, :],
                         torch.clamp(d2, min=0.0),
                         torch.full_like(d2, _BIG))
        j = _first_argmin(d2, 1)                         # old -> new
        i_back = _first_argmin(d2, 0)                    # new -> old
        dmin = d2.amin(1)
        mutual = i_back[j] == torch.arange(Xo.shape[0], device=Xo.device)
        return j, o_valid & mutual & (dmin <= radius * radius)

    def refine(T0, X_old, o_valid, X_new, n_valid):
        T = T0
        for _ in range(iters):
            Xo = X_old @ T[:3, :3].T + T[:3, 3]
            j, ok = nn_pairs(Xo, o_valid, X_new, n_valid)
            w = ok.to(X_old.dtype)
            T_new = solve_rigid_motion(X_new[j], X_old, weights=w)
            T = torch.where(w.sum() >= 3, T_new, T)
        Xo = X_old @ T[:3, :3].T + T[:3, 3]
        j, ok = nn_pairs(Xo, o_valid, X_new, n_valid)
        return T, j, ok, ok.sum(dtype=torch.int32)

    return refine
