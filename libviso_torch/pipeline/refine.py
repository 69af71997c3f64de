"""Windowed-BA trajectory refinement over the front-end's tracks (port of
``libviso_tpu/pipeline/refine.py``).

The frame-batched front-end (``pipeline/batched.py``) gives, per frame,
the left-slot keypoints, stereo matches, triangulated points and the
temporal map ``m11`` (current-left slot -> previous-left slot).  A landmark
track is a chain of slots through consecutive ``m11`` maps: an inverted
map composed by gathers, with fixed shapes and no ragged track lists.

Window model: the landmarks are the valid left slots of the window's
first frame, whose camera is the gauge.  Initial world points come from
frame-0 stereo triangulation, initial poses from the VO motions.  After
BA, refined relative motions replace the VO motions inside the window,
when the acceptance gate (``holdout_gate``) lets them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from libviso_torch.config import Calib
from libviso_torch.geometry.se3 import (
    matrix_to_pose_vector,
    pose_vector_to_matrix,
)
from libviso_torch.solvers.bundle_adjust import (
    _project_all,
    ba_cost,
    bundle_adjust,
)


def invert_match_map(idx, valid, n_slots):
    """Invert (..., N) cur-slot -> prev-slot match maps into (...,
    n_slots) prev -> cur maps (-1 where no current slot maps).

    Where several current slots map to one previous slot the last of them
    (the highest index) wins: the JAX package's scatter on the CPU keeps
    the last writer, and a scatter with colliding indices is not
    deterministic on the card, so the rule is written out as a max.
    Invalid rows and indices outside [0, n_slots) are dropped.
    """
    idx = idx.long()
    cur = torch.arange(idx.shape[-1], device=idx.device).expand_as(idx)
    keep = valid & (idx >= 0) & (idx < n_slots)
    targets = torch.where(keep, idx, torch.full_like(idx, n_slots))
    inv = torch.full((*idx.shape[:-1], n_slots + 1), -1, dtype=torch.long,
                     device=idx.device)
    inv.scatter_reduce_(-1, targets, cur, reduce="amax")
    return inv[..., :n_slots]


class WindowProblem(NamedTuple):
    poses0: torch.Tensor   # (W, 6) initial camera-from-frame-0 poses
    X0: torch.Tensor       # (L, 3) initial landmarks (frame-0 camera)
    obs: torch.Tensor      # (W, L, 4)
    mask: torch.Tensor     # (W, L)


def _compose_poses(motions):
    """(W, 6) per-frame motions (row 0 ignored) -> (W, 6) poses of each
    camera from frame 0: Tr_t ... Tr_1."""
    Ts = pose_vector_to_matrix(motions)
    mats = [torch.eye(4, dtype=motions.dtype, device=motions.device)]
    for T in Ts[1:]:
        mats.append(T @ mats[-1])
    return matrix_to_pose_vector(torch.stack(mats))


def build_window_problem(kp1_xy, kp2_xy, mlr_idx, mlr_valid, m11_idx,
                         m11_valid, X_tri, motions, n_slots,
                         circ_valid=None) -> WindowProblem:
    """Assemble a BA window from front-end outputs.

    Args:
      kp1_xy, kp2_xy: (W, N, 2) keypoint positions in left/right images.
      mlr_idx, mlr_valid: (W, N) stereo matches per left slot.
      m11_idx, m11_valid: (W-1, N) temporal matches (frame t+1 -> t).
      X_tri: (W, N, 3) per-frame triangulated points (camera-local).
      motions: (W, 6) VO motions (row 0 ignored; frame t-1 -> t).
      n_slots: N.
      circ_valid: optional (W-1, N) circle-consistency mask over current
        slots: a track extends only through consistent transitions.
    """
    inv_maps = invert_match_map(m11_idx, m11_valid, n_slots)
    if circ_valid is None:
        circ_valid = torch.ones_like(m11_valid)

    # landmark j's slot chain: slots[0] = j, slots[t] = inv_t[slots[t-1]]
    slot = torch.arange(n_slots, device=kp1_xy.device)
    chain = [slot]
    for inv_t, circ_t in zip(inv_maps, circ_valid):
        nxt = torch.where(slot >= 0, inv_t[slot.clamp(0, n_slots - 1)], -1)
        consistent = circ_t[nxt.clamp(0, n_slots - 1)]
        slot = torch.where((nxt >= 0) & consistent, nxt, -1)
        chain.append(slot)
    slots = torch.stack(chain)                                # (W, N)

    safe = slots.clamp(0, n_slots - 1)
    u1 = torch.take_along_dim(kp1_xy, safe[..., None], dim=1)
    r_safe = torch.gather(mlr_idx.long(), 1, safe).clamp(0, n_slots - 1)
    u2 = torch.take_along_dim(kp2_xy, r_safe[..., None], dim=1)
    obs = torch.cat([u1, u2], dim=-1)                         # (W, N, 4)
    mask = (slots >= 0) & torch.gather(mlr_valid, 1, safe)
    mask = mask & mask[0][None]   # the landmark exists in the gauge frame
    return WindowProblem(poses0=_compose_poses(motions), X0=X_tri[0],
                         obs=obs, mask=mask)


def motion_prior_poses(motions, prior_motions, prior_count):
    """A (W, 6) absolute-pose prior composed from overlap motions.

    ``prior_motions[1:prior_count]`` are the previous window's refined
    motions for this window's overlap prefix (frame 0 is the gauge, so the
    prior poses compose from the prefix alone); frames beyond the prefix
    take the current VO motions (their prior weight is zero, but the cost
    term must stay finite).
    """
    W = motions.shape[0]
    prefix = torch.arange(W, device=motions.device) < prior_count
    return _compose_poses(torch.where(prefix[:, None], prior_motions,
                                      motions))


def _masked_median(vals, mask):
    """Median of ``vals`` where ``mask`` (same shape); inf when empty."""
    flat = torch.where(mask, vals, torch.full_like(vals, float("inf")))
    s = torch.sort(flat.reshape(-1)).values
    n = mask.sum()
    # an empty mask floors (0 - 1) // 2 to -1, clipped to 0: inf
    idx = ((n - 1) // 2).clamp(0, s.shape[0] - 1)
    return torch.gather(s, 0, idx.reshape(1))[0]


def holdout_gate(poses_cand, poses_base, X0, obs, hold_mask, calib,
                 margin=0.90, min_holdout=20, split=None):
    """Accept a candidate pose set only if it predicts the gate
    observations clearly better than the baseline.

    Both pose sets reproject the same stereo-initial landmarks ``X0`` onto
    ``hold_mask``'s observations.  The statistic is the paired
    per-observation error ratio ``err_cand / err_base``; the landmarks are
    split by ``split`` (parity by default) and the window is accepted when
    both halves hold ``min_holdout`` observations and the mean of the two
    halves' median ratios is at most ``margin`` (< 1: a clear win, since on
    clean imagery the ratio reads about 0.95 even where the refit harms).
    The calibration of this rule is the JAX package's
    (``libviso_tpu/pipeline/refine.py::holdout_gate``).

    Returns (accept () bool, median ratio of half 0, of half 1).
    """
    pc, _ = _project_all(poses_cand, X0, calib)
    pb, _ = _project_all(poses_base, X0, calib)
    err_c = torch.sqrt(((obs - pc) ** 2).sum(-1))
    err_b = torch.sqrt(((obs - pb) ** 2).sum(-1))
    ratio = err_c / err_b.clamp(min=1e-6)
    if split is None:
        split = torch.arange(X0.shape[0], device=X0.device) % 2 == 0
    half0 = hold_mask & split[None, :]
    half1 = hold_mask & ~split[None, :]
    med0 = _masked_median(ratio, half0)
    med1 = _masked_median(ratio, half1)
    accept = ((half0.sum() >= min_holdout) & (half1.sum() >= min_holdout)
              & ((med0 + med1) / 2 <= margin))
    return accept, med0, med1


class WindowRefinement(NamedTuple):
    motions: torch.Tensor        # (W, 6) refined per-frame motions
    initial_cost: torch.Tensor   # () BA cost at the VO poses (final mask)
    cost: torch.Tensor           # () BA cost at the refined poses
    ok: torch.Tensor             # () converged + enough observations
    cam_obs: torch.Tensor        # (W,) post-gate observations per camera
    holdout_ok: torch.Tensor     # () holdout acceptance decision
    holdout_half0: torch.Tensor  # () median paired err ratio, half 0
    holdout_half1: torch.Tensor  # () median paired err ratio, half 1


def refine_window_motions(problem: WindowProblem, calib: Calib,
                          iters=8, damping=1e-3, min_obs=10,
                          outlier_px=30.0, rerank_px=2.0,
                          pose_prior=None, prior_weight=None,
                          holdout_modulus=0,
                          holdout_margin=0.90,
                          freeze_landmarks=False) -> WindowRefinement:
    """Run BA on a window and turn the refined poses back into per-frame
    motions.

    Two stages, since quadratic BA has no influence bound: observations
    whose initial reprojection error exceeds ``outlier_px`` are dropped and
    a coarse BA runs; the survivors are re-gated at ``rerank_px`` on the
    coarse solution's residuals and the final BA runs.  Landmarks with
    fewer than two observations leave the problem at each gate.
    ``pose_prior``/``prior_weight`` ((W, 6) each) enter both stages.

    ``holdout_ok`` is ``holdout_gate`` on the refined against the VO
    poses.  ``holdout_modulus`` 0 or 1 gates on all stage-1 observations
    of frames 1..W-1 (nothing leaves the BA); m > 1 holds every m-th
    landmark out of both stages and gates on those only.  ``cam_obs``
    counts each camera's observations after both gates: the caller keeps
    the VO motion of a weakly observed camera.
    """
    keep = problem.mask.sum(0) >= 2
    mask = problem.mask & keep[None]
    predict, _ = _project_all(problem.poses0, problem.X0, calib)
    err2 = ((problem.obs - predict) ** 2).sum(-1)
    mask = mask & (err2 < outlier_px ** 2)
    L = problem.X0.shape[0]
    lm = torch.arange(L, device=mask.device)
    if holdout_modulus > 1:
        hold_lm = lm % holdout_modulus == 0
        # split-half parity of the k-th held-out landmark (index k * m)
        hold_split = (lm // holdout_modulus) % 2 == 0
        hold_mask = mask & hold_lm[None]
        mask = mask & ~hold_lm[None]
    else:
        hold_split = lm % 2 == 0
        hold_mask = mask
    # frame 0 is the gauge, the same under both pose sets
    hold_mask = hold_mask & (torch.arange(mask.shape[0],
                                          device=mask.device) > 0)[:, None]
    kw = dict(iters=iters, damping=damping, pose_prior=pose_prior,
              prior_weight=prior_weight, freeze_landmarks=freeze_landmarks)
    coarse = bundle_adjust(problem.poses0, problem.X0, problem.obs, mask,
                           calib, **kw)
    predict2, _ = _project_all(coarse.poses, coarse.landmarks, calib)
    err2b = ((problem.obs - predict2) ** 2).sum(-1)
    mask2 = mask & (err2b < rerank_px ** 2)
    mask2 = mask2 & (mask2.sum(0) >= 2)[None]
    res = bundle_adjust(coarse.poses, coarse.landmarks, problem.obs, mask2,
                        calib, **kw)
    # before and after on the same (final) mask, so they compare
    initial_cost = ba_cost(problem.poses0, problem.X0, problem.obs, mask2,
                           calib, pose_prior, prior_weight)
    poses_mat = pose_vector_to_matrix(res.poses)
    rel = poses_mat[1:] @ torch.linalg.inv_ex(poses_mat[:-1])[0]
    motions = torch.cat([torch.zeros_like(res.poses[:1]),
                         matrix_to_pose_vector(rel)])
    ok = (mask2.sum() >= min_obs) & (res.cost <= initial_cost)
    holdout_ok, half0, half1 = holdout_gate(
        res.poses, problem.poses0, problem.X0, problem.obs, hold_mask,
        calib, margin=holdout_margin, split=hold_split)
    return WindowRefinement(motions, initial_cost, res.cost, ok,
                            mask2.sum(1), holdout_ok, half0, half1)
