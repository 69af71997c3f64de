"""Sliding-window stereo bundle adjustment with Schur-complement reduction
(port of ``libviso_tpu/solvers/bundle_adjust.py``).

  - The window is a fixed-shape problem: W camera poses (6-dof each), L
    landmarks (3-dof each), a dense (W, L) visibility mask, and stereo
    observations (W, L, 4) in (u_l, v_l, u_r, v_r) layout.
  - Each Levenberg-Marquardt-damped Gauss-Newton iteration builds the
    normal equations from batched einsums over the (W, L) observation
    grid: pose blocks U (W, 6, 6), landmark blocks V (L, 3, 3), coupling
    blocks W_kj (W, L, 6, 3).
  - Landmarks are eliminated by the Schur complement
        S = U_bd - W V^-1 W',   rhs = b_p - W V^-1 b_l,
    leaving a dense (6W x 6W) pose system, then landmark updates by
    back-substitution.  V^-1 is a batched 3x3 inverse.
  - Gauge freedom: pose 0 is frozen (its rows and columns are masked).

The JAX ``lax.scan`` over the iterations is a Python loop with no host
sync inside: a step is accepted by ``torch.where`` on the cost, the
inverse and the solve are the ``_ex`` forms, which report a singular
system in values (non-finite, rejected by the cost check) instead of
raising on the CPU or syncing on the card.  Products run in full float32
(the package turns TF32 off), as JAX's ``precision="highest"``.

Pose k is the 6-vector ``tr_k`` mapping world points into camera k
(Euler-XYZ, ``geometry/se3.py``), so the projection and Jacobians are the
frame solver's (``solvers/gauss_newton.py::stereo_predict``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from libviso_torch.config import Calib
from libviso_torch.geometry.se3 import euler_to_rotation, rotation_derivatives
from libviso_torch.solvers.gauss_newton import stereo_predict


def _project_all(poses, X, calib: Calib):
    """Stereo predictions of all landmarks in all frames: (W, L, 4), and
    the points in each camera (W, L, 3); (W, 6) poses broadcast against
    (L, 3) landmarks."""
    return stereo_predict(poses, X, calib)


def _jacobians(poses, X, Xc, calib: Calib):
    """Analytic Jacobians of the 4 residual rows: (A (W, L, 4, 6) with
    respect to the pose, B (W, L, 4, 3) with respect to the landmark)."""
    dR = rotation_derivatives(poses[:, :3])          # (W, 3, 3, 3)
    # dXc/dpose: rotation parameters, then the translation identity
    dXc_rot = torch.einsum("wpij,lj->wlpi", dR, X)
    eye = torch.eye(3, dtype=X.dtype, device=X.device).expand(
        *dXc_rot.shape[:2], 3, 3)
    dXc_pose = torch.cat([dXc_rot, eye], dim=2)      # (W, L, 6, 3)
    # dXc/dX = R, broadcast over L: (W, L, 3 params, 3 xyz)
    R = euler_to_rotation(poses[:, :3])
    dXc_lm = R.transpose(-1, -2)[:, None].expand(*dXc_pose.shape[:2], 3, 3)

    def proj_rows(dXc):
        # dXc: (..., P, 3) parameter-direction derivatives of Xc
        Xl, Yl, Z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
        Xr = Xl - calib.base
        dX, dY, dZ = dXc[..., 0], dXc[..., 1], dXc[..., 2]
        Z2 = (Z * Z)[..., None]
        f = calib.f
        Ju_l = f * (dX * Z[..., None] - Xl[..., None] * dZ) / Z2
        Jv_l = f * (dY * Z[..., None] - Yl[..., None] * dZ) / Z2
        Ju_r = f * (dX * Z[..., None] - Xr[..., None] * dZ) / Z2
        return torch.stack([Ju_l, Jv_l, Ju_r, Jv_l], dim=-2)  # (..., 4, P)

    return proj_rows(dXc_pose), proj_rows(dXc_lm)


class BAResult(NamedTuple):
    poses: torch.Tensor         # (W, 6) refined camera-from-world motions
    landmarks: torch.Tensor     # (L, 3) refined world points
    cost: torch.Tensor          # () final mean squared reprojection error
    initial_cost: torch.Tensor
    iters: torch.Tensor


def _cost_parts(poses, X, obs, mask, calib: Calib):
    """A landmark slice's share of the cost: (sum of squared residuals over
    its visible observations, their count)."""
    predict, _ = _project_all(poses, X, calib)
    r = torch.where(mask[..., None], obs - predict, torch.zeros_like(obs))
    return (r * r).sum(), mask.sum()


def _total_cost(parts, poses, pose_prior=None, prior_weight=None):
    """The mean squared reprojection error from the slices' cost parts (on
    the poses' device), plus the mean prior penalty when a pose prior is
    active."""
    sq = _sum_on(poses.device, [p[0] for p in parts])
    n = _sum_on(poses.device, [p[1] for p in parts]).clamp(min=1)
    c = sq / n
    if pose_prior is not None:
        d = poses - pose_prior
        c = c + (prior_weight * d * d).sum() / n
    return c


def ba_cost(poses, X, obs, mask, calib: Calib, pose_prior=None,
            prior_weight=None):
    """Mean squared reprojection error over the visible observations, plus
    the mean prior penalty when a pose prior is active (acceptance sees
    the objective the step minimizes)."""
    return _total_cost([_cost_parts(poses, X, obs, mask, calib)], poses,
                       pose_prior, prior_weight)


def _sum_on(device, parts):
    """The sum of tensors that may lie on several devices, on ``device``,
    added in order; one part is returned as it is."""
    total = parts[0].to(device)
    for p in parts[1:]:
        total = total + p.to(device)
    return total


def _add_diagonal_blocks(S, blocks):
    """S (W, W, 6, 6) with ``blocks`` (W, 6, 6) added to its diagonal
    pose blocks (in place on the diagonal view)."""
    S.diagonal(0, 0, 1).add_(blocks.permute(1, 2, 0))
    return S


# what a landmark slice eliminates: "schur" (both blocks free), "poses"
# (landmarks frozen) or "landmarks" (poses frozen)
_MODES = ("schur", "poses", "landmarks")


class LandmarkSums(NamedTuple):
    """A landmark slice's share of one LM iteration's normal equations:
    the sums over its landmarks (added over the slices) and the blocks it
    keeps for its own back-substitution."""

    U: torch.Tensor        # (W, 6, 6) pose blocks, undamped
    b_p: torch.Tensor      # (W, 6) pose gradient
    schur: object          # (W, W, 6, 6) W V^-1 W' ("schur" mode) or None
    wvb: object            # (W, 6) W V^-1 b_l ("schur" mode) or None
    Wkj: torch.Tensor      # (W, L, 6, 3) coupling blocks
    Vinv: object           # (L, 3, 3) damped landmark inverses, or None
    b_l: torch.Tensor      # (L, 3) landmark gradient


def landmark_sums(poses, X, obs, mask, calib: Calib, lam,
                  mode: str = "schur") -> LandmarkSums:
    """The landmark sums of one LM iteration over a slice of the
    landmarks (X (L, 3), obs (W, L, 4), mask (W, L)): the pose blocks and
    gradient, and under "schur" the Schur term W V^-1 W' and W V^-1 b_l.
    ``poses`` and the damping ``lam`` are on the slice's device.
    ``bundle_adjust`` is the one-slice case, ``parallel/ba_sharding.py``
    runs one slice per device."""
    maskf = mask.to(X.dtype)
    predict, Xc = _project_all(poses, X, calib)
    r = torch.where(mask[..., None], obs - predict, torch.zeros_like(obs))
    A, B = _jacobians(poses, X, Xc, calib)
    A = A * maskf[..., None, None]
    B = B * maskf[..., None, None]

    U = torch.einsum("wlri,wlrj->wij", A, A)
    V = torch.einsum("wlri,wlrj->lij", B, B)
    Wkj = torch.einsum("wlri,wlrj->wlij", A, B)
    b_p = torch.einsum("wlri,wlr->wi", A, r)
    b_l = torch.einsum("wlri,wlr->li", B, r)
    V = V + lam * torch.eye(3, dtype=X.dtype, device=X.device)
    schur = wvb = Vinv = None
    if mode != "poses":
        Vinv = torch.linalg.inv_ex(V)[0]                     # (L, 3, 3)
    if mode == "schur":
        WVinv = torch.einsum("wlij,ljk->wlik", Wkj, Vinv)    # (W, L, 6, 3)
        schur = torch.einsum("alik,bljk->abij", WVinv, Wkj)  # (W, W, 6, 6)
        wvb = torch.einsum("wlik,lk->wi", WVinv, b_l)
    return LandmarkSums(U=U, b_p=b_p, schur=schur, wvb=wvb, Wkj=Wkj,
                        Vinv=Vinv, b_l=b_l)


def landmark_step(sums: LandmarkSums, step_p, X, mode: str = "schur"):
    """A slice's landmark update from the pose step (on the slice's
    device): dX = V^-1 (b_l - W' dp), or V^-1 b_l with the poses frozen,
    or zero with the landmarks frozen."""
    if mode == "poses":
        return torch.zeros_like(X)
    if mode == "landmarks":
        return torch.einsum("lij,lj->li", sums.Vinv, sums.b_l)
    Wt_dp = torch.einsum("wlij,wi->lj", sums.Wkj, step_p)
    return torch.einsum("lij,lj->li", sums.Vinv, sums.b_l - Wt_dp)


def solve_landmark_slices(poses0, slices, calib: Calib, iters: int = 10,
                          damping: float = 1e-4, fix_first: bool = True,
                          pose_prior=None, prior_weight=None,
                          mode: str = "schur"):
    """Damped Gauss-Newton window BA over landmark slices.

    ``slices`` is a list of (X (L_i, 3), obs (W, L_i, 4), mask (W, L_i))
    triples, each on its own device; the poses, the 6W pose system and
    the LM control live on ``poses0``'s device.  Each iteration sends the
    poses and the damping to the slices, adds their ``landmark_sums``
    there, solves the pose system, sends the step back, and each slice
    back-substitutes its own landmarks.  Devices exchange tensors only
    (``.to``), so nothing waits for the host.

    Returns (poses, [landmarks of each slice], cost, initial cost).
    """
    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {_MODES}")
    if pose_prior is not None and prior_weight is None:
        raise ValueError("pose_prior requires prior_weight")
    W = poses0.shape[0]
    dtype, home = poses0.dtype, poses0.device

    # 1 for a pose the step moves, 0 for the gauge (made on the device: an
    # item assignment would copy from the host and sync)
    free = (torch.arange(W, device=home) >= int(fix_first)).to(dtype)
    eye6 = torch.eye(6, dtype=dtype, device=home)

    def cost(poses, Xs):
        return _total_cost(
            [_cost_parts(poses.to(X.device), X, obs, mask, calib)
             for X, (_, obs, mask) in zip(Xs, slices)],
            poses, pose_prior, prior_weight)

    def iteration(poses, Xs, prev_cost, lam):
        sums = [landmark_sums(poses.to(X.device), X, obs, mask, calib,
                              lam.to(X.device), mode)
                for X, (_, obs, mask) in zip(Xs, slices)]
        U = _sum_on(home, [s.U for s in sums])
        b_p = _sum_on(home, [s.b_p for s in sums])
        if pose_prior is not None:
            # diagonal prior information and its gradient
            U = U + torch.diag_embed(prior_weight)
            b_p = b_p + prior_weight * (pose_prior - poses)
        U = U + lam * eye6

        zeros = torch.zeros((W, W, 6, 6), dtype=dtype, device=home)
        if mode == "landmarks":
            # landmark-only GN: independent 3x3 solves, zero pose step
            S = _add_diagonal_blocks(zeros, eye6.expand(W, 6, 6))
            rhs = torch.zeros_like(b_p)
        elif mode == "poses":
            # pose-only GN: the system is block-diagonal in poses
            S = _add_diagonal_blocks(zeros, U)
            rhs = b_p
        else:
            # landmarks eliminated: S is block-dense over pose pairs
            S = _add_diagonal_blocks(
                -_sum_on(home, [s.schur for s in sums]), U)
            rhs = b_p - _sum_on(home, [s.wvb for s in sums])

        # gauge: zero the frozen poses' rows and columns, identity on
        # their diagonal
        S = S * free[:, None, None, None] * free[None, :, None, None]
        S = _add_diagonal_blocks(S, (1.0 - free)[:, None, None] * eye6)
        rhs = rhs * free[:, None]

        Sd = S.permute(0, 2, 1, 3).reshape(6 * W, 6 * W)
        step_p = torch.linalg.solve_ex(Sd, rhs.reshape(-1))[0].reshape(W, 6)
        step_p = step_p * free[:, None]
        if mode == "landmarks":
            step_p = step_p * 0.0

        new_poses = poses + step_p
        new_Xs = [X + landmark_step(s, step_p.to(X.device), X, mode)
                  for s, X in zip(sums, Xs)]
        new_cost = cost(new_poses, new_Xs)
        # Levenberg-Marquardt control: an accepted step relaxes the
        # damping, a rejected one tightens it
        ok = torch.isfinite(new_cost) & (new_cost < prev_cost)
        return (torch.where(ok, new_poses, poses),
                [torch.where(ok.to(X.device), nX, X)
                 for nX, X in zip(new_Xs, Xs)],
                torch.where(ok, new_cost, prev_cost),
                torch.where(ok, torch.clamp(lam / 3.0, min=1e-9), lam * 10.0))

    Xs0 = [X for X, _, _ in slices]
    init_cost = cost(poses0, Xs0)
    # made on the device (a fill), not copied from the host: no sync
    carry = (poses0, Xs0, init_cost,
             torch.full((), damping, dtype=dtype, device=home))
    for _ in range(iters):
        carry = iteration(*carry)
    poses, Xs, final_cost, _ = carry
    return poses, Xs, final_cost, init_cost


def bundle_adjust(poses0, X0, obs, mask, calib: Calib, iters: int = 10,
                  damping: float = 1e-4, fix_first: bool = True,
                  pose_prior=None, prior_weight=None,
                  freeze_landmarks: bool = False,
                  freeze_poses: bool = False) -> BAResult:
    """Damped Gauss-Newton window BA with Schur elimination of landmarks.

    Args:
      poses0: (W, 6) initial camera-from-world pose vectors.
      X0: (L, 3) initial world landmarks.
      obs: (W, L, 4) stereo observations.
      mask: (W, L) bool visibility.
      iters: fixed iteration count.
      damping: initial Levenberg damping on the U and V diagonals.
      fix_first: freeze pose 0 (the gauge).
      pose_prior, prior_weight: optional (W, 6) prior poses and per-dof
        weights [px^2 per unit^2]: the quadratic penalty
        ``prior_weight * (pose - pose_prior)^2``, a diagonal block added
        to U (the marginalization prior of the previous window).
      freeze_landmarks: optimize the poses only, against ``X0``.
      freeze_poses: optimize the landmarks only, each its own 3x3 system.

    Returns a BAResult.  A step is taken only when it lowers the cost to a
    finite value; a rejected step raises the damping tenfold, an accepted
    one lowers it threefold (down to 1e-9).  It is
    ``solve_landmark_slices`` on one slice.
    """
    mode = ("landmarks" if freeze_poses
            else "poses" if freeze_landmarks else "schur")
    poses, Xs, cost, init_cost = solve_landmark_slices(
        poses0, [(X0, obs, mask)], calib, iters=iters, damping=damping,
        fix_first=fix_first, pose_prior=pose_prior,
        prior_weight=prior_weight, mode=mode)
    return BAResult(poses=poses, landmarks=Xs[0], cost=cost,
                    initial_cost=init_cost,
                    iters=torch.full((), iters, dtype=torch.int32,
                                     device=poses0.device))
