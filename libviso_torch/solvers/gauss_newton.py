"""Gauss-Newton minimization of weighted stereo reprojection error.

Port of ``libviso_tpu/solvers/gauss_newton.py``.  Per-point loops are
tensor expressions over an (N,) point axis, with optional leading batch
axes (streams or the transitions of a window, then RANSAC hypotheses).
Excluded points carry weight 0.  The JAX ``lax.while_loop`` becomes a
masked Python loop with the same bound: lanes that converged or failed
freeze, so a lane's result depends neither on which other lanes share the
batch nor on ``RansacConfig.gn_unroll``, which only sets how many masked
steps run between two convergence checks (one host sync each, for all
lanes of all rows).

The calibration's fields are floats or per-row tensors shaped like the
leading batch axes (``config.Calib``); each function pads them against its
operands.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from libviso_torch.config import Calib, RansacConfig
from libviso_torch.geometry.se3 import euler_to_rotation, rotation_derivatives


def stereo_predict(tr, X, calib: Calib):
    """Project previous-frame points (..., N, 3) under motions (..., 6)
    into the current stereo pair.  Returns the predictions (..., N, 4) as
    (u_l, v_l, u_r, v_r) and the points in the current left frame."""
    R = euler_to_rotation(tr[..., :3])
    Xc = X @ R.transpose(-1, -2) + tr[..., None, 3:6]
    Zc = Xc[..., 2]
    calib = calib.against(Zc.dim())
    u_l = calib.f * Xc[..., 0] / Zc + calib.cu
    v_l = calib.f * Xc[..., 1] / Zc + calib.cv
    u_r = calib.f * (Xc[..., 0] - calib.base) / Zc + calib.cu
    return torch.stack([u_l, v_l, u_r, v_l], dim=-1), Xc


def _weights(observe, calib: Calib):
    """Centre-emphasis weights of the reference solver."""
    calib = calib.against(observe.dim() - 1)
    return 1.0 / ((observe[..., 0] - calib.cu).abs() / abs(calib.cu) + 0.05)


def residual_jacobian(tr, X, observe, calib: Calib):
    """Weighted residuals (..., N, 4), the analytic Jacobian
    (..., N, 4, 6) and the unweighted predictions (..., N, 4)."""
    predict, Xc = stereo_predict(tr, X, calib)
    w = _weights(observe, calib)

    dR = rotation_derivatives(tr[..., :3])                  # (..., 3, 3, 3)
    # (..., N, 3param, 3xyz): dXc/dparam for the rotation parameters
    dXc_rot = torch.einsum("...pij,...nj->...npi", dR, X)
    eye = torch.eye(3, dtype=X.dtype, device=X.device).expand(
        *dXc_rot.shape[:-2], 3, 3)
    dXc = torch.cat([dXc_rot, eye], dim=-2)                 # (..., N, 6, 3)

    Xl, Yl, Zc = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    Xr = Xl - calib.against(Xl.dim()).base
    dX, dY, dZ = dXc[..., 0], dXc[..., 1], dXc[..., 2]      # (..., N, 6)
    Z2 = (Zc * Zc)[..., None]
    f = calib.against(dX.dim()).f
    Ju_l = f * (dX * Zc[..., None] - Xl[..., None] * dZ) / Z2
    Jv_l = f * (dY * Zc[..., None] - Yl[..., None] * dZ) / Z2
    Ju_r = f * (dX * Zc[..., None] - Xr[..., None] * dZ) / Z2
    J = torch.stack([Ju_l, Jv_l, Ju_r, Jv_l], dim=-2)       # (..., N, 4, 6)

    wv = w[..., None]
    return (observe - predict) * wv, J * wv[..., None], predict


def reprojection_errors_sq(tr, X, observe, calib: Calib):
    """Unweighted squared reprojection error summed over the 4 components
    (the RANSAC inlier score)."""
    predict, _ = stereo_predict(tr, X, calib)
    return ((observe - predict) ** 2).sum(-1)


def _tree_sum(x, dim):
    """Sum of x along ``dim`` by a fixed tree of elementwise additions:
    halve the axis while its length is even, then add what is left in
    order.  Each output element sees the same additions in the same order
    whatever the other axes hold, which no library reduction or matrix
    product promises: a card's matmul picks its summation (split-K or not)
    from the whole call's shape, and a lane's sum then moves in its last
    bits with the batch it is in."""
    n = x.shape[dim]
    while n > 1 and n % 2 == 0:
        n //= 2
        x = x.narrow(dim, 0, n) + x.narrow(dim, n, n)
    out = x.select(dim, 0)
    for i in range(1, n):
        out = out + x.select(dim, i)
    return out


# Sums of at most this many rows (the 12-row sums of the 3-point hypothesis
# fits) keep J' W J as one matrix product: every output element of so short
# a product is one thread's loop over the rows, whatever the batch.  That
# is what the card does, not what the library promises, so
# tools/batch_invariance.py and every serving-equals-solo check hold it.
# J' W r as a product of its own, a matrix times a vector, was summed
# differently in a batch than alone: it is added up elementwise.  Any
# elementwise order is batch-invariant; the one below is kept because with
# it the card and the CPU rank near-tied hypotheses alike on chip_smoke.py's
# card-against-CPU frames, where three other orders did not.
_MATMUL_ROWS = 64


def _normal_equations(J, r, weights):
    """(A, b) = (J' W J, J' W r) over the point and component axes of
    J (..., N, 4, 6) and r (..., N, 4), with W the active-set weights
    (..., N), such that a lane's sums do not depend on the batch it is in:
    long sums (the refit over every slot) go through ``_tree_sum``; short
    ones are a matrix product for A and, for b, each point's four
    components added in pairs and then the points in order."""
    # r and J carry the centre weight; the active-set mask goes on one
    # factor so excluded points contribute exactly zero
    Jw = J * weights[..., None, None]                        # (..., N, 4, 6)
    Jm = Jw.flatten(-3, -2)                                  # (..., 4N, 6)
    if Jm.shape[-2] <= _MATMUL_ROWS:
        A = Jm.transpose(-1, -2) @ J.flatten(-3, -2)
        P = Jw * r[..., None]
        b = _tree_sum((P[..., 0, :] + P[..., 1, :])
                      + (P[..., 2, :] + P[..., 3, :]), -2)
        return A, b
    Jr = torch.cat([J, r[..., None]], dim=-1).flatten(-3, -2)  # (..., 4N, 7)
    Ab = _tree_sum(Jm[..., :, :, None] * Jr[..., :, None, :], -3)
    return Ab[..., :6], Ab[..., 6]


def _solve_spd6(A, b, eps=1e-12):
    """Equilibrated Cholesky solve of the (..., 6, 6) normal equations.

    Returns (step, ok); ``ok`` is False where A is not numerically
    positive definite (``cholesky_ex`` reports it in ``info``) or the step
    is not finite, and the step is then zero.

    A card factorises one matrix and a batch of matrices by different
    routines, which round differently.  One system alone is therefore
    solved as a batch of two copies, so that a solo run's system takes the
    path of a row of a serving batch.
    """
    lead = A.shape[:-2]
    alone = lead.numel() == 1
    if alone:
        A = A.reshape(1, 6, 6).expand(2, 6, 6)
        b = b.reshape(1, 6).expand(2, 6)
    d = torch.sqrt(torch.clamp(torch.diagonal(A, dim1=-2, dim2=-1), min=eps))
    scale = 1.0 / d
    As = A * scale[..., :, None] * scale[..., None, :]
    bs = b * scale
    L, info = torch.linalg.cholesky_ex(As)
    y = torch.linalg.solve_triangular(L, bs[..., None], upper=False)
    x = torch.linalg.solve_triangular(L.transpose(-1, -2), y,
                                      upper=True)[..., 0]
    step = x * scale
    ok = (info == 0) & torch.isfinite(step).all(-1)
    step = torch.where(ok[..., None], step, torch.zeros_like(step))
    if alone:
        return step[0].reshape(*lead, 6), ok[0].reshape(lead)
    return step, ok


class GNResult(NamedTuple):
    tr: torch.Tensor         # (..., 6) final motion estimate
    converged: torch.Tensor  # (...,) bool: step-norm test passed
    iters: torch.Tensor      # (...,) int: iterations executed


def gauss_newton(X, observe, weights, tr0, calib: Calib,
                 cfg: RansacConfig = RansacConfig()) -> GNResult:
    """Masked Gauss-Newton on the weighted stereo reprojection error:
    ``tr += solve(J'J, J'r)`` until max |step| <= ``cfg.converge_thresh``
    or ``cfg.gn_iters`` steps.  X (..., N, 3), observe (..., N, 4),
    weights (..., N) (0 excludes a point exactly), tr0 (..., 6)."""

    def step_fn(tr):
        r, J, _ = residual_jacobian(tr, X, observe, calib)
        A, b = _normal_equations(J, r, weights)
        if cfg.gn_lm_lambda > 0.0:
            diag = torch.diagonal(A, dim1=-2, dim2=-1)
            A = A + cfg.gn_lm_lambda * torch.diag_embed(diag)
        step, ok = _solve_spd6(A, b)
        return tr + step, step.abs().amax(-1) <= cfg.converge_thresh, ~ok

    tr = tr0
    batch = tr0.shape[:-1]
    converged = torch.zeros(batch, dtype=torch.bool, device=tr0.device)
    failed = torch.zeros_like(converged)
    it = torch.zeros(batch, dtype=torch.int32, device=tr0.device)

    def active():
        return ~(converged | failed) & (it < cfg.gn_iters)

    while bool(active().any()):  # one host sync per gn_unroll steps
        for _ in range(cfg.gn_unroll):
            act = active()
            tr_n, conv_n, failed_n = step_fn(tr)
            tr = torch.where(act[..., None], tr_n, tr)
            converged = torch.where(act, conv_n, converged)
            failed = torch.where(act, failed_n, failed)
            it = torch.where(act, it + 1, it)
    return GNResult(tr=tr, converged=converged & ~failed, iters=it)
