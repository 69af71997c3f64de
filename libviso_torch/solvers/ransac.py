"""Batched RANSAC pose estimation (port of ``libviso_tpu/solvers/ransac.py``).

Every hypothesis is a lane of a batched solve: sample, fit and score all
models at once, refit the best on its support.  Leading batch axes stack
independent problems (streams, window transitions) into the same solve.  Samples are a Gumbel
top-k over the validity mask (a uniform random ``model_size``-subset of
valid points).  The Gumbel scores are an input: the JAX package draws
them with ``jax.random`` under ``fold_in(key, t)``, which torch cannot
reproduce, so tests feed JAX's draws and the pipeline draws from a
``torch.Generator`` seeded from (seed, frame).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from libviso_torch.config import Calib, RansacConfig
from libviso_torch.geometry.procrustes import solve_rigid_motion_horn
from libviso_torch.geometry.se3 import matrix_to_pose_vector
from libviso_torch.geometry.triangulate import triangulate_rectified
from libviso_torch.ops.topk import first_argmax, topk_iterative
from libviso_torch.solvers.gauss_newton import (
    _tree_sum,
    gauss_newton,
    reprojection_errors_sq,
)


class RansacPoseResult(NamedTuple):
    tr: torch.Tensor               # (..., 6) best motion estimate
    inliers: torch.Tensor          # (..., N) bool final support set
    num_inliers: torch.Tensor      # (...) int
    ok: torch.Tensor               # (...) bool
    best_hypothesis: torch.Tensor  # (...) int index (diagnostics)
    rms: torch.Tensor              # (...) reprojection RMS over the support


def sample_gumbel(shape, generator: torch.Generator, dtype=torch.float32):
    """Standard Gumbel draws -log(-log(U)), U uniform in [tiny, 1), on the
    generator's device."""
    u = torch.rand(shape, generator=generator, dtype=dtype,
                   device=generator.device)
    u = torch.clamp(u, min=torch.finfo(dtype).tiny)
    return -torch.log(-torch.log(u))


def frame_generator(seed: int, t: int, *more: int) -> torch.Generator:
    """A CPU generator seeded from (seed, frame): frame t's draws do not
    depend on which frames ran before, and the CPU and the card see the
    same draws.  ``more`` extends the index (a draw that is not a
    frame's, e.g. (seed, 1_000_003, keyframe))."""
    state = np.random.SeedSequence([seed, t, *more]).generate_state(
        2, np.uint32)
    return torch.Generator().manual_seed(
        (int(state[0]) << 31) ^ int(state[1]))


def _take_rows(x, idx):
    """x (..., N, C) gathered at idx (..., H, k) along the point axis ->
    (..., H, k, C)."""
    flat = idx.reshape(*idx.shape[:-2], -1, 1)
    return torch.take_along_dim(x, flat, dim=-2).reshape(
        *idx.shape, x.shape[-1])


def ransac_pose(X, observe, valid, calib: Calib,
                cfg: RansacConfig = RansacConfig(), gumbel=None,
                generator: torch.Generator | None = None
                ) -> RansacPoseResult:
    """Estimate the 6-dof motion from 3D-to-stereo correspondences.

    Every argument may carry the same leading batch axes (the streams of a
    serving step, the transitions of a window): each row is then one
    independent problem, all rows run as one batched solve, and the result
    has the same leading axes.  A row's result does not depend on the rows
    it shares the batch with; the unbatched call is the batch of none.

    Args:
      X: (..., N, 3) previous-frame 3D points (padded slots allowed).
      observe: (..., N, 4) current-frame observations (u_l, v_l, u_r, v_r).
      valid: (..., N) bool mask of real correspondences.
      calib: the calibration, floats or one value per batch row
        (``config.Calib``).
      cfg: RANSAC configuration.
      gumbel: optional (..., num_hypotheses, N) Gumbel scores; else drawn
        from ``generator`` (unbatched calls only) and moved to X's device.
    """
    N = X.shape[-2]
    lead = X.shape[:-2]
    H = cfg.num_hypotheses
    dtype = X.dtype
    if gumbel is None:
        if generator is None:
            raise ValueError("ransac_pose needs gumbel or a generator")
        gumbel = sample_gumbel((*lead, H, N), generator, dtype)
    gumbel = gumbel.to(device=X.device, dtype=dtype)
    calib = calib.on(X.device)

    scores = torch.where(valid[..., None, :], gumbel,
                         torch.full_like(gumbel, float("-inf")))
    _, sample_idx = topk_iterative(scores, cfg.model_size)   # (..., H, k)
    Xs = _take_rows(X, sample_idx)                           # (..., H, k, 3)
    obs_s = _take_rows(observe, sample_idx)                  # (..., H, k, 4)
    w_s = torch.ones((*lead, H, cfg.model_size), dtype=dtype,
                     device=X.device)
    if cfg.hypothesis_method == "procrustes":
        # closed-form 3D-3D alignment of the previous points onto the
        # triangulated current points, then a short image-space polish
        Xc = triangulate_rectified(observe, calib.f, calib.base, calib.cu,
                                   calib.cv)
        T = solve_rigid_motion_horn(_take_rows(Xc, sample_idx), Xs)
        tr0 = matrix_to_pose_vector(T).to(dtype)
        fit_cfg = dataclasses.replace(
            cfg, gn_iters=min(cfg.fit_gn_iters, cfg.gn_iters,
                              cfg.procrustes_polish_iters))
        hyp_tr = gauss_newton(Xs, obs_s, w_s, tr0, calib, fit_cfg).tr
        # a non-converged polish still carries a usable closed-form model
        hyp_converged = torch.ones((*lead, H), dtype=torch.bool,
                                   device=X.device)
    else:
        tr0 = torch.zeros((*lead, H, 6), dtype=dtype, device=X.device)
        fit_cfg = dataclasses.replace(
            cfg, gn_iters=min(cfg.fit_gn_iters, cfg.gn_iters))
        fit = gauss_newton(Xs, obs_s, w_s, tr0, calib, fit_cfg)
        hyp_tr, hyp_converged = fit.tr, fit.converged

    err2 = reprojection_errors_sq(hyp_tr, X[..., None, :, :],
                                  observe[..., None, :, :], calib)
    thr2 = cfg.inlier_threshold ** 2
    inl = (err2 < thr2) & valid[..., None, :] & hyp_converged[..., None]
    # the largest support, the lowest index among equal counts (as JAX's
    # argmax; torch.argmax does not promise which of several maxima)
    counts = inl.sum(-1)                                      # (..., H)
    best = first_argmax(counts)                               # (...)

    pick = best[..., None, None]
    best_mask = torch.take_along_dim(inl, pick, dim=-2)[..., 0, :]
    best_tr = torch.take_along_dim(hyp_tr, pick, dim=-2)[..., 0, :]
    refit = gauss_newton(X, observe, best_mask.to(dtype), best_tr, calib,
                         cfg)
    err2_f = reprojection_errors_sq(refit.tr, X, observe, calib)
    final_mask = (err2_f < thr2) & valid
    n_final = final_mask.sum(-1)
    ok = (best_mask.sum(-1) >= cfg.min_inliers) & refit.converged
    # a fixed tree of additions, so that a row's rms is the same in any
    # batch (a library sum rounds a row differently with the batch)
    rms = torch.sqrt(_tree_sum(torch.where(final_mask, err2_f, 0.0), -1)
                     / torch.clamp(n_final, min=1))
    return RansacPoseResult(tr=refit.tr, inliers=final_mask,
                            num_inliers=n_final, ok=ok,
                            best_hypothesis=best, rms=rms.to(dtype))
