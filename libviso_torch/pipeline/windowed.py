"""Sequence-level sliding-window BA odometry (port of
``libviso_tpu/pipeline/windowed.py``).

Drives the frame-batched front-end (``pipeline/batched.py``) over a
sequence in overlapping windows, refines each window's motions with the
Schur-complement BA (``pipeline/refine.py``) and stitches the refined
relative motions into one trajectory.  Window w covers frames
[w*stride, w*stride + window); consecutive windows share (window - stride)
frames, and the later window's motions win on the overlap, anchored at
the earlier window's by a marginalization prior.

On the card each window is two launches of the matcher backend's kernel
(its W stereo and 2(W-1) temporal problems) and a BA whose iterations make
no host sync; the host reads the window's results once.

Draws: window w's RANSAC draws, (T_w - 1, H, N) Gumbel scores, come from
``frame_generator(seed, w)``, so a resumed run is bit-exact; ``draws``
replaces them (a test seam, through which the JAX package's window draws
are fed).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import numpy as np
import torch

from libviso_torch.config import BAConfig, Calib, PipelineConfig
from libviso_torch.geometry.mvg import F_from_P_host
from libviso_torch.geometry.se3 import chain_motions, pose_vector_to_matrix
from libviso_torch.pipeline.batched import build_batched_odometry
from libviso_torch.pipeline.refine import (
    build_window_problem,
    motion_prior_poses,
    refine_window_motions,
)
from libviso_torch.pipeline.stereo import resolve_device
from libviso_torch.solvers.ransac import frame_generator, sample_gumbel


def _window_fns(calib: Calib, F, cfg: PipelineConfig, backend: str,
                ba_iters: int, outlier_px: float, rerank_px: float,
                holdout_modulus: int, holdout_margin: float):
    """The per-window functions: the front-end with tracks and the
    refinement under the combined priors (the JAX package jit-compiles and
    caches these; here they are plain closures)."""
    front = build_batched_odometry(calib, F, cfg, backend=backend,
                                   with_tracks=True)

    def refine(prob, vo_motions, prior_motions, prior_count, prior_w6,
               vo_prior_w6):
        # the prior poses compose from the overlap prefix's motions (the
        # current VO motions fill the suffix, whose weight is zero)
        Wn = prob.poses0.shape[0]
        pose_prior = motion_prior_poses(vo_motions, prior_motions,
                                        prior_count)
        in_prefix = (torch.arange(Wn, device=prob.poses0.device)
                     < prior_count).to(prob.poses0.dtype)
        weight = in_prefix[:, None] * prior_w6[None, :]
        # a VO-anchor shrinkage prior on every frame pins the directions
        # the reprojection error cannot see; both priors are diagonal
        # quadratics, so they combine exactly: the weights add and the
        # anchors average, weighted per dof
        w_vo = vo_prior_w6[None, :].expand_as(weight)
        w_comb = weight + w_vo
        anchor = torch.where(w_comb > 0,
                             (weight * pose_prior + w_vo * prob.poses0)
                             / w_comb.clamp(min=1e-20),
                             prob.poses0)
        return refine_window_motions(prob, calib, iters=ba_iters,
                                     outlier_px=outlier_px,
                                     rerank_px=rerank_px,
                                     pose_prior=anchor,
                                     prior_weight=w_comb,
                                     holdout_modulus=holdout_modulus,
                                     holdout_margin=holdout_margin)

    return front, refine


def _dump_window_debug(dbg_dir, frames, s, lo, e, tracks):
    """Per-frame debug artifacts of the frames a window contributes:
    corners in both views, the stereo match blend and the temporal
    stacked-match view, from the window's TrackData.  Local indices
    [lo, e-s) are frames [s+lo, e); the overlap frames were dumped by the
    previous window."""
    from libviso_torch.utils import debug_viz as dv

    os.makedirs(dbg_dir, exist_ok=True)
    host = {name: getattr(tracks, name).cpu().numpy() for name in (
        "kp1_xy", "kp2_xy", "kp1_valid", "kp2_valid", "mlr_idx",
        "mlr_valid", "m11_idx", "m11_valid")}
    kp1, kp2 = host["kp1_xy"], host["kp2_xy"]
    p = lambda name: os.path.join(dbg_dir, name)  # noqa: E731
    for li in range(lo, e - s):
        t = s + li
        im1 = np.asarray(frames[t][0])
        im2 = np.asarray(frames[t][1])
        dv.save_corners(im1, kp1[li], p(f"corners1_{t:03d}.jpg"),
                        valid=host["kp1_valid"][li])
        dv.save_corners(im2, kp2[li], p(f"corners2_{t:03d}.jpg"),
                        valid=host["kp2_valid"][li])
        dv.save_match_blend(im1, im2, kp1[li], kp2[li],
                            np.where(host["mlr_valid"][li],
                                     host["mlr_idx"][li], -1),
                            p(f"blend12_{t:03d}.jpg"))
        if li > 0:
            dv.save_stacked_matches(
                im1, np.asarray(frames[t - 1][0]), kp1[li], kp1[li - 1],
                np.where(host["m11_valid"][li - 1],
                         host["m11_idx"][li - 1], -1),
                p(f"temporal_{t:03d}.jpg"))


def window_starts(T, window, stride):
    """Window start indices covering [0, T) (the tail always covered)."""
    starts = list(range(0, max(T - window, 0) + 1, stride))
    if not starts:
        starts = [0]
    if starts[-1] + window < T:
        starts.append(T - window)
    return starts


@dataclasses.dataclass
class WindowedResult:
    poses: np.ndarray       # (T, 4, 4) BA-refined trajectory
    poses_vo: np.ndarray    # (T, 4, 4) front-end-only trajectory
    motions: np.ndarray     # (T, 6) refined motions
    frame_ok: np.ndarray    # (T,)
    # per-window 5-tuples (initial_cost, final_cost, accepted,
    # holdout_half0, holdout_half1); `accepted` is gate-inclusive: solver
    # ok AND (gate off or holdout_gate accepted)
    window_costs: list
    processed: int = 0      # frames computed in this run (not those of
    #                         windows a checkpoint restored)


def _read_window(out, ref):
    """A window's results on the host, in one copy (one sync): the
    refined and VO motions, the VO ok flags and circle counts, the
    per-camera observations and the refinement's scalars (all exact in
    float32)."""
    W = out.motions.shape[0]
    f32 = torch.float32
    flat = torch.cat([
        ref.motions.reshape(-1).to(f32), out.motions.reshape(-1).to(f32),
        out.ok.to(f32), out.num_circle.to(f32), ref.cam_obs.to(f32),
        torch.stack([ref.initial_cost.to(f32), ref.cost.to(f32),
                     ref.ok.to(f32), ref.holdout_ok.to(f32),
                     ref.holdout_half0.to(f32),
                     ref.holdout_half1.to(f32)])]).cpu().numpy()
    refined, vo, rest = flat[:6 * W], flat[6 * W:12 * W], flat[12 * W:]
    return dict(refined=refined.reshape(W, 6), vo=vo.reshape(W, 6),
                vo_ok=rest[:W] > 0, num_circle=rest[W:2 * W].astype(int),
                cam_obs=rest[2 * W:3 * W].astype(int),
                initial_cost=float(rest[3 * W]), cost=float(rest[3 * W + 1]),
                ok=bool(rest[3 * W + 2]), holdout_ok=bool(rest[3 * W + 3]),
                half0=float(rest[3 * W + 4]), half1=float(rest[3 * W + 5]))


def run_windowed_ba(frames, P1, P2, cfg: PipelineConfig = PipelineConfig(),
                    ba: BAConfig = BAConfig(),
                    window: int = None, stride: int = None,
                    ba_iters: int = None,
                    seed: int = 0, backend: str = "dense",
                    checkpoint=None,
                    fingerprint_scope: str = "",
                    outlier_px: float = None, rerank_px: float = None,
                    prior_strength: float = None,
                    vo_prior_strength: float = None,
                    min_cam_obs: int = None,
                    gate: bool = None,
                    holdout_modulus: int = None,
                    gate_margin: float = None,
                    dbg_dir=None,
                    on_window=None,
                    extra_checkpoint=None,
                    device="cuda",
                    draws: Optional[Callable[[int, int], torch.Tensor]] = None
                    ) -> WindowedResult:
    """Stereo VO and sliding-window BA over a whole sequence on ``device``.

    Args:
      frames: list of (left, right) image pairs (host arrays).
      ba: BAConfig with every BA knob; the keyword arguments below
        override single fields where not None.
      window, stride: frames per window and the spacing of their starts
        (stride < window overlaps them; stride > window raises).
      seed: derives window w's draws, ``frame_generator(seed, w)``.
      backend: the matcher route, "dense", "fused" or "sweep".
      checkpoint: optional ``utils.checkpoint.CheckpointManager``; the
        progress is saved every ``checkpoint.every`` completed windows and
        a run resumes after the last one, bit-exact.  The fingerprint
        covers cfg, window, stride, iterations, seed, backend, the BA
        knobs and ``fingerprint_scope``.
      outlier_px, rerank_px: the two observation gates of the refinement.
      prior_strength: scale of the cross-window marginalization prior
        (window w's overlap motions are anchored at window w-1's refined
        ones; 0 makes the windows independent).
      vo_prior_strength: scale of the VO-anchor prior on every frame.
      min_cam_obs: observations a camera needs after the gates for its
        adjacent motions to take the refinement.
      gate, holdout_modulus, gate_margin: the per-window acceptance gate
        (``pipeline/refine.py::holdout_gate``); a rejected window keeps
        its VO motions.
      dbg_dir: write the per-frame debug artifacts here.
      on_window: optional callback ``(w, s, e, tracks, motions, oks)``
        after window w's motions are stitched and before its snapshot
        (``pipeline/ba_loop.py`` offers keyframes there); ``motions`` and
        ``oks`` are the live host arrays.
      extra_checkpoint: optional object with ``leaves()``, ``stats()`` and
        ``restore(leaves, stats, next_window)``: more state saved and
        restored with the window progress (the loop engine's store).
      draws: optional callable ``(w, n) -> (n, H, N)`` Gumbel scores for
        the n transitions of window w (a test seam).
    """
    device = resolve_device(device)
    window = ba.window if window is None else window
    stride = ba.stride if stride is None else stride
    ba_iters = ba.iters if ba_iters is None else ba_iters
    outlier_px = ba.outlier_px if outlier_px is None else outlier_px
    rerank_px = ba.rerank_px if rerank_px is None else rerank_px
    if prior_strength is None:
        prior_strength = ba.prior_strength
    if vo_prior_strength is None:
        vo_prior_strength = ba.vo_prior_strength
    min_cam_obs = ba.min_cam_obs if min_cam_obs is None else min_cam_obs
    gate = ba.gate if gate is None else gate
    if holdout_modulus is None:
        holdout_modulus = ba.holdout_modulus
    gate_margin = ba.gate_margin if gate_margin is None else gate_margin
    if stride > window:
        # starts would pass window ends, leaving frames no window covers
        # (their motions zero): a corrupt trajectory reported as success
        raise ValueError(
            f"stride ({stride}) must be <= window ({window}): larger "
            "strides leave frames covered by no BA window")
    frames = list(frames)
    T = len(frames)
    calib = Calib.from_projections(P1, P2)
    F = torch.as_tensor(F_from_P_host(P1, P2), dtype=torch.float32,
                        device=device)
    front, refine = _window_fns(
        calib, F, cfg, backend, ba_iters, float(outlier_px),
        float(rerank_px), int(holdout_modulus), float(gate_margin))
    if draws is None:
        shape = (cfg.ransac.num_hypotheses, cfg.detector.num_slots)
        draws = lambda w, n: sample_gumbel(  # noqa: E731
            (n, *shape), frame_generator(seed, w))
    # per-dof prior information [px^2 per unit^2]: a rotation dof moves a
    # pixel by ~f px/rad, a translation dof by ~f/Z px/m (Z ~ 15 m), scaled
    # to ~1/3 of the information a window has about a boundary pose
    f2 = calib.f * calib.f
    unit_w6 = torch.tensor(
        [70.0 * f2, 70.0 * f2, 70.0 * f2,
         70.0 * f2 / 225.0, 70.0 * f2 / 225.0, 70.0 * f2 / 225.0],
        dtype=torch.float32)
    prior_w6 = (prior_strength * unit_w6).to(device)
    vo_prior_w6 = (vo_prior_strength * unit_w6).to(device)

    # each frame goes to the device once while a window holds it, as
    # uint8 (the detector casts on the device); frames behind the current
    # window are dropped, so device memory is O(window)
    dev_cache = {}

    def window_stacks(s, e):
        for i in [i for i in dev_cache if i < s]:
            del dev_cache[i]
        for i in range(s, e):
            if i not in dev_cache:
                dev_cache[i] = tuple(
                    torch.tensor(np.asarray(frames[i][v]), device=device)
                    for v in (0, 1))
        return tuple(torch.stack([dev_cache[i][v] for i in range(s, e)])
                     for v in (0, 1))

    motions = np.zeros((T, 6), np.float32)
    oks = np.zeros((T,), bool)
    motions_vo = np.zeros((T, 6), np.float32)
    window_costs = []
    starts = window_starts(T, window, stride)

    w0 = 0
    fingerprint = None
    if checkpoint is not None:
        from libviso_torch.utils.checkpoint import (
            Checkpoint,
            config_fingerprint,
        )

        fingerprint = config_fingerprint(
            cfg, seed, backend,
            scope=f"ba:{window}:{stride}:{ba_iters}:T{T}:"
                  f"p{prior_strength}:v{vo_prior_strength}:"
                  f"o{outlier_px}:r{rerank_px}:"
                  f"c{min_cam_obs}:g{int(gate)}h{holdout_modulus}"
                  f"x{gate_margin}:{fingerprint_scope}")
        ck = checkpoint.latest()
        if ck is not None:
            if ck.fingerprint != fingerprint:
                raise ValueError(
                    "checkpoint fingerprint mismatch (different cfg/"
                    f"window/stride/seed/backend/sequence/scope): "
                    f"{ck.fingerprint} != {fingerprint}")
            if len(ck.motions) != T:
                raise ValueError(
                    f"checkpoint covers {len(ck.motions)} frames but the "
                    f"run has {T}; resume with the same frame list")
            w0 = ck.next_frame            # the next WINDOW index here
            motions = np.array(ck.motions, np.float32)
            oks = np.array(ck.oks, bool)
            motions_vo = np.array(ck.state_leaves[0], np.float32)
            if extra_checkpoint is not None:
                window_costs = [tuple(c) for c in ck.stats[0]]
                extra_checkpoint.restore(ck.state_leaves[1:], ck.stats[1],
                                         w0)
            else:
                window_costs = [tuple(c) for c in ck.stats]

    def snapshot(next_window):
        wc = [list(c) for c in window_costs]
        extra = extra_checkpoint is not None
        checkpoint.save(Checkpoint(
            next_frame=next_window, motions=motions.astype(np.float64),
            oks=oks,
            state_leaves=[motions_vo] + (extra_checkpoint.leaves()
                                         if extra else []),
            stats=[wc, extra_checkpoint.stats()] if extra else wc,
            fingerprint=fingerprint))

    for w, s in enumerate(starts):
        if w < w0:   # restored from the checkpoint
            continue
        e = min(s + window, T)
        ims1, ims2 = window_stacks(s, e)
        out, tracks = front(ims1, ims2, draws(w, e - s - 1).to(device))
        prob = build_window_problem(
            tracks.kp1_xy, tracks.kp2_xy, tracks.mlr_idx, tracks.mlr_valid,
            tracks.m11_idx, tracks.m11_valid, tracks.X, out.motions,
            cfg.detector.num_slots, circ_valid=tracks.circ_valid)
        # the marginalization prior anchors this window's overlap prefix
        # (local i <-> frame s+i, length the previous window's end minus
        # s) at the previous window's refined motions; window 0 has none
        if w > 0:
            prev_e = min(starts[w - 1] + window, T)
            overlap = max(0, min(prev_e - s, e - s))
        else:
            overlap = 0
        prior_count = overlap if prior_strength > 0 else 0
        if dbg_dir is not None:
            _dump_window_debug(dbg_dir, frames, s, overlap, e, tracks)
        ref = refine(prob, out.motions, torch.from_numpy(
            motions[s:e]).to(device), prior_count, prior_w6, vo_prior_w6)
        r = _read_window(out, ref)
        # a motion takes the refinement only when the window converged,
        # the gate accepted it (a clear win over VO) and both cameras of
        # the motion kept enough observations: a weakly observed camera's
        # refined motion can be far off while the window's cost drops
        cam_ok = r["cam_obs"] >= min_cam_obs
        accepted = r["ok"] and (not gate or r["holdout_ok"])
        motion_ok = accepted & cam_ok & np.roll(cam_ok, 1)
        motion_ok[0] = False
        use = np.where(motion_ok[:, None], r["refined"], r["vo"])
        window_costs.append((r["initial_cost"], r["cost"], accepted,
                             r["half0"], r["half1"]))
        # local index 0 is the window's halo frame (no motion)
        motions[s + 1:e] = use[1:]
        motions_vo[s + 1:e] = r["vo"][1:]
        # the refinement vouches only for the motions it replaced; a frame
        # that kept its VO motion keeps its VO flag, and a replaced one
        # needs the front-end to have observed it at all
        constrained = r["num_circle"][1:] >= cfg.min_circle_matches
        oks[s + 1:e] = r["vo_ok"][1:] | (motion_ok[1:] & constrained)
        if on_window is not None:
            # after stitching, before the snapshot: a snapshot that claims
            # window w done must hold what on_window adds for it
            on_window(w, s, e, tracks, motions, oks)
        if checkpoint is not None and (w + 1) % checkpoint.every == 0:
            snapshot(w + 1)

    if checkpoint is not None and window_costs:
        snapshot(len(starts))

    oks[0] = False
    valid = torch.from_numpy(oks)
    poses = chain_motions(pose_vector_to_matrix(torch.from_numpy(motions)),
                          valid).numpy()
    poses_vo = chain_motions(pose_vector_to_matrix(
        torch.from_numpy(motions_vo)), valid).numpy()
    processed = 0 if w0 >= len(starts) else T - starts[w0]
    return WindowedResult(poses=poses, poses_vo=poses_vo, motions=motions,
                          frame_ok=oks, window_costs=window_costs,
                          processed=processed)
