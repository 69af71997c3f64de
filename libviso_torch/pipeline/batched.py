"""Frame-batched stereo odometry (port of ``libviso_tpu/pipeline/batched.py``).

The only sequential dependency of stereo VO is the final pose chain:
detection, description, stereo matching and the temporal matching between
consecutive frames are independent once the image stack is in memory.
This module processes a whole (T, H, W) window of frames in batched calls:

  - detect/describe: one call on the 2T images,
  - stereo matches: one matcher call on T problems (on the card one launch
    of the backend's kernel); temporal matches: one call on the 2(T-1)
    problems of the T-1 transitions (features of frame t against frame
    t-1 by offset slicing),
  - triangulation and the circle filter over (T, N) tensors,
  - one batched RANSAC + Gauss-Newton solve over the T-1 transitions.

It is the throughput mode; the streaming step of ``pipeline/stereo.py``
serves the online case.  Given the same RANSAC draws, frames 1..T-1 have
the streaming run's discrete stats.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from libviso_torch.config import Calib, PipelineConfig
from libviso_torch.geometry.triangulate import triangulate_rectified
from libviso_torch.ops.circle import circle_filter
from libviso_torch.ops.features import detect_and_describe
from libviso_torch.ops.matching import match_problem_batch
from libviso_torch.pipeline.stereo import check_supported, match_layout
from libviso_torch.solvers.ransac import ransac_pose


class BatchedOutput(NamedTuple):
    motions: torch.Tensor      # (T, 6): motion t-1 -> t; row 0 is zeros
    ok: torch.Tensor           # (T,) bool; row 0 False
    num_circle: torch.Tensor   # (T,) int
    num_inliers: torch.Tensor  # (T,) int
    num_lr: torch.Tensor       # (T,) int


class TrackData(NamedTuple):
    """Front-end tensors needed to build bundle-adjustment windows."""

    kp1_xy: torch.Tensor        # (T, N, 2)
    kp2_xy: torch.Tensor        # (T, N, 2)
    kp1_valid: torch.Tensor     # (T, N)
    kp2_valid: torch.Tensor     # (T, N)
    mlr_idx: torch.Tensor       # (T, N)
    mlr_valid: torch.Tensor     # (T, N)
    m11_idx: torch.Tensor       # (T-1, N) frame t+1 -> t left matches
    m11_valid: torch.Tensor     # (T-1, N)
    circ_valid: torch.Tensor    # (T-1, N) circle-consistent transitions
    X: torch.Tensor             # (T, N, 3) camera-local triangulations
    # left-view descriptors and Harris responses, for keyframe summaries
    d1: torch.Tensor            # (T, N, D)
    kp1_response: torch.Tensor  # (T, N)


def tracks_from_jax(tracks, device="cpu") -> TrackData:
    """The port's TrackData from the JAX package's (any array leaves with
    the same field names): indices as int64, masks as bool, the rest as
    float32, on ``device``.  A test builds both packages' BA windows from
    one front-end output with it."""
    def leaf(x):
        a = np.array(x)
        t = torch.from_numpy(a)
        if a.dtype.kind in "iu":
            t = t.long()
        elif a.dtype.kind == "f":
            t = t.float()
        return t.to(device)

    return TrackData(*(leaf(getattr(tracks, name))
                       for name in TrackData._fields))


def build_batched_odometry(calib: Calib, F, cfg: PipelineConfig,
                           backend: str = "dense",
                           with_tracks: bool = False):
    """Build fn(ims1 (T, H, W), ims2 (T, H, W), gumbels) -> BatchedOutput.

    ``gumbels`` is the (T-1, num_hypotheses, num_slots) RANSAC draws, row
    t-1 for the transition into frame t (the streaming run's draw for
    frame t).  ``F`` is the (3, 3) fundamental matrix on the images'
    device, ``backend`` the matcher route.  ``with_tracks=True``
    additionally returns a TrackData.
    """
    if cfg.keep_features_on_failure:
        # all frame pairs match in parallel here; holding a failed frame's
        # predecessor is sequential state
        raise ValueError(
            "keep_features_on_failure is a streaming-step feature; the "
            "batched/DP/windowed drivers match all frame pairs in "
            "parallel and cannot hold state across a failure")
    check_supported(cfg, backend)
    n_slots = cfg.detector.num_slots
    stereo_cfg = cfg.stereo_match
    temporal_cfg = cfg.temporal_match

    def take(x, idx):   # x[t, idx[t], :] per frame
        return torch.take_along_dim(x, idx[..., None], dim=-2)

    def fn(ims1, ims2, gumbels):
        T = ims1.shape[0]
        dev = ims1.device
        width = ims1.shape[-1]
        layout = match_layout(cfg, width)
        # all 2T detections as one batch
        kps, ds = detect_and_describe(torch.cat([ims1, ims2]), cfg.detector)
        kp1 = type(kps)(*(x[:T] for x in kps))
        kp2 = type(kps)(*(x[T:] for x in kps))
        d1, d2 = ds[:T], ds[T:]

        # the window's match problems as two homogeneous batches (each
        # shares radius and metric): T stereo and 2(T-1) temporal problems
        # in two matcher calls instead of 3T-2
        def flags(n, value, dtype=torch.bool):
            return torch.full((n,), value, dtype=dtype, device=dev)

        mlr = match_problem_batch(
            kp1.xy, kp1.valid, d1, kp2.xy, kp2.valid, d2,
            use_epi=flags(T, stereo_cfg.use_epipolar),
            use_rat=flags(T, stereo_cfg.use_ratio),
            ratios=flags(T, stereo_cfg.ratio, d1.dtype),
            radius=stereo_cfg.radius,
            sampson_thresh=stereo_cfg.sampson_thresh,
            metric=stereo_cfg.metric, F=F, backend=backend, layout=layout,
            image_width=width)

        Tm = 2 * (T - 1)
        tm = match_problem_batch(
            torch.cat([kp1.xy[1:], kp2.xy[1:]]),
            torch.cat([kp1.valid[1:], kp2.valid[1:]]),
            torch.cat([d1[1:], d2[1:]]),
            torch.cat([kp1.xy[:-1], kp2.xy[:-1]]),
            torch.cat([kp1.valid[:-1], kp2.valid[:-1]]),
            torch.cat([d1[:-1], d2[:-1]]),
            use_epi=flags(Tm, False),
            use_rat=flags(Tm, temporal_cfg.use_ratio),
            ratios=flags(Tm, temporal_cfg.ratio, d1.dtype),
            radius=temporal_cfg.radius,
            sampson_thresh=temporal_cfg.sampson_thresh,
            metric=temporal_cfg.metric, F=F, backend=backend,
            layout=layout, image_width=width)
        m11 = type(tm)(*(x[:T - 1] for x in tm))
        m22 = type(tm)(*(x[T - 1:] for x in tm))

        r_safe = torch.clamp(mlr.idx, 0, n_slots - 1)
        obs = torch.cat([kp1.xy, take(kp2.xy, r_safe)], dim=-1)  # (T, N, 4)
        X = triangulate_rectified(obs, calib.f, calib.base, calib.cu,
                                  calib.cv)

        circ = circle_filter(mlr.idx[1:], mlr.idx[:-1], m11.idx, m22.idx)
        lp_safe = torch.clamp(circ.left_prev, 0, n_slots - 1)
        Xp = take(X[:-1], lp_safe)
        prev_valid = torch.gather(mlr.valid[:-1], -1, lp_safe)
        pts_valid = circ.valid & prev_valid & mlr.valid[1:]

        # the T-1 transitions: one batched solve
        est = ransac_pose(Xp, obs[1:], pts_valid, calib, cfg.ransac,
                          gumbel=gumbels)
        ok_t = est.ok & (circ.count >= cfg.min_circle_matches)
        tr_t = torch.where(ok_t[:, None], est.tr, torch.zeros_like(est.tr))

        def lead(x):   # frame 0 has no transition: a zero row
            return torch.cat([torch.zeros_like(x[:1]), x])

        out = BatchedOutput(
            motions=lead(tr_t), ok=lead(ok_t), num_circle=lead(circ.count),
            num_inliers=lead(est.num_inliers), num_lr=mlr.valid.sum(-1))
        if with_tracks:
            tracks = TrackData(
                kp1_xy=kp1.xy, kp2_xy=kp2.xy,
                kp1_valid=kp1.valid, kp2_valid=kp2.valid,
                mlr_idx=mlr.idx, mlr_valid=mlr.valid,
                m11_idx=m11.idx, m11_valid=m11.valid,
                circ_valid=circ.valid, X=X,
                d1=d1, kp1_response=kp1.response)
            return out, tracks
        return out

    return fn
