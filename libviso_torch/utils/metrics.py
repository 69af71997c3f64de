"""Trajectory evaluation (ATE/RPE) and structured per-frame metrics.

A numpy port of ``libviso_tpu/utils/metrics.py`` (that package's import
pulls in JAX).

The reference never evaluates its trajectories (it writes KITTI devkit
format and defers to the external devkit, src/kitti.cpp:49-64,100);
BASELINE.md requires ATE/RPE in-repo, so the build provides them.  Logging
follows SURVEY.md §5.5: structured per-frame metrics to JSONL instead of
Boost.Log text.
"""

from __future__ import annotations

import json
import os
from typing import IO, Optional

import numpy as np


def align_trajectory(est_t, gt_t, with_scale: bool = False):
    """Umeyama/Horn closed-form alignment of trajectory translations.

    Finds (s, R, t) minimizing ``sum ||gt_i - (s R est_i + t)||^2`` over
    rigid motions (``with_scale=False``, SE(3)) or similarities
    (``with_scale=True``, Sim(3) — the right gauge for monocular
    trajectories, whose global scale is unobservable).

    Returns (s, R, t) with R (3,3), t (3,).
    """
    est = np.asarray(est_t, np.float64)
    gt = np.asarray(gt_t, np.float64)
    mu_e = est.mean(axis=0)
    mu_g = gt.mean(axis=0)
    ec = est - mu_e
    gc = gt - mu_g
    C = gc.T @ ec / len(est)
    U, D, Vt = np.linalg.svd(C)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    if with_scale:
        var_e = np.mean(np.sum(ec * ec, axis=-1))
        s = float(np.trace(np.diag(D) @ S) / var_e) if var_e > 0 else 1.0
    else:
        s = 1.0
    t = mu_g - s * R @ mu_e
    return s, R, t


def ate_rmse(poses_est, poses_gt, align: str = "none") -> float:
    """Absolute trajectory error: RMSE of translation differences.

    ``align='none'`` (default) compares raw translations under the
    shared-origin convention (frame 0 identity) — matching how the
    reference's output would be compared against KITTI ground truth.
    ``align='se3'`` applies closed-form Horn/Umeyama SE(3) alignment
    first (devkit-comparable on real data); ``align='sim3'`` also solves
    the scale — the right gauge for monocular trajectories.
    """
    est = np.asarray(poses_est)[:, :3, 3]
    gt = np.asarray(poses_gt)[:, :3, 3]
    assert est.shape == gt.shape, (est.shape, gt.shape)
    if align not in ("none", "se3", "sim3"):
        raise ValueError(f"align must be none|se3|sim3, got {align!r}")
    if align != "none":
        s, R, t = align_trajectory(est, gt, with_scale=(align == "sim3"))
        est = s * est @ R.T + t
    return float(np.sqrt(np.mean(np.sum((est - gt) ** 2, axis=-1))))


def rpe_errors(poses_est, poses_gt, delta: int = 1):
    """Relative pose error over a frame gap ``delta``.

    Returns (trans_errors, rot_errors) arrays: per-step translation error
    magnitude [m] and rotation angle error [rad].
    """
    est = np.asarray(poses_est)
    gt = np.asarray(poses_gt)
    T = len(est)
    terr, rerr = [], []
    for i in range(T - delta):
        d_est = np.linalg.inv(est[i]) @ est[i + delta]
        d_gt = np.linalg.inv(gt[i]) @ gt[i + delta]
        e = np.linalg.inv(d_gt) @ d_est
        terr.append(np.linalg.norm(e[:3, 3]))
        c = (np.trace(e[:3, :3]) - 1.0) / 2.0
        rerr.append(float(np.arccos(np.clip(c, -1.0, 1.0))))
    return np.asarray(terr), np.asarray(rerr)


def kitti_trajectory_errors(poses_est, poses_gt, lengths=(100, 200, 300, 400,
                                                          500, 600, 700, 800)):
    """KITTI devkit-style averaged translational/rotational errors.

    For each start frame and each path length, find the frame reaching that
    driven distance in the ground truth and measure the relative-pose error
    normalized by length.  Returns dict with percent translation error and
    rot error [deg/m], averaged over all (start, length) pairs in range.
    """
    est = np.asarray(poses_est)
    gt = np.asarray(poses_gt)
    # cumulative driven distance along ground truth
    step = np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=-1)
    dist = np.concatenate([[0.0], np.cumsum(step)])
    t_errs, r_errs = [], []
    for first in range(0, len(gt), 10):
        for length in lengths:
            target = dist[first] + length
            later = np.nonzero(dist >= target)[0]
            if len(later) == 0:
                continue
            last = int(later[0])
            d_est = np.linalg.inv(est[first]) @ est[last]
            d_gt = np.linalg.inv(gt[first]) @ gt[last]
            e = np.linalg.inv(d_gt) @ d_est
            t_errs.append(np.linalg.norm(e[:3, 3]) / length)
            c = (np.trace(e[:3, :3]) - 1.0) / 2.0
            r_errs.append(np.degrees(np.arccos(np.clip(c, -1, 1))) / length)
    if not t_errs:
        return {"t_err_pct": float("nan"), "r_err_deg_per_m": float("nan"),
                "num_segments": 0}
    return {
        "t_err_pct": float(np.mean(t_errs) * 100.0),
        "r_err_deg_per_m": float(np.mean(r_errs)),
        "num_segments": len(t_errs),
    }


def health_summary(stats, frame_ok, support_ratio_alarm: float = 0.72,
                   motion_jump_alarm: float = 0.3) -> dict:
    """Run-level `health` block shared by ALL drivers (VERDICT r4 #4).

    Aggregates per-frame stats into the operator contract of
    docs/operations.md — including the two round-4-calibrated silent-
    failure alarms that were previously computed only inside the mover
    sweep:

      * ``support_ratio_min`` — min over solved frames of
        num_inliers/num_circle.  Fired (< 0.72) on 17/17 locked
        dominant-mover sweep rows (docs/realism.md "Dominant movers");
        also fires at ~99%-saturated exposure.
      * ``motion_jump_max`` — max weighted 6-dof delta between
        consecutive accepted motions (> 0.3 = mode-flipping capture).

    ``alarms`` lists the tripped signals by name so an alert feed can
    key on one field.  Stats lists from modes without a given signal
    (BA/loop modes carry no per-frame sharpness; multistream had no
    motion_jump before r5) yield null for it — keys never disappear.

    Args:
      stats: per-frame stat dicts (frame 0 included; it is skipped for
        inlier/support aggregation like the reference skips frame 0).
      frame_ok: (T,) bool array of per-frame success flags.
      support_ratio_alarm, motion_jump_alarm: thresholds, normally from
        ``HealthConfig`` (config.py).
    """
    sharps = [s["sharpness"] for s in stats if "sharpness" in s]
    body = [s for s in stats[1:] if "num_inliers" in s]
    inls = [s["num_inliers"] for s in body]
    # support ratio only where the frame actually solved: a failed frame
    # reports a meaningless 0/len ratio and would permanently latch the
    # alarm that exists to catch SILENT (ok=true) capture
    sups = [s["num_inliers"] / max(s["num_circle"], 1) for s in body
            if s.get("ok") and s.get("num_circle", 0) > 0]
    jumps = [s["motion_jump"] for s in stats if "motion_jump" in s]
    sup_min = round(min(sups), 3) if sups else None
    jump_max = round(max(jumps), 3) if jumps else None
    alarms = []
    if sup_min is not None and sup_min < support_ratio_alarm:
        alarms.append("support_ratio")
    if jump_max is not None and jump_max > motion_jump_alarm:
        alarms.append("motion_jump")
    frame_ok = np.asarray(frame_ok)
    return {
        "failed_frames": int((~frame_ok[1:]).sum()),
        "sharpness_mean": (round(float(np.mean(sharps)), 5)
                           if sharps else None),
        "sharpness_min": (round(float(np.min(sharps)), 5)
                          if sharps else None),
        "inliers_mean": round(float(np.mean(inls)), 1) if inls else None,
        "support_ratio_min": sup_min,
        "motion_jump_max": jump_max,
        "alarms": alarms,
    }


class MetricsLogger:
    """JSONL metrics sink (SURVEY.md §5.5).

    ``mode='w'`` (default) truncates: per-run sinks like the CLI's
    metrics.jsonl would otherwise double-count frames when a completed
    sequence is rerun (e.g. a checkpointed no-op run).  Pass ``mode='a'``
    for a cross-run accumulating log.
    """

    def __init__(self, path: Optional[str] = None, mode: str = "w"):
        self.path = path
        self._fh: Optional[IO] = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, mode)

    def log(self, record: dict):
        if self._fh:
            self._fh.write(json.dumps(record) + "\n")
            self._fh.flush()

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
