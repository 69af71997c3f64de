"""Dense gated descriptor matching (port of ``libviso_tpu/ops/matching.py``,
dense path).

A keypoint in view 1 matches its minimum-distance neighbour among view-2
keypoints within an L1 position radius, subject to the validity gate, the
Sampson gate (<= thresh, non-finite rejected) and the ratio test
(best < second * ratio); exact distance ties keep the first index.

The descriptor distance is 'l2' (``torch.matmul`` on either device) or
'l1'.  For 'l1' the device decides: a CUDA tensor runs the hand-written
kernel (``ops/cuda_matching.py``), a CPU tensor its plain version.  The
JAX package's ``backend`` choice is not carried over.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from libviso_torch.config import MatchConfig
from libviso_torch.geometry.mvg import sampson_distance
from libviso_torch.ops.cuda_matching import (
    l1_distance_matrix,
    l1_distance_matrix_plain,
)
from libviso_torch.ops.features import Keypoints


class MatchResult(NamedTuple):
    """Per-slot matches: view-1 slot i -> view-2 slot ``idx[i]``."""

    idx: torch.Tensor    # (..., N1) int64, -1 where unmatched
    dist: torch.Tensor   # (..., N1) float distance (inf if none)
    valid: torch.Tensor  # (..., N1) bool


def check_match_supported(cfg: MatchConfig):
    """Raise for matcher options the port does not run yet."""
    todo = "ROADMAP.md Queue 1 item 14 (matcher variants)"
    if cfg.banded:
        raise NotImplementedError(
            f"the strip-banded matcher is not ported yet: {todo}")
    if cfg.metric == "l2q8":
        raise NotImplementedError(f"metric 'l2q8' is not ported yet: {todo}")
    if cfg.metric not in ("l1", "l2"):
        raise ValueError(f"unknown metric {cfg.metric!r}")


# the plain all-pairs L1 distance, under the name of the JAX function it
# ports (the kernel's reference)
_l1_desc_dist_xla = l1_distance_matrix_plain


def _l2_desc_dist(d1, d2):
    """All-pairs true L2 distance via ||a||^2 + ||b||^2 - 2 a.b, clamped at
    zero: (..., N1, D) x (..., N2, D) -> (..., N1, N2)."""
    cross = torch.matmul(d1, d2.transpose(-1, -2))
    n1 = (d1 * d1).sum(-1)
    n2 = (d2 * d2).sum(-1)
    sq = torch.clamp(n1[..., :, None] + n2[..., None, :] - 2.0 * cross,
                     min=0.0)
    return torch.sqrt(sq)


def descriptor_distances(d1, d2, metric="l1"):
    """All-pairs descriptor distance matrix under ``metric``."""
    check_match_supported(MatchConfig(metric=metric))
    if metric == "l2":
        return _l2_desc_dist(d1, d2)
    return l1_distance_matrix(d1, d2)


def _gates(q_xy, q_valid, t_xy, t_valid, radius):
    """(..., N1, N2) position-radius (strict <) and validity gates."""
    pos_l1 = ((q_xy[..., :, None, 0] - t_xy[..., None, :, 0]).abs()
              + (q_xy[..., :, None, 1] - t_xy[..., None, :, 1]).abs())
    return (pos_l1 < radius) & q_valid[..., :, None] & t_valid[..., None, :]


def _epipolar_ok(F, q_xy, t_xy, sampson_thresh):
    s = sampson_distance(F, q_xy[..., :, None, :], t_xy[..., None, :, :])
    return torch.isfinite(s) & (s <= sampson_thresh)


def gated_distance_matrix(kp1: Keypoints, d1, kp2: Keypoints, d2,
                          cfg: MatchConfig, F=None):
    """(N1, N2) descriptor-distance matrix with all gates applied (inf
    where a gate fails)."""
    check_match_supported(cfg)
    ok = _gates(kp1.xy, kp1.valid, kp2.xy, kp2.valid, cfg.radius)
    if cfg.use_epipolar:
        if F is None:
            raise ValueError("epipolar gating requires F")
        ok &= _epipolar_ok(F, kp1.xy, kp2.xy, cfg.sampson_thresh)
    dd = descriptor_distances(d1, d2, metric=cfg.metric)
    return torch.where(ok, dd, torch.full_like(dd, float("inf")))


def two_smallest(dd):
    """Row-wise (best, second_best, argmin) along the last axis; ties go
    to the first index."""
    best_idx = torch.argmin(dd, dim=-1, keepdim=True)
    best = torch.gather(dd, -1, best_idx)[..., 0]
    second = dd.scatter(-1, best_idx, float("inf")).amin(-1)
    return best, second, best_idx[..., 0]


def finalize_match(best, second, best_idx, kp1_valid,
                   cfg: MatchConfig) -> MatchResult:
    """Apply the ratio test + validity and build the MatchResult."""
    valid = torch.isfinite(best) & kp1_valid
    if cfg.use_ratio:
        valid &= best < second * cfg.ratio
    return MatchResult(
        idx=torch.where(valid, best_idx, -1),
        dist=torch.where(valid, best, torch.full_like(best, float("inf"))),
        valid=valid)


def match_problem_batch(q_xy, q_valid, q_d, t_xy, t_valid, t_d,
                        use_epi, use_rat, ratios, radius, sampson_thresh,
                        metric, F) -> MatchResult:
    """A stack of B gated match problems, (B, N, ...) inputs -> a
    MatchResult of (B, N) tensors.

    All problems share radius, metric and Sampson threshold; the Sampson
    and ratio gates are per problem (``use_epi``/``use_rat`` (B,) bool,
    ``ratios`` (B,)).  The descriptor distances of all B problems are one
    call, so on the card one kernel launch.
    """
    ok = _gates(q_xy, q_valid, t_xy, t_valid, radius)
    epi_ok = _epipolar_ok(F, q_xy, t_xy, sampson_thresh)
    ok &= torch.where(use_epi[:, None, None], epi_ok, True)
    dd = descriptor_distances(q_d, t_d, metric=metric)
    dd = torch.where(ok, dd, torch.full_like(dd, float("inf")))
    best, second, bidx = two_smallest(dd)
    valid = torch.isfinite(best) & q_valid
    valid &= torch.where(use_rat[:, None], best < second * ratios[:, None],
                         True)
    return MatchResult(
        idx=torch.where(valid, bidx, -1),
        dist=torch.where(valid, best, torch.full_like(best, float("inf"))),
        valid=valid)


def match_frame_triple(kp1: Keypoints, d1, kp2: Keypoints, d2,
                       kp1p: Keypoints, d1p, kp2p: Keypoints, d2p,
                       stereo: MatchConfig, temporal: MatchConfig, F):
    """The per-frame match workload: LR stereo (epipolar-gated), left
    temporal and right temporal (ratio-tested), as one 3-problem batch
    when the two configs share radius and metric, else three calls.

    Returns (match_lr, match_11, match_22).
    """
    if temporal.use_epipolar:
        raise ValueError(
            "temporal_match.use_epipolar is unsupported: no fundamental "
            "matrix exists for unknown frame-to-frame motion")
    check_match_supported(stereo)
    check_match_supported(temporal)
    if (stereo.radius != temporal.radius
            or stereo.metric != temporal.metric):
        return (match_descriptors(kp1, d1, kp2, d2, stereo, F=F),
                match_descriptors(kp1, d1, kp1p, d1p, temporal),
                match_descriptors(kp2, d2, kp2p, d2p, temporal))

    dev = d1.device
    res = match_problem_batch(
        q_xy=torch.stack([kp1.xy, kp1.xy, kp2.xy]),
        q_valid=torch.stack([kp1.valid, kp1.valid, kp2.valid]),
        q_d=torch.stack([d1, d1, d2]),
        t_xy=torch.stack([kp2.xy, kp1p.xy, kp2p.xy]),
        t_valid=torch.stack([kp2.valid, kp1p.valid, kp2p.valid]),
        t_d=torch.stack([d2, d1p, d2p]),
        use_epi=torch.tensor([stereo.use_epipolar, False, False],
                             device=dev),
        use_rat=torch.tensor([stereo.use_ratio, temporal.use_ratio,
                              temporal.use_ratio], device=dev),
        ratios=torch.tensor([stereo.ratio, temporal.ratio, temporal.ratio],
                            dtype=d1.dtype, device=dev),
        radius=stereo.radius, sampson_thresh=stereo.sampson_thresh,
        metric=stereo.metric, F=F)
    return tuple(MatchResult(*(x[i] for x in res)) for i in range(3))


def match_descriptors(kp1: Keypoints, d1, kp2: Keypoints, d2,
                      cfg: MatchConfig = MatchConfig(),
                      F=None) -> MatchResult:
    """Match view-1 keypoints to view-2 keypoints (one match per slot);
    ``cfg.use_epipolar`` requires the (3, 3) fundamental matrix ``F``."""
    dd = gated_distance_matrix(kp1, d1, kp2, d2, cfg, F=F)
    best, second, best_idx = two_smallest(dd)
    return finalize_match(best, second, best_idx, kp1.valid, cfg)
