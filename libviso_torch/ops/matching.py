"""Gated descriptor matching (port of ``libviso_tpu/ops/matching.py``).

A keypoint in view 1 matches its minimum-distance neighbour among view-2
keypoints within an L1 position radius, subject to the validity gate, the
Sampson gate (<= thresh, non-finite rejected) and the ratio test
(best < second * ratio); exact distance ties keep the first index.

``backend`` picks one of three routes, as the JAX package's ``backend``
argument does:
- ``"dense"`` (the default): the (N1, N2) distance matrix, then the gates
  and ``two_smallest`` in PyTorch.  The distance is 'l2' or 'l2q8'
  (``torch.matmul`` on either device) or 'l1', for which a CUDA tensor runs
  the hand-written kernel (``ops/cuda_matching.py``) and a CPU tensor its
  plain version.  It is the port's counterpart of both JAX values, "xla"
  and "pallas".  Under 'l2'/'l2q8' with a detector layout and the image
  width, ``match_problem_batch`` scores only the x-strips the position
  gate can reach (the strip-banded matcher, ``MatchConfig.banded``).
- ``"fused"``: gates, L1 distance and the row-wise (best, second,
  argmin) as one fused kernel (``ops/fused_matching.py``), no (N1, N2)
  array stored;
- ``"sweep"``: the same on x-sorted slots, skipping target tiles beyond
  the radius.  Among exactly equal distances the lowest x wins instead of
  the lowest slot.
The fused routes compute L1 only.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from libviso_torch.config import MatchConfig
from libviso_torch.geometry.mvg import sampson_distance
from libviso_torch.ops.cuda_matching import (
    l1_distance_matrix,
    l1_distance_matrix_plain,
)
from libviso_torch.ops.features import Keypoints
from libviso_torch.ops.fused_matching import (
    fused_gated_two_min,
    sorted_fused_two_min,
)

BACKENDS = ("dense", "fused", "sweep")
METRICS = ("l1", "l2", "l2q8")
Q8_SCALE = 8.0


class MatchResult(NamedTuple):
    """Per-slot matches: view-1 slot i -> view-2 slot ``idx[i]``."""

    idx: torch.Tensor    # (..., N1) int64, -1 where unmatched
    dist: torch.Tensor   # (..., N1) float distance (inf if none)
    valid: torch.Tensor  # (..., N1) bool


def check_match_supported(cfg: MatchConfig):
    """Raise ``ValueError`` for an unknown metric."""
    if cfg.metric not in METRICS:
        raise ValueError(f"unknown metric {cfg.metric!r}")


def check_backend(backend: str, metric: str):
    """Raise for an unknown backend, or a fused one under metric 'l2'."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown matcher backend {backend!r}; expected "
                         f"one of {BACKENDS}")
    if backend != "dense" and metric != "l1":
        raise ValueError(
            f"backend {backend!r} runs the fused matcher kernels, which "
            f"compute L1 only; metric {metric!r} needs backend 'dense'")


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


def quantize_q8(d, scale: float = Q8_SCALE):
    """The int8 levels of 'l2q8', ``clamp(round(d / scale), -127, 127)``,
    as float32 (``torch.round`` rounds half to even, as ``jnp.round``)."""
    return torch.clamp(torch.round(d / scale), -127.0, 127.0)


def q8_cross(q1, q2):
    """The integer cross term of quantized descriptors, (..., N1, D) x
    (..., N2, D) -> (..., N1, N2), as a float32 product.  Exact: every
    partial sum is an integer below 2^24 (D 127^2 = 2,064,512 at D = 128,
    6,193,536 at 384), so any summation order gives the int32 sum the JAX
    package's int8 ``dot_general`` gives."""
    return torch.matmul(q1, q2.transpose(-1, -2))


def _l2q8_desc_dist(d1, d2, scale: float = Q8_SCALE):
    """All-pairs L2 distance over int8-quantized descriptors:
    ``scale * sqrt(max(|q1|^2 + |q2|^2 - 2 q1.q2, 0))``.  Every term is an
    exact integer in float32, and the square root is taken in float64 and
    rounded once, which gives the correctly rounded float32 root (the
    CPU's vectorized float32 ``torch.sqrt`` is off by an ulp on some
    inputs).  So the result equals the JAX package's bit for bit, on
    either device and in any batch."""
    q1, q2 = quantize_q8(d1, scale), quantize_q8(d2, scale)
    sq = torch.clamp((q1 * q1).sum(-1)[..., :, None]
                     + (q2 * q2).sum(-1)[..., None, :]
                     - 2.0 * q8_cross(q1, q2), min=0.0)
    return scale * torch.sqrt(sq.double()).float()


def descriptor_distances(d1, d2, metric="l1"):
    """All-pairs descriptor distance matrix under ``metric``."""
    check_match_supported(MatchConfig(metric=metric))
    if metric == "l2":
        return _l2_desc_dist(d1, d2)
    if metric == "l2q8":
        return _l2q8_desc_dist(d1, d2)
    return l1_distance_matrix(d1, d2)


def _gates(q_xy, q_valid, t_xy, t_valid, radius):
    """(..., N1, N2) position-radius (strict <) and validity gates."""
    pos_l1 = ((q_xy[..., :, None, 0] - t_xy[..., None, :, 0]).abs()
              + (q_xy[..., :, None, 1] - t_xy[..., None, :, 1]).abs())
    return (pos_l1 < radius) & q_valid[..., :, None] & t_valid[..., None, :]


def _epipolar_ok(F, q_xy, t_xy, sampson_thresh):
    """(..., N1, N2) Sampson gate; F is (3, 3) or one per leading index."""
    if F.dim() > 2:
        F = F[..., None, :, :]
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


def _fused_two_min(backend, q_xy, q_valid, q_d, t_xy, t_valid, t_d, F,
                  use_epi, sampson_thresh, radius):
    """Row-wise gated (best, second, argmin) by a fused kernel, for inputs
    with any leading dims: (..., N, ...) -> (..., N1) each.  ``F`` is
    (3, 3) or one per leading index, ``use_epi`` a bool tensor that
    broadcasts to the leading dims."""
    lead = q_valid.shape[:-1]
    N1, N2, D = q_valid.shape[-1], t_valid.shape[-1], q_d.shape[-1]
    B = max(1, int(torch.Size(lead).numel()))
    F = F.to(device=q_d.device, dtype=torch.float32)
    fn = fused_gated_two_min if backend == "fused" else sorted_fused_two_min
    best, second, idx = fn(
        q_xy.reshape(B, N1, 2), q_valid.reshape(B, N1),
        q_d.reshape(B, N1, D), t_xy.reshape(B, N2, 2),
        t_valid.reshape(B, N2), t_d.reshape(B, N2, D),
        F.expand(*lead, 3, 3).reshape(B, 3, 3).contiguous(),
        use_epi.to(q_d.device).expand(lead).reshape(B).contiguous(),
        sampson_thresh=sampson_thresh, radius=radius)
    return (best.reshape(*lead, N1), second.reshape(*lead, N1),
            idx.long().reshape(*lead, N1))


def _banded_tables_np(nbx, nby, k, band):
    """Gather tables of the strip-banded matcher (the JAX package's, in
    numpy).  The binned detector's slot (by*nbx + bx)*k + j lies in x-strip
    bx.  Returns (perm (nbx, P) the strip-major slot ids, tidx (nbx,
    (2 band + 1) P) the candidate slot ids of each query strip, dup (same
    shape) True where an edge strip was clamp-duplicated and must be
    masked out)."""
    per = nby * k
    perm = (np.arange(nby * nbx * k)
            .reshape(nby, nbx, k).transpose(1, 0, 2).reshape(nbx, per))
    offs = np.arange(-band, band + 1)
    g = np.arange(nbx)[:, None]
    h = np.clip(g + offs[None, :], 0, nbx - 1)
    dup = (g + offs[None, :]) != h
    tidx = perm[h].reshape(nbx, (2 * band + 1) * per)
    return (perm.astype(np.int32), tidx.astype(np.int32),
            np.repeat(dup, per, axis=1))


def band_of(layout, metric, radius, image_width, num_query):
    """The strips either side a query must see, or None where banding does
    not apply, as the JAX package decides: a layout and width given, a
    metric other than 'l1', strips at least one pixel wide, the binned
    slots within ``num_slots`` and equal to the query count, and a band
    narrower than the image."""
    if layout is None or image_width is None or metric == "l1":
        return None
    nbx, nby, k, n_slots = layout
    sx = image_width // nbx
    if sx < 1 or nbx * nby * k > n_slots or num_query != n_slots:
        return None
    band = -(-int(radius + 2) // sx)   # ceil
    return band if 2 * band + 1 < nbx else None


@functools.lru_cache(maxsize=32)
def banded_tables(layout, band, device):
    """``_banded_tables_np`` as int64 and bool tensors on ``device``, made
    once per (layout, band, device) and kept: no per-frame upload."""
    nbx, nby, k, _ = layout
    perm, tidx, dup = _banded_tables_np(nbx, nby, k, band)
    return (torch.from_numpy(perm).long().to(device),
            torch.from_numpy(tidx).long().to(device),
            torch.from_numpy(dup).to(device))


def _banded_two_min(q_xy, q_valid, q_d, t_xy, t_valid, t_d, F, use_epi,
                    radius, sampson_thresh, metric, layout, band):
    """Row-wise gated (best, second, argmin) of B problems, (B, N, ...)
    inputs, scoring each query strip against the 2 band + 1 strips around
    it only.  Coverage is exact (every pair the position gate admits lies
    in the band), and the band is scanned strip-major, so among exactly
    equal distances the first candidate in strip-major order wins where
    the dense path takes the lowest slot.  Results are scattered back to
    slot order; slots past the detector's (the pad tail) get best inf."""
    perm, tidx, dup = banded_tables(layout, band, str(q_d.device))
    B, n_slots = q_valid.shape
    nbx, M = tidx.shape
    qxy, qv, qd = q_xy[:, perm], q_valid[:, perm], q_d[:, perm]
    txy, td = t_xy[:, tidx], t_d[:, tidx]
    tv = t_valid[:, tidx] & ~dup                        # (B, nbx, M)
    ok = _gates(qxy, qv, txy, tv, radius)               # (B, nbx, P, M)
    if F.dim() > 2:
        F = F[:, None, None]
    s = sampson_distance(F, qxy[..., :, None, :], txy[..., None, :, :])
    epi_ok = torch.isfinite(s) & (s <= sampson_thresh)
    ok &= torch.where(use_epi[:, None, None, None], epi_ok, True)
    dd = descriptor_distances(qd, td, metric=metric)
    dd = torch.where(ok, dd, torch.full_like(dd, float("inf")))
    best_s, second_s, col = two_smallest(dd)            # (B, nbx, P)
    idx_s = torch.gather(tidx.expand(B, nbx, M), -1, col)
    flat = perm.reshape(-1)

    def to_slots(x, fill):
        out = torch.full((B, n_slots), fill, dtype=x.dtype, device=x.device)
        out[:, flat] = x.reshape(B, -1)
        return out

    inf = float("inf")
    return (to_slots(best_s, inf), to_slots(second_s, inf),
            to_slots(idx_s, -1))


def match_problem_batch(q_xy, q_valid, q_d, t_xy, t_valid, t_d,
                        use_epi, use_rat, ratios, radius, sampson_thresh,
                        metric, F, backend="dense", layout=None,
                        image_width=None) -> MatchResult:
    """A stack of B gated match problems, (B, N, ...) inputs -> a
    MatchResult of (B, N) tensors.

    All problems share radius, metric and Sampson threshold; the Sampson
    and ratio gates are per problem (``use_epi``/``use_rat`` (B,) bool,
    ``ratios`` (B,)), and so is F, (3, 3) for all or (B, 3, 3).  The B
    problems are one call, so on the card one kernel launch of the
    backend's kernel.

    ``layout`` = (nbinx, nbiny, k, num_slots) of the binned detector and
    ``image_width`` enable the strip-banded path under 'l2'/'l2q8' where
    ``band_of`` admits it (``pipeline/stereo.py::match_layout``); 'l1'
    keeps the dense path, as in the JAX package.
    """
    check_backend(backend, metric)
    band = band_of(layout, metric, radius, image_width, q_valid.shape[-1])
    if band is not None:
        best, second, bidx = _banded_two_min(
            q_xy, q_valid, q_d, t_xy, t_valid, t_d, F, use_epi, radius,
            sampson_thresh, metric, layout, band)
    elif backend == "dense":
        ok = _gates(q_xy, q_valid, t_xy, t_valid, radius)
        epi_ok = _epipolar_ok(F, q_xy, t_xy, sampson_thresh)
        ok &= torch.where(use_epi[:, None, None], epi_ok, True)
        dd = descriptor_distances(q_d, t_d, metric=metric)
        dd = torch.where(ok, dd, torch.full_like(dd, float("inf")))
        best, second, bidx = two_smallest(dd)
    else:
        best, second, bidx = _fused_two_min(
            backend, q_xy, q_valid, q_d, t_xy, t_valid, t_d, F, use_epi,
            sampson_thresh, radius)
    valid = torch.isfinite(best) & q_valid
    valid &= torch.where(use_rat[:, None], best < second * ratios[:, None],
                         True)
    return MatchResult(
        idx=torch.where(valid, bidx, -1),
        dist=torch.where(valid, best, torch.full_like(best, float("inf"))),
        valid=valid)


def match_frame_triple(kp1: Keypoints, d1, kp2: Keypoints, d2,
                       kp1p: Keypoints, d1p, kp2p: Keypoints, d2p,
                       stereo: MatchConfig, temporal: MatchConfig, F,
                       backend="dense", layout=None, image_width=None):
    """The per-frame match workload: LR stereo (epipolar-gated), left
    temporal and right temporal (ratio-tested), as one 3-problem batch
    when the two configs share radius and metric, else three calls.

    The inputs may carry leading stream dims, (S, N, ...) with F
    (S, 3, 3): the 3 S problems of S streams are then one batch.
    ``layout``/``image_width`` enable the strip-banded path of the batch
    (``match_problem_batch``).

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
        return (match_descriptors(kp1, d1, kp2, d2, stereo, F=F,
                                  backend=backend),
                match_descriptors(kp1, d1, kp1p, d1p, temporal,
                                  backend=backend),
                match_descriptors(kp2, d2, kp2p, d2p, temporal,
                                  backend=backend))

    dev = d1.device
    lead = kp1.valid.shape[:-1]
    n = d1.shape[-2]
    S = int(torch.Size(lead).numel())

    def stack(a, b, c):
        x = torch.stack([a, b, c], dim=len(lead))
        return x.reshape(3 * S, n, *x.shape[len(lead) + 2:])

    if lead:   # one F per problem: the stream's F for its three problems
        F = F[:, None].expand(S, 3, 3, 3).reshape(3 * S, 3, 3)
    res = match_problem_batch(
        q_xy=stack(kp1.xy, kp1.xy, kp2.xy),
        q_valid=stack(kp1.valid, kp1.valid, kp2.valid),
        q_d=stack(d1, d1, d2),
        t_xy=stack(kp2.xy, kp1p.xy, kp2p.xy),
        t_valid=stack(kp2.valid, kp1p.valid, kp2p.valid),
        t_d=stack(d2, d1p, d2p),
        use_epi=torch.tensor([stereo.use_epipolar, False, False],
                             device=dev).repeat(S),
        use_rat=torch.tensor([stereo.use_ratio, temporal.use_ratio,
                              temporal.use_ratio], device=dev).repeat(S),
        ratios=torch.tensor([stereo.ratio, temporal.ratio, temporal.ratio],
                            dtype=d1.dtype, device=dev).repeat(S),
        radius=stereo.radius, sampson_thresh=stereo.sampson_thresh,
        metric=stereo.metric, F=F, backend=backend, layout=layout,
        image_width=image_width)
    res = MatchResult(*(x.reshape(*lead, 3, n) for x in res))
    return tuple(MatchResult(*(x[..., i, :] for x in res)) for i in range(3))


def row_two_min(kp1: Keypoints, d1, kp2: Keypoints, d2, cfg: MatchConfig,
                F=None, backend="dense"):
    """Row-wise gated (best, second, argmin) of one match problem by the
    backend's route, before the ratio test: the part of
    ``match_descriptors`` that also runs on a column shard of view 2
    (``parallel/tp_matching.py``)."""
    check_backend(backend, cfg.metric)
    if backend == "dense":
        return two_smallest(gated_distance_matrix(kp1, d1, kp2, d2, cfg, F=F))
    check_match_supported(cfg)
    if cfg.use_epipolar and F is None:
        raise ValueError("epipolar gating requires F")
    return _fused_two_min(
        backend, kp1.xy, kp1.valid, d1, kp2.xy, kp2.valid, d2,
        torch.zeros(3, 3) if F is None else F,
        torch.tensor(cfg.use_epipolar), cfg.sampson_thresh, cfg.radius)


def match_descriptors(kp1: Keypoints, d1, kp2: Keypoints, d2,
                      cfg: MatchConfig = MatchConfig(),
                      F=None, backend="dense") -> MatchResult:
    """Match view-1 keypoints to view-2 keypoints (one match per slot);
    ``cfg.use_epipolar`` requires the (3, 3) fundamental matrix ``F``."""
    best, second, best_idx = row_two_min(kp1, d1, kp2, d2, cfg, F, backend)
    return finalize_match(best, second, best_idx, kp1.valid, cfg)
