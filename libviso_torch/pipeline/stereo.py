"""Stereo visual odometry pipeline (port of ``libviso_tpu/pipeline/stereo.py``).

Per frame: detect and describe both views -> match three problems in one
batch -> triangulate -> circle filter -> RANSAC + Gauss-Newton; then the
poses are chained.  Keypoints are padded slot tensors, matches index
tables with -1 sentinels, and the previous frame's memory an explicit
``FrameState``.  The step runs eagerly on the device its inputs live on;
the RANSAC Gumbel scores are an argument of the step, so a run's draws
can be fixed from outside (the parity tests feed the JAX package's).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, NamedTuple, Optional

import numpy as np
import torch

from libviso_torch.config import Calib, PipelineConfig
from libviso_torch.geometry.mvg import F_from_P_host
from libviso_torch.geometry.se3 import chain_motions, pose_vector_to_matrix
from libviso_torch.geometry.triangulate import triangulate_rectified
from libviso_torch.ops.circle import circle_filter
from libviso_torch.ops.features import (
    Keypoints,
    check_detector_supported,
    detect_and_describe,
)
from libviso_torch.ops.matching import (
    check_backend,
    check_match_supported,
    match_frame_triple,
)
from libviso_torch.solvers.ransac import (
    frame_generator,
    ransac_pose,
    sample_gumbel,
)


class FrameState(NamedTuple):
    """Previous-frame memory carried across steps."""

    kp1: Keypoints           # left keypoints
    kp2: Keypoints           # right keypoints
    d1: torch.Tensor         # (N, D) left descriptors
    d2: torch.Tensor         # (N, D) right descriptors
    match_lr: torch.Tensor   # (N,) left-slot -> right-slot
    X: torch.Tensor          # (N, 3) triangulated 3D per left slot
    X_valid: torch.Tensor    # (N,) bool
    fail_age: torch.Tensor   # () int (keep_features_on_failure; always 0)


class FrameOutput(NamedTuple):
    tr: torch.Tensor           # (6,) motion previous -> current
    ok: torch.Tensor           # () bool: pose accepted
    num_circle: torch.Tensor   # () circular matches
    num_inliers: torch.Tensor  # () RANSAC support size
    num_lr: torch.Tensor       # () stereo matches
    num_kp1: torch.Tensor      # () detected left corners
    rms: torch.Tensor          # () reprojection RMS over the support
    sharpness: torch.Tensor    # () mean |Harris response| of left corners


class Feats(NamedTuple):
    """Front-end output for one stereo frame."""

    kp1: Keypoints
    d1: torch.Tensor
    kp2: Keypoints
    d2: torch.Tensor


class SolveInput(NamedTuple):
    """Everything the pose solve needs about one frame."""

    Xp: torch.Tensor          # (N, 3) previous-frame 3D per circle match
    obs: torch.Tensor         # (N, 4) current observations
    pts_valid: torch.Tensor   # (N,) usable correspondences
    circ_count: torch.Tensor  # ()
    num_lr: torch.Tensor      # ()
    num_kp1: torch.Tensor     # ()
    sharpness: torch.Tensor   # ()


def check_supported(cfg: PipelineConfig, backend: str = "dense"):
    """Raise ``NotImplementedError`` for options the port does not run
    yet, naming the ROADMAP item that ports them, and ``ValueError`` for a
    matcher backend the metrics cannot take."""
    check_backend(backend, cfg.stereo_match.metric)
    check_backend(backend, cfg.temporal_match.metric)
    check_detector_supported(cfg.detector)
    check_match_supported(cfg.stereo_match)
    check_match_supported(cfg.temporal_match)
    if cfg.keep_features_on_failure:
        raise NotImplementedError(
            "keep_features_on_failure is not ported yet: ROADMAP.md "
            "Queue 1 item 8 (main-path options)")


def empty_state(cfg: PipelineConfig, device="cpu",
                dtype=torch.float32) -> FrameState:
    """All-invalid state for the first frame."""
    n = cfg.detector.num_slots
    d = cfg.detector.descriptor_dim_padded
    z = lambda *s: torch.zeros(s, dtype=dtype, device=device)  # noqa: E731
    kp = Keypoints(xy=z(n, 2), response=z(n),
                   valid=torch.zeros(n, dtype=torch.bool, device=device))
    return FrameState(
        kp1=kp, kp2=kp, d1=z(n, d), d2=z(n, d),
        match_lr=torch.full((n,), -1, dtype=torch.long, device=device),
        X=z(n, 3), X_valid=torch.zeros(n, dtype=torch.bool, device=device),
        fail_age=torch.zeros((), dtype=torch.int32, device=device))


def build_frontend(cfg: PipelineConfig):
    """frontend(im1, im2) -> Feats: both views detected as one batch."""

    def frontend(im1, im2) -> Feats:
        kps, ds = detect_and_describe(torch.stack([im1, im2]), cfg.detector)
        kp1, kp2 = (Keypoints(*(x[i] for x in kps)) for i in range(2))
        return Feats(kp1=kp1, d1=ds[0], kp2=kp2, d2=ds[1])

    return frontend


def gather_correspondences(calib: Calib, feats: Feats, state: FrameState,
                           mlr, m11, m22):
    """The part of ``prepare`` after matching: observations, 3D points,
    circle filter and the solve's inputs -> (new_state, SolveInput,
    CircleResult).

    Every input may carry leading stream dims; ``calib``'s fields are then
    tensors that broadcast against them ((S, 1)), one row per stream.
    """
    kp1, d1, kp2, d2 = feats

    def take(x, idx):   # x[..., idx, :] per leading index
        return torch.take_along_dim(x, idx[..., None], dim=-2)

    n = kp1.valid.shape[-1]
    # per-left-slot observations (u_l, v_l, u_r, v_r) and 3D points
    r_safe = torch.clamp(mlr.idx, 0, n - 1)
    obs = torch.cat([kp1.xy, take(kp2.xy, r_safe)], dim=-1)
    X = triangulate_rectified(obs, calib.f, calib.base, calib.cu, calib.cv)

    circ = circle_filter(mlr.idx, state.match_lr, m11.idx, m22.idx)
    lp_safe = torch.clamp(circ.left_prev, 0, n - 1)
    pts_valid = (circ.valid & torch.gather(state.X_valid, -1, lp_safe)
                 & mlr.valid)

    new_state = FrameState(
        kp1=kp1, kp2=kp2, d1=d1, d2=d2, match_lr=mlr.idx, X=X,
        X_valid=mlr.valid, fail_age=torch.zeros_like(state.fail_age))
    n_kp1 = kp1.valid.sum(-1)
    si = SolveInput(
        Xp=take(state.X, lp_safe), obs=obs, pts_valid=pts_valid,
        circ_count=circ.count, num_lr=mlr.valid.sum(-1), num_kp1=n_kp1,
        sharpness=(torch.where(kp1.valid, kp1.response, 0.0).sum(-1)
                   / torch.clamp(n_kp1, min=1)))
    return new_state, si, circ


def build_prepare(calib: Calib, F, cfg: PipelineConfig,
                  backend: str = "dense"):
    """prepare(feats, state) -> (new_state, SolveInput, CircleResult):
    matching through correspondence gathering.  ``F`` is the (3, 3)
    fundamental matrix as a tensor on the step's device; ``backend`` the
    matcher route (``ops/matching.py``)."""

    def prepare(feats: Feats, state: FrameState):
        kp1, d1, kp2, d2 = feats
        matches = match_frame_triple(
            kp1, d1, kp2, d2, state.kp1, state.d1, state.kp2, state.d2,
            cfg.stereo_match, cfg.temporal_match, F, backend=backend)
        return gather_correspondences(calib, feats, state, *matches)

    return prepare


def build_solve(calib: Calib, cfg: PipelineConfig):
    """solve(si, gumbel) -> FrameOutput: the RANSAC + GN pose solve."""

    def solve(si: SolveInput, gumbel) -> FrameOutput:
        est = ransac_pose(si.Xp, si.obs, si.pts_valid, calib, cfg.ransac,
                          gumbel=gumbel)
        ok = est.ok & (si.circ_count >= cfg.min_circle_matches)
        return FrameOutput(
            tr=torch.where(ok, est.tr, torch.zeros_like(est.tr)), ok=ok,
            num_circle=si.circ_count, num_inliers=est.num_inliers,
            num_lr=si.num_lr, num_kp1=si.num_kp1, rms=est.rms,
            sharpness=si.sharpness)

    return solve


def build_backend(calib: Calib, F, cfg: PipelineConfig,
                  backend: str = "dense"):
    """backend_fn(feats, state, gumbel) -> (new_state, FrameOutput)."""
    prepare = build_prepare(calib, F, cfg, backend=backend)
    solve = build_solve(calib, cfg)

    def backend_fn(feats: Feats, state: FrameState, gumbel):
        new_state, si, _ = prepare(feats, state)
        return new_state, solve(si, gumbel)

    return backend_fn


def build_frame_step(calib: Calib, F, cfg: PipelineConfig,
                     backend: str = "dense"):
    """step(state, im1, im2, gumbel) -> (new_state, FrameOutput).

    ``gumbel`` is the frame's (num_hypotheses, num_slots) RANSAC draw;
    ``backend`` the matcher route: "dense", "fused" or "sweep".
    """
    check_supported(cfg, backend)
    frontend = build_frontend(cfg)
    backend_fn = build_backend(calib, F, cfg, backend=backend)

    def step(state: FrameState, im1, im2, gumbel):
        return backend_fn(frontend(im1, im2), state, gumbel)

    return step


@dataclasses.dataclass
class SequenceResult:
    poses: np.ndarray        # (T, 4, 4) cumulative poses (frame 0 = I)
    motions: np.ndarray      # (T, 6) per-frame motion vectors
    frame_ok: np.ndarray     # (T,) bool
    stats: list              # per-frame dicts (match counts etc.)


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; a CUDA device without a card
    raises instead of running on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch sees no CUDA device; "
            "pass device='cpu' (CLI: --device cpu) to run on the CPU")
    return device


def run_stereo_sequence(frames: Iterable, P1, P2,
                        cfg: PipelineConfig = PipelineConfig(),
                        seed: int = 0, device="cuda", on_frame=None,
                        draws: Optional[Callable[[int], torch.Tensor]] = None,
                        chunk: int = 1, dbg_dir=None, checkpoint=None,
                        backend: str = "dense") -> SequenceResult:
    """Stream stereo pairs through the per-frame step on ``device``.

    Args:
      frames: iterable of (im_left, im_right) uint8/float arrays (H, W).
      P1, P2: 3x4 rectified projection matrices.
      on_frame: optional callback(frame_index, FrameOutput).
      draws: optional callable t -> (num_hypotheses, num_slots) Gumbel
        scores for frame t (a test seam).  By default frame t draws from
        ``frame_generator(seed, t)`` on the CPU, so a run on the card and
        one on the CPU see the same draws.
      chunk, dbg_dir, checkpoint: accepted for the JAX signature; values
        other than the defaults are not ported yet and raise.
      backend: the matcher route, "dense" (default), "fused" or "sweep"
        (``ops/matching.py``); the fused routes need metric 'l1'.
    """
    if chunk != 1:
        raise NotImplementedError(
            "chunk > 1 is not ported yet: ROADMAP.md Queue 1 item 7")
    if dbg_dir is not None or checkpoint is not None:
        raise NotImplementedError(
            "debug dumps and checkpoints are not ported yet: ROADMAP.md "
            "Queue 1 item 8 (main-path options)")
    device = resolve_device(device)
    calib = Calib.from_projections(P1, P2)
    F = torch.as_tensor(F_from_P_host(P1, P2), dtype=torch.float32,
                        device=device)
    step = build_frame_step(calib, F, cfg, backend=backend)
    shape = (cfg.ransac.num_hypotheses, cfg.detector.num_slots)
    if draws is None:
        draws = lambda t: sample_gumbel(  # noqa: E731
            shape, frame_generator(seed, t))

    state = empty_state(cfg, device)
    outs = []
    for t, (im1, im2) in enumerate(frames):
        im1 = torch.tensor(np.asarray(im1), device=device)
        im2 = torch.tensor(np.asarray(im2), device=device)
        state, out = step(state, im1, im2, draws(t).to(device))
        outs.append(out)
        if on_frame is not None:
            on_frame(t, out)

    return sequence_result(outs)


_JUMP_WEIGHTS = np.array([10.0, 10.0, 10.0, 1.0, 1.0, 1.0])


def _motion_jump(tr, ok, prev_motions, prev_oks):
    """Weighted 6-dof delta to the previous motion when both were accepted
    (the dominant-mover health signal), in float64."""
    if ok and prev_oks and prev_oks[-1]:
        d = (np.asarray(tr, np.float64)
             - np.asarray(prev_motions[-1], np.float64)) * _JUMP_WEIGHTS
        return float(np.linalg.norm(d))
    return 0.0


def sequence_result(outs) -> SequenceResult:
    """SequenceResult of one sequence's per-frame outputs, frame 0 first:
    stats, motions and chained poses.  The solo, multi-stream and pool
    drivers all build their results here."""
    motions, oks, stats = [], [], []
    for t, out in enumerate(outs):
        out = FrameOutput(*(x.cpu() for x in out))
        ok = bool(out.ok) and t != 0  # the reference skips frame 0
        tr = out.tr.numpy()
        jump = _motion_jump(tr, ok, motions, oks)
        motions.append(tr)
        oks.append(ok)
        stats.append({
            "frame": t, "ok": ok,
            "num_kp1": int(out.num_kp1), "num_lr": int(out.num_lr),
            "num_circle": int(out.num_circle),
            "num_inliers": int(out.num_inliers),
            "reproj_rms": float(out.rms),
            "sharpness": float(out.sharpness), "motion_jump": jump,
        })

    if not motions:
        return SequenceResult(poses=np.zeros((0, 4, 4)),
                              motions=np.zeros((0, 6)),
                              frame_ok=np.zeros((0,), bool), stats=[])
    motions = np.stack(motions)
    oks_arr = np.asarray(oks, bool)
    Ts = pose_vector_to_matrix(torch.from_numpy(motions))
    poses = chain_motions(Ts, torch.from_numpy(oks_arr)).numpy()
    return SequenceResult(poses=poses, motions=motions, frame_ok=oks_arr,
                          stats=stats)
