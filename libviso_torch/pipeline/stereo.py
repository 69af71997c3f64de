"""Stereo visual odometry pipeline (port of ``libviso_tpu/pipeline/stereo.py``).

Per frame: detect and describe both views -> match three problems in one
batch -> triangulate -> circle filter -> RANSAC + Gauss-Newton; then the
poses are chained.  Keypoints are padded slot tensors, matches index
tables with -1 sentinels, and the previous frame's memory an explicit
``FrameState``.  The step runs eagerly on the device its inputs live on;
the RANSAC Gumbel scores are an argument of the step, so a run's draws
can be fixed from outside (the parity tests feed the JAX package's).

The host loop keeps every per-frame output on the device until a checkpoint
or the end of the run asks for it, so no step waits for the host to read
the one before.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, List, NamedTuple, Optional

import numpy as np
import torch

from libviso_torch.config import Calib, PipelineConfig, pad_axes
from libviso_torch.geometry.mvg import F_from_P_host
from libviso_torch.geometry.se3 import chain_motions, pose_vector_to_matrix
from libviso_torch.geometry.triangulate import triangulate_rectified
from libviso_torch.ops.circle import circle_filter
from libviso_torch.ops.features import (
    Keypoints,
    blur_metric,
    detect_and_describe,
)
from libviso_torch.ops.matching import (
    check_backend,
    check_match_supported,
    match_frame_triple,
)
from libviso_torch.solvers.gauss_newton import _tree_sum, stereo_predict
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
    # consecutive solves that failed while these features were held as
    # the match target (cfg.keep_features_on_failure; 0 otherwise)
    fail_age: torch.Tensor   # () int32


class FrameOutput(NamedTuple):
    tr: torch.Tensor           # (6,) motion previous -> current
    ok: torch.Tensor           # () bool: pose accepted
    num_circle: torch.Tensor   # () circular matches
    num_inliers: torch.Tensor  # () RANSAC support size
    num_lr: torch.Tensor       # () stereo matches
    num_kp1: torch.Tensor      # () detected left corners
    rms: torch.Tensor          # () reprojection RMS over the support
    sharpness: torch.Tensor    # () mean |Harris response| of left corners


class FrameDebug(NamedTuple):
    """Extra per-frame tensors for the debug artifact writer."""

    circle: object            # CircleResult
    inliers: torch.Tensor     # (N,) bool RANSAC support mask
    obs: torch.Tensor         # (N, 4) current observations per left slot
    predict: torch.Tensor     # (N, 4) reprojections under the estimate
    # this frame's own detections and LR matches: under
    # keep_features_on_failure a failed frame's state holds the previous
    # frame's features, which are not this frame's
    kp1: Keypoints
    kp2: Keypoints
    match_lr: torch.Tensor    # (N,)


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
    """Raise ``ValueError`` for an unknown metric or a matcher backend the
    metrics cannot take."""
    check_backend(backend, cfg.stereo_match.metric)
    check_backend(backend, cfg.temporal_match.metric)
    check_match_supported(cfg.stereo_match)
    check_match_supported(cfg.temporal_match)


def zero_solve_input(cfg: PipelineConfig, device="cpu",
                     dtype=torch.float32) -> SolveInput:
    """All-invalid SolveInput: the staged pipeline's bubble, which solves
    to ok False as an empty first frame does."""
    n = cfg.detector.num_slots
    z = torch.zeros((), dtype=torch.long, device=device)
    return SolveInput(
        Xp=torch.zeros((n, 3), dtype=dtype, device=device),
        obs=torch.zeros((n, 4), dtype=dtype, device=device),
        pts_valid=torch.zeros((n,), dtype=torch.bool, device=device),
        circ_count=z, num_lr=z, num_kp1=z,
        sharpness=torch.zeros((), dtype=dtype, device=device))


def match_layout(cfg: PipelineConfig, image_width):
    """(nbinx, nbiny, k, num_slots) for the strip-banded matcher, or None
    where banding does not apply: no width known, multi-scale detection
    (whose slot blocks are per level), or ``stereo_match.banded`` off."""
    det = cfg.detector
    if (image_width is None or det.pyramid_levels > 1
            or not cfg.stereo_match.banded):
        return None
    return (det.nbinx, det.nbiny, det.corners_per_bin, det.num_slots)


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


def state_leaves(state):
    """The tensors of a (nested) FrameState, in field order: kp1 (xy,
    response, valid), kp2, d1, d2, match_lr, X, X_valid, fail_age.  It is
    the order of the JAX package's pytree leaves."""
    for x in state:
        if isinstance(x, tuple):
            yield from state_leaves(x)
        else:
            yield x


def rebuild_state(template, leaves):
    """A FrameState shaped like ``template`` from an iterable of leaves."""
    it = iter(leaves)

    def build(t):
        return type(t)(*(build(x) if isinstance(x, tuple) else next(it)
                         for x in t))

    return build(template)


def state_to_leaves(state: FrameState) -> List[np.ndarray]:
    """A FrameState (with any leading stream axes) as numpy arrays in
    ``state_leaves`` order, with the JAX package's dtypes (match_lr
    int32): what a checkpoint stores."""
    out = [x.cpu().numpy() for x in state_leaves(state)]
    out[8] = out[8].astype(np.int32)
    return out


def state_from_leaves(leaves, device="cpu") -> FrameState:
    """The port's FrameState on ``device`` from numpy leaves in
    ``state_leaves`` order, as ``state_to_leaves`` writes them or as
    ``jax.tree_util.tree_leaves`` gives them for the JAX package's
    FrameState: the state carried across from a checkpoint or from the
    other package.  Dtypes become the port's (float32, bool, int64 match
    tables, int32 fail_age)."""
    it = iter(leaves)

    def t(dtype):
        return torch.tensor(np.asarray(next(it))).to(device=device,
                                                     dtype=dtype)

    def kp():
        return Keypoints(xy=t(torch.float32), response=t(torch.float32),
                         valid=t(torch.bool))

    return FrameState(kp1=kp(), kp2=kp(), d1=t(torch.float32),
                      d2=t(torch.float32), match_lr=t(torch.long),
                      X=t(torch.float32), X_valid=t(torch.bool),
                      fail_age=t(torch.int32))


def build_frontend(cfg: PipelineConfig):
    """frontend(im1, im2) -> Feats: both views detected as one batch.
    The images may carry leading stream axes, (S, H, W)."""
    det = cfg.detector

    def frontend(im1, im2) -> Feats:
        ims = torch.stack([im1, im2])
        gate = None
        if det.sharpen_sigma > 0 and det.sharpen_auto:
            # one defocus decision per stereo pair (per stream when
            # serving), the mean of the two views' metrics: descriptors of
            # a sharpened and an unsharpened view stop matching
            gate = (blur_metric(ims.to(torch.float32)).mean(0)
                    < det.sharpen_trigger)
        kps, ds = detect_and_describe(ims, det, sharpen_gate=gate)
        kp1, kp2 = (Keypoints(*(x[i] for x in kps)) for i in range(2))
        return Feats(kp1=kp1, d1=ds[0], kp2=kp2, d2=ds[1])

    return frontend


def gather_correspondences(calib: Calib, feats: Feats, state: FrameState,
                           mlr, m11, m22):
    """The part of ``prepare`` after matching: observations, 3D points,
    circle filter and the solve's inputs -> (new_state, SolveInput,
    CircleResult).

    Every input may carry leading stream dims; ``calib``'s fields are then
    (S,) tensors, one value per stream (``config.Calib``).
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
        # a fixed tree of additions: a library sum over (S, N) rounds a
        # stream's row differently with S, and serving holds each stream
        # to its own result in any stream batch
        sharpness=(_tree_sum(torch.where(kp1.valid, kp1.response, 0.0), -1)
                   / torch.clamp(n_kp1, min=1)))
    return new_state, si, circ


def build_prepare(calib: Calib, F, cfg: PipelineConfig,
                  backend: str = "dense", image_width=None):
    """prepare(feats, state) -> (new_state, SolveInput, CircleResult):
    matching through correspondence gathering.  ``F`` is the (3, 3)
    fundamental matrix as a tensor on the step's device; ``backend`` the
    matcher route (``ops/matching.py``); ``image_width`` enables the
    strip-banded matcher where ``match_layout`` admits it (None keeps the
    dense path)."""
    layout = match_layout(cfg, image_width)

    def prepare(feats: Feats, state: FrameState):
        kp1, d1, kp2, d2 = feats
        matches = match_frame_triple(
            kp1, d1, kp2, d2, state.kp1, state.d1, state.kp2, state.d2,
            cfg.stereo_match, cfg.temporal_match, F, backend=backend,
            layout=layout, image_width=image_width)
        return gather_correspondences(calib, feats, state, *matches)

    return prepare


def build_solve(calib: Calib, cfg: PipelineConfig, debug: bool = False):
    """solve(si, gumbel) -> FrameOutput: the RANSAC + GN pose solve.

    ``si`` and ``gumbel`` may carry leading batch axes (streams), with
    ``calib`` holding one value per row: all rows are then one batched
    solve and the FrameOutput has the same leading axes.  With ``debug``
    it returns (FrameOutput, support mask, reprojections), the solve's
    share of a FrameDebug."""

    def solve(si: SolveInput, gumbel):
        est = ransac_pose(si.Xp, si.obs, si.pts_valid, calib, cfg.ransac,
                          gumbel=gumbel)
        ok = est.ok & (si.circ_count >= cfg.min_circle_matches)
        out = FrameOutput(
            tr=torch.where(ok[..., None], est.tr, torch.zeros_like(est.tr)),
            ok=ok, num_circle=si.circ_count, num_inliers=est.num_inliers,
            num_lr=si.num_lr, num_kp1=si.num_kp1, rms=est.rms,
            sharpness=si.sharpness)
        if debug:
            predict, _ = stereo_predict(est.tr, si.Xp,
                                        calib.on(si.Xp.device))
            return out, est.inliers, predict
        return out

    return solve


def hold_state_on_failure(state, new_state, ok, has_history, max_age: int):
    """Dropout recovery (``cfg.keep_features_on_failure``): where the
    solve failed, hold the previous state as the next frame's match target
    instead of the bad frame's, unless the held state is empty
    (``has_history`` False at start-up) or has been held ``max_age`` times
    already (a scene that really changed must re-sync, not pin).  The
    states are any (nested) NamedTuple of tensors with a ``fail_age``
    field: the stereo FrameState or the mono MonoState.

    ``ok`` and ``has_history`` are bool tensors shaped like the states'
    leading stream axes, () for one stream and (S,) when serving.  A
    ``torch.where`` over the state's tensors: no host sync.
    """
    keep = (~ok) & has_history & (state.fail_age < max_age)

    def pick(old, new):
        return torch.where(pad_axes(keep, old.dim()), old, new)

    merged = rebuild_state(state, (pick(o, n) for o, n in zip(
        state_leaves(state), state_leaves(new_state))))
    return merged._replace(fail_age=torch.where(
        keep, state.fail_age + 1, torch.zeros_like(state.fail_age)))


def build_backend(calib: Calib, F, cfg: PipelineConfig,
                  backend: str = "dense", debug: bool = False,
                  image_width=None):
    """backend_fn(feats, state, gumbel) ->
    (new_state, FrameOutput[, FrameDebug])."""
    prepare = build_prepare(calib, F, cfg, backend=backend,
                            image_width=image_width)
    solve = build_solve(calib, cfg, debug=debug)

    def backend_fn(feats: Feats, state: FrameState, gumbel):
        new_state, si, circ = prepare(feats, state)
        cur_match_lr = new_state.match_lr   # before the hold: this frame's
        res = solve(si, gumbel)
        out = res[0] if debug else res
        if cfg.keep_features_on_failure:
            new_state = hold_state_on_failure(
                state, new_state, out.ok, state.kp1.valid.any(-1),
                cfg.max_keep_age)
        if debug:
            _, inliers, predict = res
            dbg = FrameDebug(circle=circ, inliers=inliers, obs=si.obs,
                             predict=predict, kp1=feats.kp1, kp2=feats.kp2,
                             match_lr=cur_match_lr)
            return new_state, out, dbg
        return new_state, out

    return backend_fn


def build_frame_step(calib: Calib, F, cfg: PipelineConfig,
                     backend: str = "dense", debug: bool = False):
    """step(state, im1, im2, gumbel) -> (new_state, FrameOutput[,
    FrameDebug]).

    ``gumbel`` is the frame's (num_hypotheses, num_slots) RANSAC draw;
    ``backend`` the matcher route: "dense", "fused" or "sweep"; ``debug``
    adds the tensors the artifact writer needs.  The frame's width reaches
    the matcher, which bands where ``match_layout`` admits it, as the JAX
    step does at trace time.
    """
    check_supported(cfg, backend)
    frontend = build_frontend(cfg)
    backends = {}   # one back-end per image width

    def step(state: FrameState, im1, im2, gumbel):
        width = im1.shape[-1]
        if width not in backends:
            backends[width] = build_backend(calib, F, cfg, backend=backend,
                                            debug=debug, image_width=width)
        return backends[width](frontend(im1, im2), state, gumbel)

    return step


def build_frame_chunk(calib: Calib, F, cfg: PipelineConfig, chunk: int,
                      backend: str = "dense"):
    """K consecutive frame steps on one uploaded stack of frames.

    chunk_step(state, lefts, rights, gumbels) -> (new_state, FrameOutput
    stacked over the leading K axis), with lefts/rights (K, H, W) and
    gumbels (K, num_hypotheses, num_slots).  The frames are stepped in
    order through ``build_frame_step``'s step with the state threaded
    through, so the outputs equal K separate steps exactly; what changes
    is that K frames and their draws reach the device as one transfer
    each.  The cost is latency: results arrive K frames at a time and the
    host must have K frames on hand, as a recorded sequence does; a live
    loop that needs each pose at once keeps chunk 1.
    """
    step = build_frame_step(calib, F, cfg, backend=backend)

    def chunk_step(state: FrameState, lefts, rights, gumbels):
        if not len(lefts) == len(rights) == len(gumbels) == chunk:
            raise ValueError(f"chunk_step built for {chunk} frames")
        outs = []
        for im1, im2, g in zip(lefts, rights, gumbels):
            state, out = step(state, im1, im2, g)
            outs.append(out)
        return state, FrameOutput(*(torch.stack(xs) for xs in zip(*outs)))

    return chunk_step


@dataclasses.dataclass
class SequenceResult:
    poses: np.ndarray        # (T, 4, 4) cumulative poses (frame 0 = I)
    motions: np.ndarray      # (T, 6) per-frame motion vectors
    frame_ok: np.ndarray     # (T,) bool
    stats: list              # per-frame dicts (match counts etc.)
    processed: int = 0       # frames computed in this run (not those a
    #                          checkpoint restored): throughput's count


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; a CUDA device without a card
    raises instead of running on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch sees no CUDA device; "
            "pass device='cpu' (CLI: --device cpu) to run on the CPU")
    return device


def _to_host(tree):
    """A (nested) tuple of tensors as numpy arrays."""
    if isinstance(tree, tuple):
        return type(tree)(*(_to_host(x) for x in tree))
    return tree.cpu().numpy()


def run_stereo_sequence(frames: Iterable, P1, P2,
                        cfg: PipelineConfig = PipelineConfig(),
                        seed: int = 0, device="cuda", on_frame=None,
                        draws: Optional[Callable[[int], torch.Tensor]] = None,
                        chunk: int = 1, dbg_dir=None, checkpoint=None,
                        backend: str = "dense",
                        fingerprint_scope: str = "") -> SequenceResult:
    """Stream stereo pairs through the per-frame step on ``device``.

    Args:
      frames: iterable of (im_left, im_right) uint8/float arrays (H, W).
      P1, P2: 3x4 rectified projection matrices.
      on_frame: optional callback(frame_index, FrameOutput); the output's
        tensors are still on the device.
      draws: optional callable t -> (num_hypotheses, num_slots) Gumbel
        scores for frame t (a test seam).  By default frame t draws from
        ``frame_generator(seed, t)`` on the CPU, so a run on the card and
        one on the CPU see the same draws.
      chunk: frames per upload (``build_frame_chunk``).  > 1 buffers that
        many frames, uploads them as one stack and steps them in order:
        the same outputs bit for bit, arriving ``chunk`` at a time.  The
        tail of a sequence shorter than the next multiple of ``chunk``
        runs through the per-frame step.  Debug runs (``dbg_dir``) stay
        per frame, since the artifact writer reads every frame back.
      dbg_dir: write per-frame debug artifacts here
        (``utils/debug_viz.py``).
      checkpoint: optional ``utils.checkpoint.CheckpointManager``.  The
        loop state is saved every ``checkpoint.every`` frames (at the end
        of the chunk that crosses such a boundary) and, when a checkpoint
        with this run's fingerprint exists, the run resumes after its
        last frame; frames already done are skipped.  Frame t's draws
        depend on (seed, t) only, so a resumed run equals an
        uninterrupted one bit for bit.
      backend: the matcher route, "dense" (default), "fused" or "sweep"
        (``ops/matching.py``); the fused routes need metric 'l1'.
      fingerprint_scope: names the input slice (e.g. a begin/end range);
        a checkpoint written under another scope is refused.
    """
    device = resolve_device(device)
    calib = Calib.from_projections(P1, P2)
    F = torch.as_tensor(F_from_P_host(P1, P2), dtype=torch.float32,
                        device=device)
    debug = dbg_dir is not None
    step = build_frame_step(calib, F, cfg, backend=backend, debug=debug)
    shape = (cfg.ransac.num_hypotheses, cfg.detector.num_slots)
    if draws is None:
        draws = lambda t: sample_gumbel(  # noqa: E731
            shape, frame_generator(seed, t))
    if debug:
        from libviso_torch.ops.matching import MatchResult
        from libviso_torch.utils.debug_viz import DebugDumper

        dumper = DebugDumper(dbg_dir)

    state = empty_state(cfg, device)
    hist = History()
    t0 = 0
    fingerprint = None
    if checkpoint is not None:
        from libviso_torch.utils.checkpoint import (
            Checkpoint,
            config_fingerprint,
        )

        fingerprint = config_fingerprint(cfg, seed, backend,
                                         scope=fingerprint_scope)
        ck = checkpoint.latest()
        if ck is not None:
            if ck.fingerprint != fingerprint:
                raise ValueError(
                    "checkpoint fingerprint mismatch: checkpoint was "
                    "written with different cfg/seed/backend "
                    f"({ck.fingerprint} != {fingerprint})")
            state = state_from_leaves(ck.state_leaves, device)
            hist = History(ck.motions, ck.oks, ck.stats)
            t0 = ck.next_frame

    def snapshot(next_frame):
        hist.flush(pending)
        checkpoint.save(Checkpoint(
            next_frame=next_frame, motions=hist.motions_array(),
            oks=np.asarray(hist.oks, bool),
            state_leaves=state_to_leaves(state), stats=hist.stats,
            fingerprint=fingerprint))

    start = 0
    if t0 and hasattr(frames, "skipped"):
        frames = frames.skipped(t0)   # do not decode what is already done
        start = t0
    # outputs stay on the device until a snapshot or the end: reading one
    # inside the loop would make every step wait for the one before
    pending = []

    def emit(t, out):
        pending.append((t, out))
        if on_frame is not None:
            on_frame(t, out)

    def upload(image):
        return torch.tensor(np.asarray(image), device=device)

    use_chunk = chunk > 1 and not debug
    cstep = (build_frame_chunk(calib, F, cfg, chunk, backend=backend)
             if use_chunk else None)
    buf = []          # [(t, left, right)] host frames of the open chunk
    prev_host = None  # the previous frame's images, for the debug quads

    for t, (im1, im2) in enumerate(frames, start=start):
        if t < t0:    # covered by the restored checkpoint
            continue
        if use_chunk:
            buf.append((t, im1, im2))
            if len(buf) < chunk:
                continue
            ts = [b[0] for b in buf]
            state, outs = cstep(
                state, upload(np.stack([np.asarray(b[1]) for b in buf])),
                upload(np.stack([np.asarray(b[2]) for b in buf])),
                torch.stack([draws(ft) for ft in ts]).to(device))
            buf.clear()
            for i, ft in enumerate(ts):
                emit(ft, FrameOutput(*(x[i] for x in outs)))
            if checkpoint is not None and (
                    (ts[-1] + 1) // checkpoint.every
                    > ts[0] // checkpoint.every):
                # a snapshot boundary fell inside this chunk: snapshot at
                # its end (resume stays exact, only the cadence shifts)
                snapshot(ts[-1] + 1)
            continue
        left, right = upload(im1), upload(im2)
        if debug:
            prev_state = state
            state, out, dbg = step(state, left, right, draws(t).to(device))
            dbg = _to_host(dbg)
            host = (np.asarray(im1), np.asarray(im2))
            dumper.frame(
                t, host[0], host[1], dbg.kp1, dbg.kp2,
                MatchResult(idx=dbg.match_lr,
                            dist=np.zeros_like(dbg.kp1.response),
                            valid=dbg.match_lr >= 0),
                prev=((*prev_host, _to_host(prev_state.kp1),
                       _to_host(prev_state.kp2)) if prev_host else None),
                circ=dbg.circle if t > 0 else None,
                predict=dbg.predict if t > 0 else None,
                obs=dbg.obs if t > 0 else None,
                inliers=dbg.inliers if t > 0 else None)
            prev_host = host
        else:
            state, out = step(state, left, right, draws(t).to(device))
        emit(t, out)
        if checkpoint is not None and (t + 1) % checkpoint.every == 0:
            snapshot(t + 1)

    for ft, im1, im2 in buf:
        # a tail shorter than one chunk: the per-frame step, the same
        # draws, the same result
        state, out = step(state, upload(im1), upload(im2),
                          draws(ft).to(device))
        emit(ft, out)

    hist.flush(pending)
    if checkpoint is not None and hist.motions:
        snapshot(len(hist.motions))   # so that a rerun does nothing
    return hist.result(processed=len(hist.motions) - t0)


_JUMP_WEIGHTS = np.array([10.0, 10.0, 10.0, 1.0, 1.0, 1.0])


def _motion_jump(tr, ok, prev_motions, prev_oks):
    """Weighted 6-dof delta to the previous motion when both were accepted
    (the dominant-mover health signal).  In float64: a checkpoint stores
    motions as float64 copies of the float32 values, and a fixed compute
    dtype keeps the stat the same across a resume."""
    if ok and prev_oks and prev_oks[-1]:
        d = (np.asarray(tr, np.float64)
             - np.asarray(prev_motions[-1], np.float64)) * _JUMP_WEIGHTS
        return float(np.linalg.norm(d))
    return 0.0


class History:
    """One sequence's record on the host: motions, ok flags and stats,
    filled from the device's outputs at a flush."""

    def __init__(self, motions=(), oks=(), stats=()):
        self.motions = [np.asarray(m, np.float32) for m in motions]
        self.oks = [bool(o) for o in oks]
        self.stats = list(stats)

    def flush(self, pending):
        """Read the pending (frame, FrameOutput) pairs back, in order, and
        empty the list.  The one place that waits for the device."""
        for t, out in pending:
            out = FrameOutput(*(x.cpu() for x in out))
            ok = bool(out.ok) and t != 0  # the reference skips frame 0
            tr = out.tr.numpy()
            jump = _motion_jump(tr, ok, self.motions, self.oks)
            self.motions.append(tr)
            self.oks.append(ok)
            self.stats.append({
                "frame": t, "ok": ok,
                "num_kp1": int(out.num_kp1), "num_lr": int(out.num_lr),
                "num_circle": int(out.num_circle),
                "num_inliers": int(out.num_inliers),
                "reproj_rms": float(out.rms),
                "sharpness": float(out.sharpness), "motion_jump": jump,
            })
        pending.clear()

    def motions_array(self):
        return (np.stack(self.motions) if self.motions
                else np.zeros((0, 6), np.float32))

    def result(self, processed: int) -> SequenceResult:
        if not self.motions:
            return SequenceResult(poses=np.zeros((0, 4, 4)),
                                  motions=np.zeros((0, 6)),
                                  frame_ok=np.zeros((0,), bool), stats=[],
                                  processed=0)
        motions = self.motions_array()
        oks = np.asarray(self.oks, bool)
        Ts = pose_vector_to_matrix(torch.from_numpy(motions))
        poses = chain_motions(Ts, torch.from_numpy(oks)).numpy()
        return SequenceResult(poses=poses, motions=motions, frame_ok=oks,
                              stats=self.stats, processed=processed)


def sequence_result(outs) -> SequenceResult:
    """SequenceResult of one sequence's per-frame outputs, frame 0 first
    (the multi-stream and pool loops build their results here)."""
    hist = History()
    hist.flush(list(enumerate(outs)))
    return hist.result(processed=len(outs))
