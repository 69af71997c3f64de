"""Monocular calibrated SfM / visual odometry (port of
``libviso_tpu/pipeline/mono.py``).

Per frame: detect and describe -> short-radius temporal match -> normalize
through K^-1 -> batched-RANSAC essential matrix (Nister 5-point by
default) -> epipolar re-match under the induced F = K^-T E K^-1 -> the
essential matrix again on the re-matched set -> (R, t) by cheirality
voting and a Sampson-error polish -> the scale of this step relative to
the previous one, from the landmarks both steps triangulate.  The host
chains the steps' unit translations by the propagated scale, so the
trajectory is right up to one global scale.

The step runs eagerly on the device of its inputs; the two RANSAC draws
of a frame are an argument, so a run's draws can be fixed from outside
(the parity tests feed the JAX package's).  The run keeps every per-frame
output on the device until ``chain_mono_outputs`` reads them at the end.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, NamedTuple, Optional

import numpy as np
import torch

from libviso_torch.config import MatchConfig, MonoConfig, PipelineConfig
from libviso_torch.geometry.essential import (
    depth_log_grads,
    normalize_points,
    pnp_refine_pose,
    ransac_essential,
    recover_pose,
    refine_relative_pose,
    three_view_bundle,
    two_view_depths,
    undistort_points,
)
from libviso_torch.geometry.mvg import e2h
from libviso_torch.ops.features import Keypoints, detect_and_describe
from libviso_torch.ops.matching import (
    check_backend,
    check_match_supported,
    match_descriptors,
)
from libviso_torch.pipeline.stereo import (
    hold_state_on_failure,
    rebuild_state,
    resolve_device,
    state_leaves,
)
from libviso_torch.solvers.ransac import frame_generator, sample_gumbel
from libviso_torch.utils.stats import masked_median, masked_quantile


class MonoState(NamedTuple):
    kp: Keypoints
    desc: torch.Tensor
    # landmark depth per keypoint slot in this frame's camera, in units of
    # the step that produced it (unit-norm translation)
    depth: torch.Tensor        # (N,) float
    depth_valid: torch.Tensor  # (N,) bool
    # sin(triangulation angle) of the producing pair
    parallax: torch.Tensor     # (N,) float
    # d log(depth) / d (5-dof pose error of the producing pair)
    depth_grad: torch.Tensor   # (N, 5) float
    # the producing pair's other observation (normalized, in the frame
    # before this one) and its pose: the 'bundle' estimator's inputs
    obs_prev: torch.Tensor     # (N, 2) float
    R_pair: torch.Tensor       # (3, 3) float
    t_pair: torch.Tensor       # (3,) float, |t| = 1
    # consecutive solves failed while this state was held as the match
    # target (cfg.keep_features_on_failure; always 0 otherwise)
    fail_age: torch.Tensor     # () int32


class MonoOutput(NamedTuple):
    transform: torch.Tensor    # (4, 4) current -> previous camera, |t| = 1
    ok: torch.Tensor           # () bool
    num_matches: torch.Tensor  # () temporal matches
    num_inliers: torch.Tensor  # () support of the second essential matrix
    # this step's translation scale in units of the previous step's:
    # inf when the shared-landmark support is empty (the host gates on
    # scale_support)
    scale_ratio: torch.Tensor  # () float
    scale_support: torch.Tensor
    sharpness: torch.Tensor    # () mean Harris response of the corners
    # frames this transform spans: 1, or 1 + the failures a held state
    # bridged (keep_features_on_failure)
    span: torch.Tensor         # () int32


def empty_mono_state(cfg: PipelineConfig, device="cpu",
                     dtype=torch.float32) -> MonoState:
    """All-invalid state for the first frame."""
    n = cfg.detector.num_slots
    d = cfg.detector.descriptor_dim_padded
    z = lambda *s: torch.zeros(s, dtype=dtype, device=device)  # noqa: E731
    no = torch.zeros(n, dtype=torch.bool, device=device)
    return MonoState(
        kp=Keypoints(xy=z(n, 2), response=z(n), valid=no), desc=z(n, d),
        depth=z(n), depth_valid=no, parallax=z(n), depth_grad=z(n, 5),
        obs_prev=z(n, 2), R_pair=torch.eye(3, dtype=dtype, device=device),
        t_pair=torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=device),
        fail_age=torch.zeros((), dtype=torch.int32, device=device))


def mono_state_from_jax(leaves, device="cpu") -> MonoState:
    """The port's MonoState on ``device`` from the numpy leaves of the JAX
    package's MonoState (``jax.tree_util.tree_leaves`` order: kp (xy,
    response, valid), desc, depth, depth_valid, parallax, depth_grad,
    obs_prev, R_pair, t_pair, fail_age), in the port's dtypes."""
    template = empty_mono_state(PipelineConfig(), "cpu")
    return rebuild_state(template, (
        torch.tensor(np.asarray(v)).to(device=device, dtype=like.dtype)
        for v, like in zip(leaves, state_leaves(template))))


def _pair_parallax(R, x1, x2):
    """sin(triangulation angle) per correspondence: the angle between the
    camera-2 ray and the camera-1 ray rotated into camera 2."""
    r1 = e2h(x1) @ R.T
    r1 = r1 / torch.linalg.vector_norm(r1, dim=-1, keepdim=True)
    h2 = e2h(x2)
    r2 = h2 / torch.linalg.vector_norm(h2, dim=-1, keepdim=True)
    return torch.linalg.vector_norm(torch.linalg.cross(r2, r1, dim=-1),
                                    dim=-1)


def mono_hypotheses(mono: MonoConfig):
    """(first pass's, second pass's) RANSAC sample counts."""
    n_hyp = mono.resolved_hypotheses()
    fp_method = (mono.method if mono.first_pass == "same"
                 else mono.first_pass)
    fp_hyp = (n_hyp if fp_method == mono.method else dataclasses.replace(
        mono, method=fp_method).resolved_hypotheses())
    return fp_hyp, n_hyp


def mono_draws(seed: int, t: int, shape1, shape2):
    """Frame t's two RANSAC draws (est1, est2) from ``frame_generator(seed,
    t)`` on the CPU: they depend on (seed, t) only."""
    g = frame_generator(seed, t)
    return sample_gumbel(shape1, g), sample_gumbel(shape2, g)


def rematch_config(cfg: PipelineConfig, mono: MonoConfig) -> MatchConfig:
    """The epipolar re-match: the temporal radius and metric, the stereo
    matcher's Sampson gate under the induced F, and the ratio test."""
    return dataclasses.replace(
        cfg.stereo_match, radius=cfg.temporal_match.radius,
        use_epipolar=True, use_ratio=True, ratio=mono.rematch_ratio,
        metric=cfg.temporal_match.metric)


def build_mono_step(K, cfg: PipelineConfig, mono: MonoConfig = None,
                    backend: str = "dense", D=None, null_basis=None,
                    on_stage: Optional[Callable[[str], None]] = None):
    """step(state, im, draws) -> (new_state, MonoOutput).

    ``draws`` is the frame's pair of Gumbel scores (est1 (H1, N), est2
    (H2, N), ``mono_hypotheses``); ``backend`` the matcher route ("dense",
    "fused" or "sweep"; the last two need metric 'l1'); ``D`` an optional
    (k1, k2, p1, p2) lens distortion; ``null_basis`` the 5-point solver's
    test seam (``geometry/five_point.py``).  ``on_stage(name)``, when
    given, is called after each stage ("frontend", "match", "est1",
    "rematch", "est2", "scale"), for timing.
    """
    mono = mono or MonoConfig()
    rematch_cfg = rematch_config(cfg, mono)
    for mc in (cfg.temporal_match, rematch_cfg):
        check_backend(backend, mc.metric)
        check_match_supported(mc)
    fp_hyp, n_hyp = mono_hypotheses(mono)
    fp_method = (mono.method if mono.first_pass == "same"
                 else mono.first_pass)
    K = np.asarray(K, np.float64)
    Kinv = np.linalg.inv(K)
    consts = {}

    def on(device):
        # K, K^-1 and D as float32 tensors, once per device
        if device not in consts:
            f32 = dict(dtype=torch.float32, device=device)
            consts[device] = (
                torch.tensor(K, **f32), torch.tensor(Kinv.T, **f32),
                torch.tensor(Kinv, **f32),
                None if D is None else torch.tensor(np.asarray(D), **f32))
        return consts[device]

    def mark(name):
        if on_stage is not None:
            on_stage(name)

    def ransac(x1, x2, valid, gumbel, hyp, method):
        return ransac_essential(
            x1, x2, valid=valid, gumbel=gumbel, num_hypotheses=hyp,
            sampson_thresh=mono.sampson_thresh, method=method,
            scoring=mono.scoring, soft_refit=mono.soft_refit,
            null_basis=null_basis)

    def step(state: MonoState, im, draws):
        Kt, KinvT, Kinv_t, Dt = on(im.device)

        def norm(x):
            if Dt is None:
                return normalize_points(x, Kt)
            return undistort_points(x, Kt, Dt)

        g1, g2 = draws
        kp, d = detect_and_describe(im, cfg.detector)
        mark("frontend")
        m = match_descriptors(kp, d, state.kp, state.desc,
                              cfg.temporal_match, backend=backend)
        mark("match")
        n_slots = cfg.detector.num_slots
        xn_cur = norm(kp.xy)
        xn_prev = norm(state.kp.xy[torch.clamp(m.idx, 0, n_slots - 1)])
        # est1 feeds only the re-match gate (its E -> F) and a sanity flag
        est1 = ransac(xn_cur, xn_prev, m.valid, g1, fp_hyp, fp_method)
        mark("est1")
        F = (KinvT @ est1.E) @ Kinv_t
        m2 = match_descriptors(kp, d, state.kp, state.desc, rematch_cfg,
                               F=F, backend=backend)
        mark("rematch")
        idx2_safe = torch.clamp(m2.idx, 0, n_slots - 1)
        xn_cur2 = xn_cur
        xn_prev2 = norm(state.kp.xy[idx2_safe])
        est2 = ransac(xn_cur2, xn_prev2, m2.valid, g2, n_hyp, mono.method)
        mark("est2")

        R, t, good, n_good = recover_pose(est2.E, xn_cur2, xn_prev2,
                                          valid=est2.inliers)
        dtype = xn_cur2.dtype
        if mono.refine_iters > 0:
            w_ref = (est2.inliers & good & m2.valid).to(dtype)
            R, t = refine_relative_pose(R, t, xn_cur2, xn_prev2, w_ref,
                                        iters=mono.refine_iters)
            z1r, z2r = two_view_depths(R, t, xn_cur2, xn_prev2)
            good = (z1r > 0) & (z2r > 0) & m2.valid
            n_good = (good & est2.inliers).sum()
        ok = est1.ok & est2.ok & (n_good >= mono.min_good)

        # relative-scale evidence: x1 = cur, x2 = prev, so z_prev is the
        # landmark depth in the previous camera in this step's units
        z_cur, z_prev = two_view_depths(R, t, xn_cur2, xn_prev2)
        par = _pair_parallax(R, xn_cur2, xn_prev2)
        pts_good = good & est2.inliers & m2.valid
        prev_depth = state.depth[idx2_safe]
        prev_dv = state.depth_valid[idx2_safe] & m2.valid
        ratio = prev_depth / torch.clamp(z_prev, min=1e-9)
        rv_all = (pts_good & prev_dv & (z_prev > 1e-6)
                  & torch.isfinite(ratio) & (ratio > 1e-2) & (ratio < 1e2))
        # keep the landmarks whose triangulation angle is large in both
        # the producing and the current pair
        cond = torch.minimum(state.parallax[idx2_safe], par)
        thresh = masked_quantile(cond, rv_all, 1.0 - mono.parallax_keep_frac)
        rv = rv_all & (cond >= thresh)
        scale_support = rv.sum()
        # robust location of the log ratio: median seed, then a MAD-gated
        # IRLS mean
        y_log = torch.log(torch.clamp(ratio, 1e-3, 1e3))
        mu = torch.log(torch.clamp(masked_median(ratio, rv), 1e-3, 1e3))
        rv_f = rv.to(dtype)
        for _ in range(4):
            mad = masked_median((y_log - mu).abs(), rv)
            c = torch.clamp(3.0 * 1.4826 * mad, min=0.02)
            w_s = rv_f * ((y_log - mu).abs() <= c)
            mu = (w_s * y_log).sum() / torch.clamp(w_s.sum(), min=1.0)

        est = mono.scale_estimator
        if est != "bundle":
            g1_, g2_ = depth_log_grads(R, t, xn_cur2, xn_prev2)
        if est == "median":
            scale_ratio = torch.exp(mu)
        elif est == "bundle":
            # pair 1 anchored at frame t-1 with |t1| = 1, pair 2's
            # translation free: |t2| is the scale ratio
            z0 = torch.where(prev_dv, torch.clamp(prev_depth, min=1e-3),
                             torch.clamp(z_prev, min=1e-3) * torch.exp(mu))
            _, _, R_b, t_b, _ = three_view_bundle(
                state.R_pair, state.t_pair, state.obs_prev[idx2_safe],
                R, t * torch.exp(mu), xn_prev2, xn_cur2, z0,
                rv_all.to(dtype), iters=mono.bundle_iters)
            s_b = torch.linalg.vector_norm(t_b)
            bundle_ok = (torch.isfinite(s_b) & (s_b > 1e-6)
                         & (rv_all.sum() >= 12))
            R = torch.where(bundle_ok, R_b, R)
            t = torch.where(bundle_ok, t_b / torch.clamp(s_b, min=1e-12), t)
            scale_ratio = torch.where(bundle_ok, s_b, torch.exp(mu))
        elif est == "regression":
            # y_i = log s + g_prev_i . d_{t-1} - g_cur_i . d_t to first
            # order: fit the two pairs' pose-error warps out of log s,
            # ridge on the 10 warp coefficients
            A = torch.cat([torch.ones_like(y_log)[:, None],
                           state.depth_grad[idx2_safe], -g2_], dim=1)
            beta = torch.zeros(11, dtype=dtype, device=A.device)
            beta = torch.cat([mu[None], beta[1:]])
            ridge = torch.ones(11, dtype=dtype, device=A.device)
            ridge[0] = 0.0
            for _ in range(4):
                r = y_log - A @ beta
                mad = masked_median(r.abs(), rv)
                c = torch.clamp(3.0 * 1.4826 * mad, min=0.02)
                w_s = rv_f * (r.abs() <= c)
                Aw = A * w_s[:, None]
                H = A.T @ Aw
                lam = 1e-3 * torch.trace(H) / 11.0 + 1e-9
                H = H + lam * torch.diag(ridge)
                b = (Aw * y_log[:, None]).sum(0)
                cand = torch.linalg.solve_ex(H, b).result
                beta = torch.where(torch.isfinite(cand).all(), cand, beta)
            scale_ratio = torch.exp(beta[0])
        else:  # 'pnp': |t| of the motion-only PnP optimum
            X_prev = prev_depth[:, None] * e2h(xn_prev2)
            _, tp = pnp_refine_pose(R, t * torch.exp(mu), X_prev, xn_cur2,
                                    rv_all.to(dtype), iters=mono.pnp_iters)
            scale_ratio = torch.linalg.vector_norm(tp)

        if est == "bundle":
            # the bundle may have moved (R, t): refresh what the next step
            # reads
            z_cur, z_prev = two_view_depths(R, t, xn_cur2, xn_prev2)
            par = _pair_parallax(R, xn_cur2, xn_prev2)
            g1_, _ = depth_log_grads(R, t, xn_cur2, xn_prev2)
            pts_good = ((z_cur > 0) & (z_prev > 0) & est2.inliers
                        & m2.valid)
        mark("scale")

        # current -> previous camera: the factor the host chains
        T = torch.cat([torch.cat([R, t[:, None]], dim=1),
                       torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=R.dtype,
                                    device=R.device)], dim=0)
        # depths of a failed step would make the next ratio wrong by a
        # step factor: only an accepted step's evidence is kept
        new_state = MonoState(
            kp=kp, desc=d,
            depth=torch.where(pts_good, z_cur, 0.0),
            depth_valid=pts_good & (z_cur > 1e-6) & ok,
            parallax=torch.where(pts_good, par, 0.0),
            depth_grad=torch.where(pts_good[:, None], g1_, 0.0),
            obs_prev=torch.where(pts_good[:, None], xn_prev2, 0.0),
            R_pair=R, t_pair=t,
            fail_age=torch.zeros_like(state.fail_age))
        if cfg.keep_features_on_failure:
            new_state = hold_state_on_failure(
                state, new_state, ok, state.kp.valid.any(), cfg.max_keep_age)
        n_kp = kp.valid.sum()
        return new_state, MonoOutput(
            transform=T, ok=ok, num_matches=m.valid.sum(),
            num_inliers=est2.num_inliers, scale_ratio=scale_ratio,
            scale_support=scale_support,
            sharpness=(torch.where(kp.valid, kp.response, 0.0).sum()
                       / torch.clamp(n_kp, min=1)),
            span=state.fail_age + 1)

    return step


def build_mono_chunk(K, cfg: PipelineConfig, chunk: int,
                     mono: MonoConfig = None, backend: str = "dense", D=None,
                     null_basis=None):
    """chunk_step(state, ims, draws) -> (new_state, MonoOutput stacked over
    the leading chunk axis): ``chunk`` consecutive steps of
    ``build_mono_step`` on one uploaded (chunk, H, W) stack, ``draws`` a
    sequence of the frames' draw pairs.  The state is threaded through,
    so the outputs equal ``chunk`` separate steps bit for bit."""
    step = build_mono_step(K, cfg, mono=mono, backend=backend, D=D,
                           null_basis=null_basis)

    def chunk_step(state: MonoState, ims, draws):
        if not len(ims) == len(draws) == chunk:
            raise ValueError(f"chunk_step built for {chunk} frames")
        outs = []
        for im, dr in zip(ims, draws):
            state, out = step(state, im, dr)
            outs.append(out)
        return state, MonoOutput(*(torch.stack(xs) for xs in zip(*outs)))

    return chunk_step


@dataclasses.dataclass
class MonoResult:
    poses: np.ndarray     # (T, 4, 4), right up to one global scale
    frame_ok: np.ndarray  # (T,) bool
    stats: list
    speeds: np.ndarray = None   # (T,) translation norm applied per step


def run_mono_sequence(frames: Iterable, K, cfg: PipelineConfig = None,
                      seed: int = 0, device="cuda", backend: str = "dense",
                      mono: MonoConfig = None, method: str = None, D=None,
                      draws: Optional[Callable[[int], tuple]] = None,
                      null_basis=None, on_frame=None) -> MonoResult:
    """Stream single-camera frames through the mono step on ``device``.

    Args:
      frames: iterable of (H, W) uint8/float images.
      K: 3x3 intrinsics; ``D`` optional (k1, k2, p1, p2) distortion.
      cfg: pipeline configuration, ``PipelineConfig.mono()`` by default.
      mono: estimator configuration; ``method`` overrides its solver.
      backend: the matcher route (``ops/matching.py``).
      draws: optional callable t -> (est1 draws, est2 draws) (a test seam);
        by default frame t's come from ``mono_draws(seed, t, ...)`` on the
        CPU, so a run on the card and one on the CPU see the same draws.
      null_basis: the 5-point solver's test seam.
      on_frame: optional callback(t, MonoOutput), tensors on the device.
    """
    device = resolve_device(device)
    cfg = cfg or PipelineConfig.mono()
    mono = mono or MonoConfig()
    if method is not None:
        mono = dataclasses.replace(mono, method=method)
    step = build_mono_step(K, cfg, mono=mono, backend=backend, D=D,
                           null_basis=null_basis)
    if draws is None:
        n = cfg.detector.num_slots
        h1, h2 = mono_hypotheses(mono)
        draws = lambda t: mono_draws(seed, t, (h1, n), (h2, n))  # noqa: E731
    state = empty_mono_state(cfg, device)
    # outputs stay on the device until the end: reading one inside the
    # loop would make every step wait for the one before
    outs = []
    for t, im in enumerate(frames):
        g1, g2 = draws(t)
        state, out = step(state, torch.tensor(np.asarray(im), device=device),
                          (g1.to(device), g2.to(device)))
        outs.append(out)
        if on_frame is not None:
            on_frame(t, out)
    poses, oks, speeds, stats = chain_mono_outputs(outs, mono)
    return MonoResult(poses=poses, frame_ok=oks, stats=stats, speeds=speeds)


def chain_mono_outputs(outs, mono: MonoConfig):
    """Chain per-frame MonoOutputs into a trajectory on the host: the one
    place that reads the outputs back.  Step t's unit translation is
    scaled by the running speed times its measured scale ratio when the
    ratio's support suffices, else by the last accepted speed per frame of
    span (constant velocity).

    Returns (poses (T, 4, 4), frame_ok (T,), speeds (T,), stats list);
    speeds[t] is the translation norm applied at step t (0 where failed).
    """
    if not outs:
        return np.zeros((0, 4, 4)), np.zeros(0, bool), np.zeros(0), []
    host = MonoOutput(*(torch.stack(xs).cpu().numpy()
                        for xs in zip(*outs)))
    pose = np.eye(4)
    speed = 1.0
    last_span = 1
    poses, oks, stats, speeds = [], [], [], []
    for t in range(len(outs)):
        out = MonoOutput(*(x[t] for x in host))
        ok = bool(out.ok) and t > 0
        support = int(out.scale_support)
        ratio = float(out.scale_ratio)
        span = int(out.span)
        if (mono.scale_propagation and ok
                and support >= mono.min_scale_support
                and np.isfinite(ratio) and 1e-2 < ratio < 1e2):
            scale_t = speed * ratio
        else:
            scale_t = speed * span / last_span
        if ok:
            T = out.transform.copy()
            T[:3, 3] *= scale_t
            pose = pose @ T
            speed = scale_t
            last_span = span
        poses.append(pose.copy())
        oks.append(ok)
        speeds.append(scale_t if ok else 0.0)
        stats.append({
            "frame": t, "ok": ok,
            "num_matches": int(out.num_matches),
            "num_inliers": int(out.num_inliers),
            "scale_support": support,
            "scale_ratio": ratio if np.isfinite(ratio) else None,
            "speed": speed if ok else None,
            "span": span,
            "sharpness": float(out.sharpness),
        })
    return (np.stack(poses), np.asarray(oks, bool), np.asarray(speeds),
            stats)
