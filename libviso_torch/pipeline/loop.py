"""Loop closure: revisit detection and pose-graph drift removal (port of
``libviso_tpu/pipeline/loop.py``).

  1. every ``keyframe_every``-th frame, the step's FrameState is
     summarized to a compact keyframe: the ``keyframe_budget`` strongest
     usable corners' descriptors, stereo observations and 3D points;
  2. each new keyframe is matched against all stored keyframes as one
     ``match_problem_batch`` call (no position gate: drift makes positions
     useless across a loop; the ratio test does the work), so on the card
     one launch of the backend's kernel over (max_keyframes, budget, D);
  3. a candidate with ``min_matches`` matches and ``min_gap`` frames of
     separation is verified by the per-frame RANSAC + GN solver on the old
     keyframe's 3D against the new keyframe's observations, then refined
     twice by a radius-gated guided re-match under the candidate pose
     (one ``match_descriptors`` call each, mutual in the second round);
  4. the odometry and every verified loop edge form a pose graph over the
     keyframe nodes (``solvers/pose_graph.py``); the frames in between
     re-anchor to their node.

The keyframe store is a fixed-shape device tensor with a validity mask;
its 3D points, frames and positions stay on the host, as in the JAX
package.  The host code that orders and filters candidates is the JAX
package's numpy, so equal values give the same order.

Draws: frame t's RANSAC draws come from ``frame_generator(seed, t)``, a
verification solve's from ``frame_generator(seed, 1_000_000 + t)`` and
refinement round ``it``'s from ``frame_generator(seed, 2_000_000 + 2 t +
it)``, as the JAX package folds those indices into its key; both are
seams (``draws``, ``verify_draws``) through which the tests feed the JAX
package's draws.  A resumed run is bit-exact.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from libviso_torch.config import Calib, PipelineConfig
from libviso_torch.geometry.mvg import F_from_P_host
from libviso_torch.geometry.se3 import (
    invert_se3,
    matrix_to_pose_vector,
    pose_vector_to_matrix,
)
from libviso_torch.ops.features import Keypoints
from libviso_torch.ops.matching import match_descriptors, match_problem_batch
from libviso_torch.ops.topk import topk_sorted
from libviso_torch.pipeline.stereo import (
    History,
    build_frame_step,
    empty_state,
    resolve_device,
    state_from_leaves,
    state_to_leaves,
)
from libviso_torch.solvers.pose_graph import (
    optimize_pose_graph,
    reanchor_segments,
)
from libviso_torch.solvers.ransac import (
    frame_generator,
    ransac_pose,
    sample_gumbel,
)


class LoopEdge(NamedTuple):
    frame_new: int        # later frame (the revisit)
    frame_old: int        # earlier frame being re-observed
    tr: np.ndarray        # (6,) motion old -> new (ransac convention)
    num_inliers: int
    num_matches: int


@dataclasses.dataclass
class LoopClosureResult:
    poses: np.ndarray       # (T, 4, 4) pose-graph-optimized trajectory
    poses_vo: np.ndarray    # (T, 4, 4) open-chain VO trajectory
    motions: np.ndarray     # (T, 6) VO motions
    frame_ok: np.ndarray    # (T,)
    loops: list             # [LoopEdge]
    graph_cost: tuple       # (initial, final) pose-graph cost
    # final robust IRLS weight per loop edge (aligned with `loops`): ~1
    # believed, ~0 disbelieved by the Cauchy kernel
    loop_edge_scale: np.ndarray = None
    # every candidate that reached geometric verification:
    # {frame_new, frame_old, score, ok, num_inliers, refined_inliers, ...}
    candidates: list = None
    processed: int = 0      # frames computed in this run
    keyframes_offered: int = 0
    evictions: int = 0
    store_skipped: int = 0
    stats: list = None      # per-frame dicts, as run_stereo_sequence's


def summarize_keyframe(xy1, xy2, desc_all, response, usable, mlr_idx,
                       X_all, budget: int, desc_dim: int,
                       normalize: bool):
    """Compact keyframe from per-frame slot tensors: the ``budget``
    highest-response usable slots (lowest index among equal responses)
    -> (xy (budget, 2), desc (budget, D), obs (budget, 4), X (budget, 3),
    valid (budget,)).

    Front-end agnostic: the streaming driver feeds FrameState fields;
    the composed BA + loop driver feeds track rows.  ``normalize``
    re-signs the descriptors as zero-mean unit-L2 vectors over their real
    ``desc_dim`` values (the padding stays zero), times 1024: revisit
    detection then survives a gain change between visits.
    """
    score = torch.where(usable, response,
                        torch.full_like(response, float("-inf")))
    _, top = topk_sorted(score, budget)
    valid = usable[top]
    desc = desc_all[top]
    if normalize:
        d = desc[:, :desc_dim]
        d = d - d.mean(-1, keepdim=True)
        d = d / torch.clamp(torch.linalg.vector_norm(d, dim=-1,
                                                     keepdim=True), min=1e-6)
        desc = torch.cat([d * 1024.0, torch.zeros_like(desc[:, desc_dim:])],
                         dim=-1)
    r_safe = torch.clamp(mlr_idx[top], 0, xy2.shape[0] - 1)
    obs = torch.cat([xy1[top], xy2[r_safe]], dim=-1)
    return xy1[top], desc, obs, X_all[top], valid


def _build_summarize(budget: int, desc_dim: int, normalize: bool):
    """FrameState -> compact keyframe (``summarize_keyframe``); usable
    slots are detected, stereo-matched and triangulated."""

    def summarize(state):
        return summarize_keyframe(
            state.kp1.xy, state.kp2.xy, state.d1, state.kp1.response,
            state.kp1.valid & state.X_valid, state.match_lr, state.X,
            budget, desc_dim, normalize)

    return summarize


def _build_candidate_matcher(cfg: PipelineConfig, max_kf: int,
                             budget: int, backend: str, ratio: float):
    """match_all(q_xy, q_desc, q_valid, kf_xy, kf_desc, kf_valid) ->
    (idx (K, budget), valid (K, budget), scores (K,) int32): the new
    keyframe against the whole store as one batch of ``max_kf`` problems.

    ``ratio`` is stricter than the temporal matcher's: with no position
    gate the candidate pool is the whole store, and the aliased-match
    floor grows with it.
    """
    d = cfg.detector.descriptor_dim_padded

    def match_all(q_xy, q_desc, q_valid, kf_xy, kf_desc, kf_valid):
        K, dev = max_kf, q_desc.device
        res = match_problem_batch(
            q_xy=q_xy.expand(K, budget, 2).contiguous(),
            q_valid=q_valid.expand(K, budget).contiguous(),
            q_d=q_desc.expand(K, budget, d).contiguous(),
            t_xy=kf_xy, t_valid=kf_valid, t_d=kf_desc,
            use_epi=torch.zeros(K, dtype=torch.bool, device=dev),
            use_rat=torch.ones(K, dtype=torch.bool, device=dev),
            ratios=torch.full((K,), ratio, dtype=q_desc.dtype, device=dev),
            radius=1e9,   # drift makes positions meaningless across loops
            sampson_thresh=1.0, metric=cfg.temporal_match.metric,
            F=torch.eye(3, dtype=q_desc.dtype, device=dev), backend=backend)
        return res.idx, res.valid, res.valid.sum(1, dtype=torch.int32)

    return match_all


def _build_guided_matcher(cfg: PipelineConfig, budget: int, backend: str,
                          calib: Calib, radius: float):
    """guided(tr, X_old, d_old, v_old, kp_new_xy, d_new, v_new) -> (idx,
    valid, dist): the old keyframe's landmarks projected into the new view
    under a candidate pose, then a radius-gated match (no ratio test)
    against the new keyframe: one ``match_descriptors`` call."""
    mc = dataclasses.replace(cfg.temporal_match, radius=radius,
                             use_epipolar=False, use_ratio=False)

    def guided(tr, X_old, d_old, v_old, kp_new_xy, d_new, v_new):
        T = pose_vector_to_matrix(tr)
        Xn = X_old @ T[:3, :3].T + T[:3, 3]
        z = torch.clamp(Xn[:, 2], min=1e-3)
        proj = torch.stack([calib.f * Xn[:, 0] / z + calib.cu,
                            calib.f * Xn[:, 1] / z + calib.cv], dim=-1)
        zeros = torch.zeros(budget, dtype=proj.dtype, device=proj.device)
        kq = Keypoints(xy=proj, response=zeros,
                       valid=v_old & (Xn[:, 2] > 0.1))
        kt = Keypoints(xy=kp_new_xy, response=zeros, valid=v_new)
        res = match_descriptors(kq, d_old, kt, d_new, mc,
                                F=torch.eye(3, dtype=proj.dtype,
                                            device=proj.device),
                                backend=backend)
        return res.idx, res.valid, res.dist

    return guided


def _spatial_evict_slot(pos_stored, frames_stored, pos_new):
    """The store slot to overwrite so the keyframe set stays a coverage of
    the trajectory: among the closest pair of stored positions (the new
    keyframe a candidate too), the newer member.  Returns the slot, or -1
    to skip storing the new keyframe (it was the redundant one).  The JAX
    package's numpy, line for line."""
    pos = np.concatenate([pos_stored, pos_new[None]], axis=0)
    fr = np.concatenate([frames_stored, [np.iinfo(np.int64).max]])
    d2 = np.sum((pos[:, None, :] - pos[None, :, :]) ** 2, axis=-1)
    np.fill_diagonal(d2, np.inf)
    i, j = np.unravel_index(np.argmin(d2), d2.shape)
    victim = i if fr[i] > fr[j] else j
    return -1 if victim == len(pos_stored) else int(victim)


class LoopStoreState(NamedTuple):
    """A LoopEngine's keyframe store and accepted loops."""

    kf_xy: torch.Tensor      # (max_keyframes, budget, 2) on the device
    kf_desc: torch.Tensor    # (max_keyframes, budget, D) on the device
    kf_valid: torch.Tensor   # (max_keyframes, budget) bool on the device
    kf_X: np.ndarray         # (max_keyframes, budget, 3) float32
    kf_frames: np.ndarray    # (max_keyframes,) int64, -1 = empty
    n_kf: int                # keyframes offered so far
    kf_pos: np.ndarray       # (max_keyframes, 3) float32 VO positions
    loops: list              # [LoopEdge]


def loop_state_from_jax(leaves, loop_stats, device="cpu") -> LoopStoreState:
    """The port's store from the JAX ``LoopEngine.state_leaves()`` (numpy,
    in its order: kf_xy, kf_desc, kf_valid, kf_X, kf_frames, [n_kf],
    kf_pos) and ``loop_stats()``; the port's own ``state_leaves`` and
    ``loop_stats`` have the same layout (a checkpoint's)."""
    kf_xy, kf_desc, kf_valid, kf_X, kf_frames, n_kf, kf_pos = leaves

    def dev(x, dtype):
        return torch.tensor(np.asarray(x)).to(device=device, dtype=dtype)

    return LoopStoreState(
        kf_xy=dev(kf_xy, torch.float32), kf_desc=dev(kf_desc, torch.float32),
        kf_valid=dev(kf_valid, torch.bool),
        kf_X=np.array(kf_X, np.float32), kf_frames=np.array(kf_frames,
                                                            np.int64),
        n_kf=int(np.asarray(n_kf)[0]), kf_pos=np.array(kf_pos, np.float32),
        loops=[LoopEdge(frame_new=s["new"], frame_old=s["old"],
                        tr=np.asarray(s["tr"], np.float32),
                        num_inliers=s["inliers"], num_matches=s["matches"])
               for s in loop_stats])


class LoopEngine:
    """Keyframe store, revisit detection and geometric verification, apart
    from the front-end that summarizes keyframes: the streaming driver
    (``run_with_loop_closure``) and the windowed-BA front-end feed it.

    ``seed`` derives the verification draws (module docstring);
    ``verify_draws(t, it)`` replaces them: (H, budget) Gumbel scores for
    frame t's seed solve (``it`` None) and refinement rounds 0 and 1.
    """

    def __init__(self, cfg: PipelineConfig, calib: Calib, seed: int = 0, *,
                 keyframe_every=5, min_gap=20, min_matches=60,
                 min_inliers=30, max_keyframes=128, keyframe_budget=256,
                 min_seed_inliers=7, guided_radius=16.0,
                 verify_top_k=3, loop_match_ratio=0.8,
                 eviction="spatial", backend="dense", device="cuda",
                 verify_draws: Optional[Callable] = None):
        if eviction not in ("spatial", "fifo"):
            raise ValueError(f"eviction must be 'spatial' or 'fifo', "
                             f"got {eviction!r}")
        self.device = resolve_device(device)
        # a budget larger than the slot tensor is a no-op, not an error
        keyframe_budget = min(keyframe_budget, cfg.detector.num_slots)
        self.cfg = cfg
        self.calib = calib.on(self.device)
        self.keyframe_every = keyframe_every
        self.min_gap = min_gap
        self.min_matches = min_matches
        self.min_inliers = min_inliers
        self.max_keyframes = max_keyframes
        self.keyframe_budget = keyframe_budget
        self.min_seed_inliers = min_seed_inliers
        self.verify_top_k = verify_top_k
        self.eviction = eviction
        self.match_all = _build_candidate_matcher(
            cfg, max_keyframes, keyframe_budget, backend, loop_match_ratio)
        # cross-loop verification sees far lower inlier fractions than the
        # per-frame solve: a wider hypothesis pool
        self.verify_ransac = dataclasses.replace(
            cfg.ransac, num_hypotheses=max(256, cfg.ransac.num_hypotheses),
            gn_lm_lambda=1e-3)
        shape = (self.verify_ransac.num_hypotheses, keyframe_budget)
        if verify_draws is None:
            def verify_draws(t, it):
                index = 1_000_000 + t if it is None else 2_000_000 + 2 * t + it
                return sample_gumbel(shape, frame_generator(seed, index))
        self.verify_draws = verify_draws
        self.guided = _build_guided_matcher(cfg, keyframe_budget, backend,
                                            self.calib, guided_radius)
        d = cfg.detector.descriptor_dim_padded
        dev = dict(device=self.device)
        self._set(LoopStoreState(
            kf_xy=torch.zeros((max_keyframes, keyframe_budget, 2), **dev),
            kf_desc=torch.zeros((max_keyframes, keyframe_budget, d), **dev),
            kf_valid=torch.zeros((max_keyframes, keyframe_budget),
                                 dtype=torch.bool, **dev),
            kf_X=np.zeros((max_keyframes, keyframe_budget, 3), np.float32),
            kf_frames=np.full((max_keyframes,), -1, np.int64), n_kf=0,
            kf_pos=np.zeros((max_keyframes, 3), np.float32), loops=[]))
        self.candidates: list = []
        # diagnostics (not checkpointed): spatial evictions, and new
        # keyframes skipped as the redundant member of the closest pair
        self.evicted = 0
        self.store_skipped = 0

    def _set(self, st: LoopStoreState):
        (self.kf_xy, self.kf_desc, self.kf_valid, self.kf_X,
         self.kf_frames, self.n_kf, self.kf_pos, self.loops) = st

    def _verify(self, t, it, X, obs, valid):
        return ransac_pose(X, obs, valid, self.calib, self.verify_ransac,
                           gumbel=self.verify_draws(t, it))

    def offer(self, t, xy, desc, obs, X, valid, pos_fn):
        """Process keyframe-cadence frame ``t``: search the store for a
        verified revisit (appending to ``self.loops`` / ``candidates``),
        then store the new keyframe.  ``pos_fn()`` returns the current
        trajectory position; it is called after verification."""
        budget = self.keyframe_budget
        dev = self.device
        if self.n_kf > 0:
            idxs, valids, scores = self.match_all(
                xy, desc, valid, self.kf_xy, self.kf_desc, self.kf_valid)
            scores = scores.cpu().numpy()
            gaps = t - self.kf_frames
            eligible = (self.kf_frames >= 0) & (gaps >= self.min_gap)
            scores = np.where(eligible, scores, -1)
            # verify the top-k candidates, not just the best: the raw
            # count has an aliasing floor; the first one that verifies wins
            order = np.argsort(-scores)[:self.verify_top_k]
            obs_host = None
            for best in (int(b) for b in order):
                if scores[best] < self.min_matches:
                    break
                # the old keyframe's 3D against the new keyframe's stereo
                # observations -> motion old -> new
                m_idx = idxs[best].cpu().numpy()
                m_valid = valids[best].cpu().numpy()
                safe = np.clip(m_idx, 0, budget - 1)
                Xp = self.kf_X[best][safe]
                pts_valid = m_valid & (m_idx >= 0)
                est = self._verify(t, None, torch.from_numpy(Xp).to(dev),
                                   obs, torch.from_numpy(pts_valid).to(dev))
                diag = {
                    "frame_new": t,
                    "frame_old": int(self.kf_frames[best]),
                    "score": int(scores[best]), "ok": bool(est.ok),
                    "num_inliers": int(est.num_inliers),
                    "refined_inliers": 0}
                self.candidates.append(diag)
                if not (bool(est.ok)
                        and int(est.num_inliers) >= self.min_seed_inliers):
                    continue
                # stage 2: guided re-match under the candidate pose and a
                # re-solve on the recovered support, twice; the second
                # round keeps only mutual pairs
                X_old = torch.from_numpy(self.kf_X[best]).to(dev)
                if obs_host is None:
                    obs_host = obs.cpu().numpy()
                est2 = est
                for it in range(2):
                    g_idx, g_valid, g_dist = self.guided(
                        est2.tr, X_old, self.kf_desc[best],
                        self.kf_valid[best], xy, desc, valid)
                    g_idx = g_idx.cpu().numpy()
                    safe2 = np.clip(g_idx, 0, budget - 1)
                    g_val = g_valid.cpu().numpy() & (g_idx >= 0)
                    # the best-descriptor quarter of the guided matches
                    # (16 to 48): true re-observations sit at the
                    # small-distance end, aliases swamp the rest
                    g_dist = np.where(g_val, g_dist.cpu().numpy(), np.inf)
                    keep = min(48, max(16, int(g_val.sum()) // 4))
                    thresh = np.partition(g_dist, keep - 1)[keep - 1]
                    g_val = g_val & (g_dist <= thresh)
                    if it > 0:
                        # reciprocal check under the once-refined pose
                        tr_inv = matrix_to_pose_vector(invert_se3(
                            pose_vector_to_matrix(est2.tr)))
                        r_idx, r_valid, _ = self.guided(
                            tr_inv, X, desc, valid, self.kf_xy[best],
                            self.kf_desc[best], self.kf_valid[best])
                        r_idx = r_idx.cpu().numpy()
                        mutual = (r_valid.cpu().numpy()[safe2]
                                  & (r_idx[safe2] == np.arange(budget)))
                        g_val = g_val & mutual
                    # g maps old slot -> new slot: the old 3D against the
                    # matched new observations
                    est2 = self._verify(
                        t, it, X_old,
                        torch.from_numpy(obs_host[safe2]).to(dev),
                        torch.from_numpy(g_val).to(dev))
                    diag.setdefault("refine_trace", []).append(
                        (int(g_val.sum()), int(est2.num_inliers)))
                diag["refined_inliers"] = int(est2.num_inliers)
                diag["refined_ok"] = bool(est2.ok)
                # gate on the refined inlier count, evaluated under the
                # refit pose, not on est2.ok's convergence flag
                if int(est2.num_inliers) >= self.min_inliers:
                    self.loops.append(LoopEdge(
                        frame_new=t, frame_old=int(self.kf_frames[best]),
                        tr=est2.tr.cpu().numpy(),
                        num_inliers=int(est2.num_inliers),
                        num_matches=int(scores[best])))
                    break

        # store the new keyframe; a full store evicts the most redundant
        # member ('spatial') or the oldest ('fifo')
        pos_t = pos_fn()
        if self.n_kf >= self.max_keyframes and self.eviction == "spatial":
            slot = _spatial_evict_slot(self.kf_pos, self.kf_frames, pos_t)
            if slot >= 0:
                self.evicted += 1
            else:
                self.store_skipped += 1
        else:
            slot = self.n_kf % self.max_keyframes
        if slot >= 0:
            self.kf_xy[slot] = xy
            self.kf_desc[slot] = desc
            self.kf_valid[slot] = valid
            self.kf_X[slot] = X.cpu().numpy()
            self.kf_frames[slot] = t
            self.kf_pos[slot] = pos_t
        self.n_kf += 1

    # ---- checkpoint plumbing, in the JAX package's leaf order ----

    def state_leaves(self):
        return [self.kf_xy.cpu().numpy(), self.kf_desc.cpu().numpy(),
                self.kf_valid.cpu().numpy(), self.kf_X.copy(),
                self.kf_frames.copy(), np.asarray([self.n_kf]),
                self.kf_pos.copy()]

    def restore(self, leaves, loop_stats):
        self._set(loop_state_from_jax(leaves, loop_stats, self.device))

    def loop_stats(self):
        return [{"new": le.frame_new, "old": le.frame_old,
                 "tr": np.asarray(le.tr).tolist(),
                 "inliers": le.num_inliers,
                 "matches": le.num_matches} for le in self.loops]


def close_graph(poses_vo, kf_frames, loops, loop_weight=20.0,
                robust="cauchy", robust_delta=0.05, device="cuda"):
    """Assemble and optimize the pose graph over a chained trajectory, on
    ``device`` (``"cuda"`` raises without a card; the CPU only when asked).

    The nodes are the keyframe frames, the endpoints and the loop
    frames; sequential node edges take their z from the chained
    trajectory, loop edges from the verified motions (edge (new, old) with
    z = T_new^-1 T_old, the robust kernel on them only); frames between
    nodes re-anchor to their segment's node.  Returns (poses, (cost0,
    cost), loop edge scales).
    """
    device = resolve_device(device)
    T = len(poses_vo)
    if not loops:
        return poses_vo, (0.0, 0.0), np.zeros((0,), np.float32)
    node_frames = np.asarray(sorted(
        {0, T - 1} | {int(f) for f in kf_frames if f >= 0}
        | {le.frame_new for le in loops} | {le.frame_old for le in loops}),
        np.int64)
    node_of = {int(f): k for k, f in enumerate(node_frames)}
    K = len(node_frames)
    P_nodes = torch.as_tensor(poses_vo[node_frames], device=device)
    ei = list(range(K - 1)) + [node_of[le.frame_new] for le in loops]
    ej = list(range(1, K)) + [node_of[le.frame_old] for le in loops]
    z = torch.cat([invert_se3(P_nodes[:-1]) @ P_nodes[1:],
                   pose_vector_to_matrix(torch.as_tensor(
                       np.stack([le.tr for le in loops]), device=device))])
    weights = torch.cat([torch.ones(K - 1, device=device),
                         torch.full((len(loops),), float(loop_weight),
                                    device=device)])
    is_loop = torch.arange(len(ei), device=device) >= K - 1
    res = optimize_pose_graph(P_nodes, ei, ej, z, weights=weights, iters=15,
                              robust=robust, robust_mask=is_loop,
                              robust_delta=robust_delta)
    poses = reanchor_segments(torch.as_tensor(poses_vo, device=device),
                              node_frames, res.poses)
    return (poses.cpu().numpy(), (float(res.cost0), float(res.cost)),
            res.edge_scale[K - 1:].cpu().numpy())


def run_with_loop_closure(frames, P1, P2,
                          cfg: PipelineConfig = PipelineConfig(),
                          keyframe_every: int = 5, min_gap: int = 20,
                          min_matches: int = 60, min_inliers: int = 30,
                          max_keyframes: int = 128,
                          keyframe_budget: int = 256,
                          min_seed_inliers: int = 7,
                          guided_radius: float = 16.0,
                          loop_weight: float = 20.0,
                          seed: int = 0,
                          backend: str = "dense",
                          verify_top_k: int = 3,
                          loop_match_ratio: float = 0.8,
                          robust: str = "cauchy",
                          robust_delta: float = 0.05,
                          normalize_desc: bool = True,
                          eviction: str = "spatial",
                          checkpoint=None,
                          fingerprint_scope: str = "",
                          dbg_dir=None, device="cuda",
                          draws: Optional[Callable] = None,
                          verify_draws: Optional[Callable] = None
                          ) -> LoopClosureResult:
    """Streaming VO, loop detection and pose-graph optimization on
    ``device``.

    Arguments as ``run_stereo_sequence``'s plus the loop knobs.
    ``checkpoint`` snapshots the frame state, the keyframe store and the
    loops (resume is bit-exact: every draw depends on the absolute frame
    index); ``dbg_dir`` writes the per-frame debug artifacts; ``draws(t)``
    and ``verify_draws(t, it)`` replace the per-frame and verification
    draws (test seams).  ``eviction`` governs a full store: 'spatial'
    keeps it a coverage of the trajectory (``_spatial_evict_slot``),
    'fifo' overwrites the oldest.  Returns the optimized and the
    open-chain trajectories.
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
    engine = LoopEngine(
        cfg, calib, seed, keyframe_every=keyframe_every, min_gap=min_gap,
        min_matches=min_matches, min_inliers=min_inliers,
        max_keyframes=max_keyframes, keyframe_budget=keyframe_budget,
        min_seed_inliers=min_seed_inliers, guided_radius=guided_radius,
        verify_top_k=verify_top_k, loop_match_ratio=loop_match_ratio,
        eviction=eviction, backend=backend, device=device,
        verify_draws=verify_draws)
    summarize = _build_summarize(engine.keyframe_budget,
                                 cfg.detector.descriptor_dim, normalize_desc)
    if debug:
        from libviso_torch.ops.matching import MatchResult
        from libviso_torch.pipeline.stereo import _to_host
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

        # every knob that changes the result (the JAX package's string)
        fingerprint = config_fingerprint(
            cfg, seed, backend,
            scope=(f"loop:{keyframe_every}:{min_gap}:{min_matches}:"
                   f"{min_inliers}:{max_keyframes}:{keyframe_budget}:"
                   f"{loop_match_ratio}:{verify_top_k}:"
                   f"{min_seed_inliers}:{guided_radius}:{robust}:"
                   f"{robust_delta}:{normalize_desc}:{loop_weight}:"
                   f"{eviction}:{fingerprint_scope}"))
        ck = checkpoint.latest()
        if ck is not None:
            if ck.fingerprint != fingerprint:
                raise ValueError(
                    "checkpoint fingerprint mismatch: written with "
                    f"different cfg/knobs ({ck.fingerprint} != "
                    f"{fingerprint})")
            n_state = len(state_to_leaves(state))
            state = state_from_leaves(ck.state_leaves[:n_state], device)
            engine.restore(ck.state_leaves[n_state:n_state + 7],
                           ck.stats["loops"])
            engine.candidates = [
                {**c, **({"refine_trace": [tuple(r) for r in
                                           c["refine_trace"]]}
                         if "refine_trace" in c else {})}
                for c in ck.stats["candidates"]]
            hist = History(ck.motions, ck.oks, ck.stats["frames"])
            t0 = ck.next_frame

    pending: list = []

    # running VO pose for the keyframe positions (spatial eviction),
    # advanced on the host at keyframe times, which sync anyway
    P_run = np.eye(4)
    chained_upto = [0]

    def advance_chain():
        """Chain the motions since the last call into P_run; return the
        position."""
        nonlocal P_run
        from libviso_torch.synthetic import _pose_matrix_np

        lo = chained_upto[0]
        if len(hist.motions) > lo:
            Ts = _pose_matrix_np(np.stack(hist.motions[lo:]))
            for k, T in enumerate(Ts):
                if hist.oks[lo + k]:
                    R, tt = T[:3, :3], T[:3, 3]
                    Tinv = np.eye(4)
                    Tinv[:3, :3] = R.T
                    Tinv[:3, 3] = -R.T @ tt
                    P_run = P_run @ Tinv
            chained_upto[0] = len(hist.motions)
        return P_run[:3, 3].astype(np.float32)

    def snapshot(next_frame):
        hist.flush(pending)
        checkpoint.save(Checkpoint(
            next_frame=next_frame, motions=hist.motions_array(),
            oks=np.asarray(hist.oks, bool),
            state_leaves=state_to_leaves(state) + engine.state_leaves(),
            stats={"frames": hist.stats, "loops": engine.loop_stats(),
                   "candidates": engine.candidates},
            fingerprint=fingerprint))

    start = 0
    if t0 and hasattr(frames, "skipped"):
        frames = frames.skipped(t0)
        start = t0
    prev_host = None

    def upload(image):
        return torch.tensor(np.asarray(image), device=device)

    for t, (im1, im2) in enumerate(frames, start=start):
        if t < t0:   # restored from the checkpoint
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
        pending.append((t, out))
        # a snapshot comes after the frame's keyframe work: one taken
        # before it would resume without frame t's keyframe
        if t % keyframe_every == 0:
            def pos():
                hist.flush(pending)
                return advance_chain()

            engine.offer(t, *summarize(state), pos)
        if checkpoint is not None and (t + 1) % checkpoint.every == 0:
            snapshot(t + 1)

    hist.flush(pending)
    if checkpoint is not None and hist.motions:
        snapshot(len(hist.motions))   # so that a rerun does nothing
    vo = hist.result(processed=len(hist.motions) - t0)
    if not hist.motions:
        empty44 = np.zeros((0, 4, 4), np.float32)
        return LoopClosureResult(
            poses=empty44, poses_vo=empty44,
            motions=np.zeros((0, 6), np.float32),
            frame_ok=np.zeros((0,), bool), loops=[], graph_cost=(0.0, 0.0),
            loop_edge_scale=np.zeros((0,), np.float32), candidates=[],
            processed=0, stats=[])
    poses, graph_cost, loop_scale = close_graph(
        vo.poses, engine.kf_frames, engine.loops, loop_weight=loop_weight,
        robust=robust, robust_delta=robust_delta, device=device)
    return LoopClosureResult(
        poses=poses, poses_vo=vo.poses, motions=vo.motions,
        frame_ok=vo.frame_ok, loops=engine.loops, graph_cost=graph_cost,
        loop_edge_scale=loop_scale, candidates=engine.candidates,
        processed=vo.processed, keyframes_offered=engine.n_kf,
        evictions=engine.evicted, store_skipped=engine.store_skipped,
        stats=vo.stats)
