"""Monocular Sim(3) loop closure, the scale-drift-aware back-end (port of
``libviso_tpu/pipeline/mono_loop.py``).

Mono VO's propagated scale drifts, and an SE(3) loop edge has no
coordinate for "this lap came back smaller".  So:

  1. mono VO with relative-scale propagation (``pipeline/mono.py``), one
     front-end pass; keyframes are snapshots of its step state;
  2. a keyframe store and appearance candidates by the stereo loop
     engine's batched matcher (``pipeline/loop.py::
     _build_candidate_matcher``): one ``match_problem_batch`` call of (Kf,
     budget, D) per query keyframe, so on the card one launch of the
     backend's kernel;
  3. verification by 3D-3D Sim(3) RANSAC (Umeyama,
     ``geometry/procrustes.py::ransac_similarity``) on the matched
     landmark clouds, each from its keyframe's rays and propagated
     depths: the alignment observes rotation, translation and the
     relative scale;
  4. a Sim(3) pose graph over keyframe nodes (``solvers/
     pose_graph_sim3.py``), s = 1 odometry edges, Cauchy on the loop
     edges with an annealed knee, and the segments re-anchored through
     their node's similarity.

Draws: frame t's from ``mono_draws(seed, t)`` as in ``run_mono_sequence``,
query keyframe q's verification from ``frame_generator(seed, 1_000_003,
q)`` (the JAX package folds the same indices into its key); ``draws`` and
``verify_draws`` replace them (test seams).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, List, NamedTuple, Optional

import numpy as np
import torch

from libviso_torch.config import MonoConfig, PipelineConfig
from libviso_torch.geometry.essential import normalize_points
from libviso_torch.geometry.mvg import e2h
from libviso_torch.geometry.procrustes import ransac_similarity
from libviso_torch.geometry.se3 import invert_se3
from libviso_torch.geometry.sim3 import sim3_scale
from libviso_torch.ops.topk import topk_sorted
from libviso_torch.pipeline.loop import _build_candidate_matcher
from libviso_torch.pipeline.mono import (
    build_mono_step,
    chain_mono_outputs,
    empty_mono_state,
    mono_draws,
    mono_hypotheses,
)
from libviso_torch.pipeline.stereo import resolve_device
from libviso_torch.solvers.pose_graph_sim3 import (
    optimize_sim3_graph,
    reanchor_segments_sim3,
)
from libviso_torch.solvers.ransac import frame_generator, sample_gumbel


class MonoLoopEdge(NamedTuple):
    frame_old: int
    frame_new: int
    num_inliers: int
    num_candidates: int   # appearance matches that fed the verification
    s_rel: float          # relative scale u_new / u_old of the closure
    z: np.ndarray         # (4, 4) Sim(3): new-keyframe coords -> old


@dataclasses.dataclass
class MonoLoopResult:
    poses: np.ndarray        # (T, 4, 4) Sim(3)-graph-corrected SE(3)
    poses_vo: np.ndarray     # (T, 4, 4) open-chain mono VO
    frame_ok: np.ndarray
    speeds: np.ndarray
    stats: list
    kf_frames: np.ndarray    # frames that became keyframe nodes
    loops: List[MonoLoopEdge]
    graph_cost: tuple        # (cost0, cost) under the final IRLS scaling
    node_scales: np.ndarray  # (K,) optimized per-node scale corrections
    edge_scale: np.ndarray   # (n_loops,) robust IRLS weight per loop edge


def _build_kf_summarize(budget: int, desc_dim: int):
    """MonoState -> compact keyframe (xy, gain-normalized desc, step-unit
    landmark depth, validity): the ``budget`` strongest usable slots, the
    descriptors normalized as the stereo store's
    (``pipeline/loop.py::summarize_keyframe``)."""

    def summarize(state):
        usable = state.kp.valid & state.depth_valid
        score = torch.where(usable, state.kp.response,
                            torch.full_like(state.kp.response,
                                            float("-inf")))
        _, top = topk_sorted(score, budget)
        desc = state.desc[top]
        d = desc[:, :desc_dim]
        d = d - d.mean(-1, keepdim=True)
        d = d / torch.clamp(torch.linalg.vector_norm(d, dim=-1,
                                                     keepdim=True), min=1e-6)
        desc = torch.cat([d * 1024.0, torch.zeros_like(desc[:, desc_dim:])],
                         dim=-1)
        return state.kp.xy[top], desc, state.depth[top], usable[top]

    return summarize


def _build_sim3_verifier(K, budget: int, num_hypotheses: int,
                         inlier_thresh: float):
    """verify(gumbel, xy_new, depth_new, v_new, xy_old, depth_old, v_old,
    idx, mvalid) -> (Z (4, 4), inlier count, candidate count): the matched
    keyframe landmark clouds, each back-projected from its own normalized
    rays and propagated depths, aligned by Sim(3) RANSAC; Z maps the new
    keyframe's points onto the old one's (``Z @ X_new ~= X_old``), its
    scale the drift ratio u_new / u_old."""
    K = np.asarray(K, np.float64)

    def verify(gumbel, xy_new, depth_new, v_new, xy_old, depth_old, v_old,
               idx, mvalid):
        Kt = torch.tensor(K, dtype=torch.float32, device=xy_new.device)
        idx_safe = torch.clamp(idx, 0, budget - 1)
        X_new = depth_new[:, None] * e2h(normalize_points(xy_new, Kt))
        X_old = (depth_old[:, None]
                 * e2h(normalize_points(xy_old, Kt)))[idx_safe]
        pv = (mvalid & v_new & v_old[idx_safe] & (depth_new > 1e-6)
              & (depth_old[idx_safe] > 1e-6))
        Z, _, n_inl = ransac_similarity(
            X_old, X_new, valid=pv, num_hypotheses=num_hypotheses,
            inlier_thresh=inlier_thresh, gumbel=gumbel)
        return Z, n_inl, pv.sum()

    return verify


def run_mono_sim3_loop(frames: Iterable, K,
                       cfg: PipelineConfig = None,
                       mono: MonoConfig = None,
                       seed: int = 0, backend: str = "dense",
                       keyframe_every: int = 4,
                       min_gap: int = 10,
                       min_matches: int = 20,
                       min_inliers: int = 12,
                       budget: int = 256,
                       candidate_ratio: float = 0.8,
                       loop_inlier_thresh: float = 0.5,
                       loop_ransac_hyps: int = 128,
                       loop_weight: float = 20.0,
                       max_scale_ratio: float = 4.0,
                       graph_iters: int = 10,
                       robust_schedule=(0.5, 0.15, 0.05),
                       D=None, device="cuda",
                       draws: Optional[Callable] = None,
                       verify_draws: Optional[Callable] = None,
                       null_basis=None) -> MonoLoopResult:
    """Mono VO and Sim(3) loop closure over one front-end pass on
    ``device``.

    Args beyond ``run_mono_sequence``'s:
      keyframe_every: keyframe cadence in frames (the graph's nodes).
      min_gap: minimum frame separation of a loop candidate.
      min_matches: appearance matches needed to attempt verification.
      min_inliers: Sim(3) RANSAC consensus needed to accept a loop edge.
      budget: landmark slots stored per keyframe (strongest response).
      loop_inlier_thresh: 3D consensus radius in trajectory units.
      loop_weight / max_scale_ratio: loop edge weight; a measured relative
        scale outside [1/r, r] is a verification alias, not drift.
      robust_schedule: the Cauchy knee annealed over successive solves of
        ``graph_iters`` steps each: a true mono loop edge (residual the
        accumulated drift) pulls the graph at the wide first knee while a
        false one (residual about 10x larger) stays suppressed.
      draws: t -> (est1, est2) Gumbel scores of frame t; verify_draws:
        q -> (loop_ransac_hyps, budget) scores of query keyframe q's
        verification; null_basis: the 5-point solver's seam.

    ``poses`` is the open chain when no loop verifies.
    """
    device = resolve_device(device)
    cfg = cfg or PipelineConfig.mono()
    mono = mono or MonoConfig()
    step = build_mono_step(K, cfg, mono=mono, backend=backend, D=D,
                           null_basis=null_basis)
    if draws is None:
        n = cfg.detector.num_slots
        h1, h2 = mono_hypotheses(mono)
        draws = lambda t: mono_draws(seed, t, (h1, n), (h2, n))  # noqa: E731
    if verify_draws is None:
        verify_draws = lambda q: sample_gumbel(  # noqa: E731
            (loop_ransac_hyps, budget), frame_generator(seed, 1_000_003, q))

    # front-end pass: outputs stay on the device; the step's state at
    # keyframe cadence is kept (state t describes frame t)
    state = empty_mono_state(cfg, device)
    outs, kf_snaps = [], []
    for t, im in enumerate(frames):
        g1, g2 = draws(t)
        state, out = step(state, torch.tensor(np.asarray(im), device=device),
                          (g1.to(device), g2.to(device)))
        outs.append(out)
        if t >= keyframe_every and t % keyframe_every == 0:
            kf_snaps.append((t, state))

    poses_vo, oks, speeds, stats = chain_mono_outputs(outs, mono)
    T = len(poses_vo)

    # the keyframe store: snapshots of accepted frames (a failed frame's
    # depths are not in trajectory units)
    summarize = _build_kf_summarize(budget, cfg.detector.descriptor_dim)
    kf_frames, kf_xy, kf_desc, kf_depth, kf_valid = [], [], [], [], []
    for t, st in kf_snaps:
        if not (oks[t] and speeds[t] > 0):
            continue
        xy, desc, depth, valid = summarize(st)
        kf_frames.append(t)
        kf_xy.append(xy)
        kf_desc.append(desc)
        # step-unit depths -> trajectory units via the applied speed, in
        # float32 on the host as the JAX package scales them
        kf_depth.append(torch.from_numpy(
            depth.cpu().numpy() * float(speeds[t])).to(device))
        kf_valid.append(valid)

    def no_loops():
        return MonoLoopResult(
            poses=poses_vo.copy(), poses_vo=poses_vo, frame_ok=oks,
            speeds=speeds, stats=stats,
            kf_frames=np.asarray(kf_frames, np.int64), loops=[],
            graph_cost=(0.0, 0.0),
            node_scales=np.ones((len(kf_frames),), np.float32),
            edge_scale=np.zeros((0,), np.float32))

    Kf = len(kf_frames)
    if Kf < 2:
        return no_loops()

    # appearance candidates: the whole store, one batched call per query
    match_all = _build_candidate_matcher(cfg, Kf, budget, backend,
                                         candidate_ratio)
    st_xy, st_desc, st_valid = (torch.stack(x)
                                for x in (kf_xy, kf_desc, kf_valid))
    verify = _build_sim3_verifier(K, budget, loop_ransac_hyps,
                                  loop_inlier_thresh)
    loops: List[MonoLoopEdge] = []
    for q in range(1, Kf):
        allowed = np.array([kf_frames[q] - kf_frames[k] >= min_gap
                            for k in range(Kf)])
        allowed[q:] = False
        if not allowed.any():
            continue
        idx, mval, scores = match_all(st_xy[q], st_desc[q], st_valid[q],
                                      st_xy, st_desc, st_valid)
        scores = np.where(allowed, scores.cpu().numpy(), -1)
        best = int(np.argmax(scores))
        if scores[best] < min_matches:
            continue
        Z, n_inl, _ = verify(
            verify_draws(q), st_xy[q], kf_depth[q], st_valid[q],
            st_xy[best], kf_depth[best], st_valid[best], idx[best],
            mval[best])
        n_inl = int(n_inl)
        if n_inl < min_inliers:
            continue
        s_rel = float(sim3_scale(Z))
        if not (np.isfinite(s_rel)
                and 1.0 / max_scale_ratio < s_rel < max_scale_ratio):
            continue
        loops.append(MonoLoopEdge(
            frame_old=kf_frames[best], frame_new=kf_frames[q],
            num_inliers=n_inl, num_candidates=int(scores[best]),
            s_rel=s_rel, z=Z.cpu().numpy()))

    if not loops:
        return no_loops()

    poses, graph_cost, node_scales, edge_scale = close_sim3_graph(
        poses_vo, kf_frames, loops, loop_weight=loop_weight,
        graph_iters=graph_iters, robust_schedule=robust_schedule,
        device=device)
    return MonoLoopResult(
        poses=poses, poses_vo=poses_vo, frame_ok=oks, speeds=speeds,
        stats=stats, kf_frames=np.asarray(kf_frames, np.int64), loops=loops,
        graph_cost=graph_cost, node_scales=node_scales,
        edge_scale=edge_scale)


def close_sim3_graph(poses_vo, kf_frames, loops, loop_weight: float = 20.0,
                     graph_iters: int = 10,
                     robust_schedule=(0.5, 0.15, 0.05), device="cuda"):
    """The Sim(3) graph over the open chain ``poses_vo`` (T, 4, 4), on
    ``device`` in float32 (``"cuda"`` raises without a card).

    The nodes are the keyframe frames and the endpoints; odometry edges
    between successive nodes carry s = 1, each loop edge (old, new) its
    verified ``z`` under ``loop_weight`` and a Cauchy kernel whose knee
    runs through ``robust_schedule``, ``graph_iters`` steps a knee.
    Frames between nodes re-anchor through their node's similarity.
    Returns (poses (T, 4, 4), (cost0, cost), node scales (K,), the loop
    edges' IRLS weights).
    """
    device = resolve_device(device)
    T = len(poses_vo)
    node_frames = np.asarray(sorted({0, T - 1} | set(kf_frames)), np.int64)
    node_of = {int(f): k for k, f in enumerate(node_frames)}
    Kn = len(node_frames)
    f32 = dict(dtype=torch.float32, device=device)
    P_nodes = torch.as_tensor(poses_vo[node_frames], **f32)
    # a loop's z maps new-keyframe coords to old ones = S_old^-1 S_new:
    # the edge (i = old, j = new)
    ei = list(range(Kn - 1)) + [node_of[le.frame_old] for le in loops]
    ej = list(range(1, Kn)) + [node_of[le.frame_new] for le in loops]
    z = torch.cat([invert_se3(P_nodes[:-1]) @ P_nodes[1:],
                   torch.as_tensor(np.stack([le.z for le in loops]), **f32)])
    weights = torch.cat([torch.ones(Kn - 1, **f32),
                         torch.full((len(loops),), float(loop_weight),
                                    **f32)])
    is_loop = torch.arange(len(ei), device=device) >= Kn - 1
    P = P_nodes
    for delta in robust_schedule:
        res = optimize_sim3_graph(P, ei, ej, z, weights=weights,
                                  iters=graph_iters, robust="cauchy",
                                  robust_mask=is_loop, robust_delta=delta)
        P = res.poses
    poses = reanchor_segments_sim3(torch.as_tensor(poses_vo, **f32),
                                   node_frames, res.poses)
    return (poses.cpu().numpy(), (float(res.cost0), float(res.cost)),
            sim3_scale(res.poses).cpu().numpy(),
            res.edge_scale[Kn - 1:].cpu().numpy())
