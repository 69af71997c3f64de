"""Composed back-end: sliding-window BA locally and pose-graph loop closure
globally (port of ``libviso_tpu/pipeline/ba_loop.py``).

  1. the windowed BA (``pipeline/windowed.py``) runs the batched
     front-end over overlapping windows and refines each window's motions
     behind the acceptance gate: local accuracy;
  2. at keyframe cadence the same front-end outputs (TrackData rows) are
     summarized into keyframes and offered to the ``LoopEngine``
     (``pipeline/loop.py``): revisit detection and two-stage geometric
     verification, as the streaming loop closure does, since both feed
     ``summarize_keyframe`` the same per-frame slot tensors;
  3. after the last window the pose graph over the BA-refined chain (its
     sequential edges take their z from the refined trajectory) and the
     verified loop edges spread the remaining drift: global consistency.

A frame's detection and matching run once, in its first window, and serve
the BA tracks and the keyframe summary alike.

Checkpoints: window progress, the keyframe store and the verified loop
edges are saved together (``run_windowed_ba``'s ``extra_checkpoint``).
Resume is bit-exact: window draws depend on (seed, w), verification
draws on (seed, absolute frame), and keyframes are offered before any
snapshot that covers their window.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from libviso_torch.config import BAConfig, Calib, PipelineConfig
from libviso_torch.pipeline.loop import (
    LoopEngine,
    close_graph,
    summarize_keyframe,
)
from libviso_torch.pipeline.stereo import resolve_device
from libviso_torch.pipeline.windowed import (
    WindowedResult,
    run_windowed_ba,
    window_starts,
)
from libviso_torch.synthetic import _pose_matrix_np


@dataclasses.dataclass
class BALoopResult:
    poses: np.ndarray        # (T, 4, 4) BA + pose-graph trajectory
    poses_ba: np.ndarray     # (T, 4, 4) BA-refined open chain
    poses_vo: np.ndarray     # (T, 4, 4) front-end-only open chain
    motions: np.ndarray      # (T, 6) refined motions
    frame_ok: np.ndarray     # (T,)
    window_costs: list       # run_windowed_ba's 5-tuples
    loops: list              # [LoopEdge]
    graph_cost: tuple        # (initial, final) pose-graph cost
    loop_edge_scale: np.ndarray = None
    candidates: list = None
    processed: int = 0
    keyframes_offered: int = 0
    evictions: int = 0
    store_skipped: int = 0


class _EngineCheckpoint:
    """The LoopEngine's state and the offered keyframes, through
    run_windowed_ba's ``extra_checkpoint`` hook."""

    def __init__(self, engine, seen, starts, window, T, keyframe_every):
        self.engine = engine
        self.seen = seen
        self._starts = starts
        self._window = window
        self._T = T
        self._every = keyframe_every

    def leaves(self):
        return self.engine.state_leaves()

    def stats(self):
        return self.engine.loop_stats()

    def restore(self, leaves, stats, next_window):
        self.engine.restore(leaves, stats)
        # the keyframes offered so far: the keyframe-cadence frames of the
        # span the restored windows cover
        covered = 0
        if next_window > 0:
            covered = min(self._starts[next_window - 1] + self._window,
                          self._T)
        self.seen.update(range(0, covered, self._every))


def _pos_at(t, motions, oks):
    """Trajectory position of frame t from the accumulated (refined)
    motions, chained on the host in float64."""
    P = np.eye(4)
    if t > 0:
        Ts = _pose_matrix_np(np.stack(motions[1:t + 1]))
        for k, M in enumerate(Ts):
            if oks[1 + k]:
                R, tt = M[:3, :3], M[:3, 3]
                Minv = np.eye(4)
                Minv[:3, :3] = R.T
                Minv[:3, 3] = -R.T @ tt
                P = P @ Minv
    return P[:3, 3].astype(np.float32)


def run_windowed_ba_loop(frames, P1, P2,
                         cfg: PipelineConfig = PipelineConfig(),
                         ba: BAConfig = BAConfig(),
                         keyframe_every: int = 5, min_gap: int = 20,
                         min_matches: int = 60, min_inliers: int = 30,
                         max_keyframes: int = 128,
                         keyframe_budget: int = 256,
                         min_seed_inliers: int = 7,
                         guided_radius: float = 16.0,
                         loop_weight: float = 20.0,
                         verify_top_k: int = 3,
                         loop_match_ratio: float = 0.8,
                         robust: str = "cauchy",
                         robust_delta: float = 0.05,
                         normalize_desc: bool = True,
                         eviction: str = "spatial",
                         seed: int = 0, backend: str = "dense",
                         checkpoint=None,
                         fingerprint_scope: str = "",
                         dbg_dir=None, device="cuda",
                         draws: Optional[Callable] = None,
                         verify_draws: Optional[Callable] = None
                         ) -> BALoopResult:
    """Windowed BA and loop closure over a whole sequence (composed mode)
    on ``device``.

    The arguments are the union of ``run_windowed_ba``'s BA knobs (through
    ``ba``) and ``run_with_loop_closure``'s loop knobs; ``draws(w, n)``
    replaces the window draws and ``verify_draws(t, it)`` the loop
    verification draws (test seams).
    """
    device = resolve_device(device)
    frames = list(frames)
    T = len(frames)
    calib = Calib.from_projections(P1, P2)
    starts = window_starts(T, ba.window, ba.stride)

    engine = LoopEngine(
        cfg, calib, seed, keyframe_every=keyframe_every, min_gap=min_gap,
        min_matches=min_matches, min_inliers=min_inliers,
        max_keyframes=max_keyframes, keyframe_budget=keyframe_budget,
        min_seed_inliers=min_seed_inliers, guided_radius=guided_radius,
        verify_top_k=verify_top_k, loop_match_ratio=loop_match_ratio,
        eviction=eviction, backend=backend, device=device,
        verify_draws=verify_draws)
    budget = engine.keyframe_budget
    desc_dim = cfg.detector.descriptor_dim
    seen: set = set()

    def on_window(w, s, e, tracks, motions, oks):
        for li in range(e - s):
            t = s + li
            if t % keyframe_every != 0 or t in seen:
                continue
            seen.add(t)
            usable = tracks.kp1_valid[li] & tracks.mlr_valid[li]
            keyframe = summarize_keyframe(
                tracks.kp1_xy[li], tracks.kp2_xy[li], tracks.d1[li],
                tracks.kp1_response[li], usable, tracks.mlr_idx[li],
                tracks.X[li], budget, desc_dim, normalize_desc)
            engine.offer(t, *keyframe, lambda: _pos_at(t, motions, oks))

    extra = _EngineCheckpoint(engine, seen, starts, ba.window, T,
                              keyframe_every)
    scope = (f"baloop:{keyframe_every}:{min_gap}:{min_matches}:"
             f"{min_inliers}:{max_keyframes}:{keyframe_budget}:"
             f"{loop_match_ratio}:{verify_top_k}:{min_seed_inliers}:"
             f"{guided_radius}:{robust}:{robust_delta}:"
             f"{normalize_desc}:{loop_weight}:{eviction}:"
             f"{fingerprint_scope}")
    res: WindowedResult = run_windowed_ba(
        frames, P1, P2, cfg, ba=ba, seed=seed, backend=backend,
        checkpoint=checkpoint, fingerprint_scope=scope, dbg_dir=dbg_dir,
        on_window=on_window, extra_checkpoint=extra, device=device,
        draws=draws)

    poses, graph_cost, loop_scale = close_graph(
        res.poses, engine.kf_frames, engine.loops, loop_weight=loop_weight,
        robust=robust, robust_delta=robust_delta, device=device)
    return BALoopResult(
        poses=poses, poses_ba=res.poses, poses_vo=res.poses_vo,
        motions=res.motions, frame_ok=res.frame_ok,
        window_costs=res.window_costs, loops=engine.loops,
        graph_cost=graph_cost, loop_edge_scale=loop_scale,
        candidates=engine.candidates, processed=res.processed,
        keyframes_offered=engine.n_kf, evictions=engine.evicted,
        store_skipped=engine.store_skipped)
