#!/usr/bin/env python3
"""Smoke run of the PyTorch port (libviso_torch) on one CUDA card.

  python3 chip_smoke.py        (from the repository root; needs one card)

Phases, each of which exits non-zero on failure:
  1. device: a CUDA card is visible; its name and power limit are printed;
  2. build: the CUDA kernels are compiled from libviso_torch/csrc;
  3. kernel against plain: the L1 kernel equals its plain PyTorch version
     bitwise on integer-valued descriptors and within rtol 1e-5 on random
     floats, at the main path's shape, the serving step's and a ragged one;
     kernel, plain version and torch.cdist(p=1), the one PyTorch call that
     computes the same function, are timed with CUDA events at both shapes;
  4. main path: run_stereo_sequence on a KITTI-size synthetic sequence
     with metric l1 solves 19 of 20 frames through the kernel (one launch
     a frame) within the ATE bound of the JAX package's run;
  5. card against CPU: the first 4 frames give the same per-frame results
     on the card as through the port's plain versions on the CPU;
  6. entry point: `python -m libviso_torch.cli synth --metric l1` runs;
  7. fused kernels against plain: the fused gated matcher, the sweep
     route (order kernel, then sweep kernel) and the L1 kernel equal their
     plain versions bitwise (best, second, idx; permutations and boxes;
     distances) on the detector output of KITTI-size frames, the 3 match
     problems of one stream and the 12 of four, and the fused kernels
     within rtol 1e-5 on float descriptors; every row where the sweep's
     idx differs from the dense route's is an exact distance tie; the
     sweep route is two device launches by torch.profiler, traced in a
     fresh process (a kept CUPTI loses the first kernel records of a
     session once other processes have started on the card, and this
     one has started some; the trace raises where a record is lost);
     kernels, plain versions and the matcher routes are timed with CUDA
     events, in turns;
  8. serving: run_multistream on 4 KITTI-size streams (lengths 20, 20, 16,
     12) under metric l1 with each matcher backend: every stream's
     discrete per-frame stats equal its solo run on the card, fused equals
     dense, each of the backend's kernels launches once per timestep, and
     the 20-frame streams solve 19/19 within the phase-4 ATE bound; a 2-slot
     StreamPool gives each sequence its solo result; where PIL imports,
     `cli serve --pool 2` runs on a mini KITTI tree.  All live streams of a
     timestep are one batched solve;
  9. the rest of the stereo path, at KITTI size under metric l1:
     run_stereo_sequence(chunk=4) equals phase 4's per-frame run on every
     stat and motion bit for bit, through one kernel launch a frame; the
     same run cut at frame 8 by a checkpoint and resumed equals it too;
     the serving step's `solves` stage (one call for all live streams) is
     timed beside the per-stream solves of the earlier design;
     build_batched_odometry on the first 8 frames under each backend
     has the streaming run's discrete stats on the same draws,
     with one launch of the backend's kernel per matcher call (two calls a
     window); 4 frames with pyramid_levels=2, subpixel, sharpen_auto and
     nms_radius=2 give the same discrete stats on the card as on the CPU;
     keep_features_on_failure holds a blanked frame's predecessor; and
     `cli synth --world --chunk 4 --metric l1 --backend sweep` runs;
 10. mono, at full width (PipelineConfig.mono(): 1536 slots, descriptors
     of 361 values padded to 384, one problem a call, radius 10): the L1,
     fused and sweep kernels equal their plain versions bitwise at
     (1, 1536, 384) on integer descriptors and on the temporal match and
     the F-gated re-match of a real frame, and are timed there beside
     their plain versions, their bounds and torch.cdist(p=1);
     run_mono_sequence on the 20 left frames of the phase-4 sequence
     solves at least 18 of 19 frames under metric l1 through each
     backend's kernels (two matcher calls a frame) within the Sim(3) ATE
     bound of the JAX package's run, and the three backends give the same
     discrete per-frame stats on the same draws; metric l2 runs too; and
     `cli mono --device cuda` runs on a small image folder;
 11. stereo loop closure at full width (PipelineConfig().with_metric("l1"),
     the LoopEngine defaults: a store of 128 keyframes of 256 slots, 256
     verification hypotheses, guided radius 16) on a 96-frame KITTI-size
     circle, under each matcher backend, on the JAX package's draws
     (tools/threefry.py): 95/95 solved, the JAX run's loop
     pairs with inliers within 10 %, the optimized ATE within max(1.5 J,
     J + 0.02 m) of JAX's J, graph cost falling, the optimized endpoint
     closer than the open chain's as in JAX's run, the three backends'
     candidates and loops equal, and the backend's kernels launched once
     per frame, once per candidate search and once per guided match (the
     wrappers' counts, as phase 9 counts them);
 12. the kernels at the loop shapes: (128, 256, 128), the candidate
     search over the store, and (20, 256, 128), the mono loop's: the L1,
     gated and sweep kernels and the order kernel equal their plain
     versions bitwise on integer descriptors and on a real candidate
     search of phases 11 and 13, and are timed there beside their bounds,
     plain versions and torch.cdist(p=1);
 13. the mono Sim(3) loop on the two-lap plaza circuit (81 frames,
     tests/test_mono.py's mono_config() with subpixel corners, a keyframe
     every 4 frames, min_gap 20) on the JAX package's draws: under l2
     (dense) every frame solved, at least 2 loops 36-44 frames apart with
     at least 20 inliers, an edge weight above 0.5 and a node scale above
     1.3 (tests/test_sim3.py's properties), the corrected Sim(3) ATE
     at most 1.01x the open chain's and within max(1.5 J, J + 0.02 m) of
     JAX's; under l1 (fused, kernel #2 at (20, 256, 128)) every frame
     solved;
 14. entry points: `cli kitti --loop-closure` on a mini KITTI tree, `cli
     synth --world-loop --frames 6` and `cli mono --sim3-loop` on a folder
     of frames, with the default --device cuda;
 15. windowed bundle adjustment at full width: run_windowed_ba on the
     phase-4 sequence, metric l1, windows of 8 frames every 4, on the JAX
     package's window draws (tools/threefry.py), under the acceptance gate
     with each backend: 19/19 solved, the JAX run's accepted flags (none),
     so the trajectory is VO's, no window's cost rising, each window's
     initial and final cost and holdout ratios within rtol 1e-3 of JAX's,
     the ATE within max(1.5 J, J + 0.02 m) of JAX's J, the three backends
     bitwise equal on motions and flags, one launch of the backend's
     kernels a window at each of the two shapes; without the gate (dense)
     every window accepted, its costs and ratios within rtol 1e-3 of
     JAX's, and the ATE within the bound of JAX's and below VO's; per
     window the front-end and refinement ms, and the refinement's device
     kernels and stream syncs by torch.profiler, each window's
     refinement traced again in a fresh process (as phase 7's);
 16. the kernels at the BA window's shapes, (8, 1280, 128) and (14, 1280,
     128): equal to their plain versions on integer descriptors and on the
     first window's stereo and temporal problems of phase 15, and timed
     there as in phase 12;
 17. the composed BA + loop back-end (run_windowed_ba_loop) on phase 11's
     circle, sweep, on JAX's window and loop draws: 95/95 solved, the JAX
     run's 23 window flags and loop pairs with inliers within 10 %, the
     graph cost falling and within 2x of JAX's, the optimized endpoint no
     farther than the BA chain's, the optimized ATE within the bound of
     JAX's, the route's launches counted;
 18. entry points: `cli kitti --ba-window 4`, alone and with
     --loop-closure, on a mini KITTI tree with checkpoints and the default
     --device cuda (the CLI's main in this process), each resumed from its
     next-to-last snapshot with the same poses, and --keep-on-failure with
     --ba-window refused (a non-zero exit);
 19. the matcher variants: 20-frame streaming runs on the phase-4
     sequence under metric l2q8, banded l2 and banded l2q8, each with the
     JAX run's solved count and within the ATE bound of its ATE; on frame
     1's three problems the banded matcher's indices equal the dense
     path's except on distance ties (bit-exact under l2q8, within rtol
     1e-6 under l2), counted and printed; the l2q8 cross term equals the
     int64 product; the l2 and l2q8 routes timed with CUDA events;
 20. the tensor-parallel matcher on frame 1's stereo (with F) and
     temporal problems at (1280, 1280, 128), l1, with model = 1, 2 and 4
     entries of cuda:0: equal to match_descriptors bit for bit, k launches
     of kernel #1 a problem; #1 timed at the shard shape (1280 x 320, 128)
     beside its bound, plain version and torch.cdist(p=1);
 21. run_sharded_odometry on 21 KITTI-size frames over data = 4 entries
     of cuda:0 under dense l1, fused, sweep and dense l2: each chunk's ok
     flags equal the streaming run's on the same draws and its motions are
     within 5e-6 of them, the entry point's poses equal its chunks
     stitched, 2 launches of the route's kernels a chunk; one process of
     run_sharded_odometry_multihost equals run_sharded_odometry; the
     kernels against their plain versions, and timed, on chunk 0's
     stereo (6, 1280, 128) and temporal (10, 1280, 128) problems;
 22. run_pipelined_odometry and StreamPipeline on [cuda:0, cuda:0] (a
     CUDA stream a stage), 20 frames under each backend: equal to
     run_stereo_sequence bit for bit, one launch of the route's kernels a
     frame; frames/s of the three beside each other (not a gate);
 23. sharded_bundle_adjust on the first window of phase 15 with the
     landmark axis over 4 entries of cuda:0: poses within 1e-4 and
     landmarks within 1e-3 of bundle_adjust, under
     torch.cuda.set_sync_debug_mode("error"); both timed;
 24. jit_multistream_sharded: 4 streams over 2 entries of cuda:0 for 6
     steps under each backend (l1), every state and output equal to the
     unsharded step bit for bit, one launch of the route's kernels an
     entry a step; the kernels against their plain versions, and timed,
     on an entry's 6 problems (2 streams x 3); `cli kitti --metric
     l2q8` with the VISO_* variables unset (where PIL imports); and two
     processes on cuda:0 joined by VISO_* over localhost (gloo), each with
     a timeout, running run_sharded_odometry_multihost on 9 KITTI-size
     frames, both equal to the one-process run bit for bit;
 25. profiling (libviso_torch.utils.profiling): device_peaks() has the
     card's row; profile_matcher at (1280, 1280, 128) under l1 through the
     kernel (kernel #1 launched (warmup + reps) x chain times) and its plain
     version (no launch), l2 and l2q8; profile_solver at its defaults,
     profile_frame_step and profile_mono_step, each KernelStats printed and
     every flop_util and bw_util at most 1.05; kernel #1 alone at the
     profile's shape (1, 1280, 128) equals its plain version bitwise on
     integer descriptors and is timed beside its bound, its plain version
     and torch.cdist(p=1), by device_ms and by time_call; trace() around
     one l1 match in a fresh process writes a trace that names kernel
     #1's __global__ function, and in this process it does so too or
     raises because the profiler lost the kernel's record;
 26. the native image runtime (libviso_torch.native): available() and its
     reason; where it builds, the PNGs of a mini KITTI tree (as phase 14
     writes them) and the phase-4 sequence's 20 KITTI-size pairs decode
     byte-equal to PIL, StereoImageStream yields them in order, and the
     host ms a frame of the native stream and the PIL read-ahead are
     printed in turns with the host's CPU model; where it cannot build
     (no png.h), one line says so;
 27. the bench (bench_torch.py) in this process at --reps=8 --window=8:
     the default (l2, chunk 4), --chunk=1 --metric=l1 (kernel #1),
     --streams=4 --metric=l1 --backend=fused (#2), --metric=l1
     --backend=sweep (#3), --staged, --upload, --mono --reps=4 and
     --profile: each prints one JSON line with bench.py's keys for its
     mode, a finite positive value and vs_baseline = round(value /
     baseline, 3), and launches its route's kernels once a frame step
     (serving: a timestep), warm-up included, and no other kernel; then,
     as the last act, after every trace, `python3 bench_torch.py
     --reps=4` as a subprocess exits 0 with exactly one JSON line on
     stdout.

The line before the last is the kernel table as JSON: per kernel its
launches on the main path, its time beside its bound (the larger of the
bytes it must move over 3.35 TB/s and its FP32 instructions over the
card's issue rate, 132 SMs x 128 lanes x 1.98 GHz; 67 TFLOP/s counts an
FMA as two: libviso_torch.utils.profiling's bound_ms on the card's row of
its peak table) and the share of the bound it reaches, the plain version's
time and the library call's, at the main shape (3, 1280, 128) and the
serving shape (12, 1280, 128), and at the mono shape (1, 1536, 384) with
its launches in the 20-frame mono run (`mono_launches`), and at the loop
shapes (128, 256, 128) and (20, 256, 128) with the launches of the loop
runs (`loop_launches`, phase 11 under the kernel's backend;
`mono_loop_launches`, phase 13's l1 run), and at the BA window's shapes
(8, 1280, 128) and (14, 1280, 128) with the launches of phase 15's run
under the kernel's backend (`ba_launches`, two a window; each shape's
`launches` counted per call of the batched matcher) and of phase 17's
(`ba_loop_launches`, the sweep's kernels), and the launches of the
parallel paths: `tp_launches` (phase 20, kernel #1; null for the
kernels phase 20 does not run), `chunk_launches` (phase 21 under the
kernel's backend), `pp_launches` (phase 22's staged run) and
`sharded_serve_launches` (phase 24 under the kernel's backend) and
`profile_launches` (phase 25's l1 profile, kernel #1; null for the
others) and `bench_launches` (phase 27: per mode that reaches the
kernel, its launches), with
rows (`path` names them) at kernel #1's shard shape (1, 1280, 320, 128)
with phase 20's launches at model = 4, at the profile's (1, 1280, 128)
with phase 25's, at the chunk's shapes (6, 1280,
128) and (10, 1280, 128) with phase 21's launches of each shape, and at
a serving entry's (6, 1280, 128) with phase 24's.  The sweep's
entry is its whole route
(`ms`: order kernel and sweep kernel, `order_ms` and `sweep_ms` each
alone, `fused_ms` kernel #2 in the same turns, `route_launches` by
torch.profiler).  Kernel #2 and the route compute one function, so both
are bounded by the (query, target) pairs that pass the position and
validity gates (`pairs`), whatever the tiling; the route's (block,
window) pairs and skip share beside.  Kernel times are device times: a sleep
kernel holds the card while the host queues the timed launches.  The
script's wall time is printed before it.  The last line is
{"ok": true, "device": {...}}.
"""

import contextlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

import bench_torch
# tools/kernel_variants.py reads the timer as chip_smoke._time_ms
from libviso_torch.utils.profiling import bound_ms, two_min_bound
from libviso_torch.utils.profiling import device_ms as _time_ms

ROOT = os.path.dirname(os.path.abspath(__file__))

# The JAX package's ATE [m] on the phase-4 sequence and configuration
# (metric l1, seed 0), computed on the CPU with:
#   python -c "import jax; jax.config.update('jax_platforms', 'cpu')
#   from libviso_tpu.config import PipelineConfig
#   from libviso_tpu.pipeline import run_stereo_sequence
#   from libviso_tpu.synthetic import generate_sequence
#   from libviso_tpu.utils.metrics import ate_rmse
#   s = generate_sequence(num_frames=20, num_points=900, seed=0, width=1241,
#       height=376, f=718.856, base=0.5371657, speed=0.8)
#   r = run_stereo_sequence(s.frames, s.P1, s.P2,
#       PipelineConfig().with_metric('l1'), seed=0)
#   print(ate_rmse(r.poses, s.gt_poses))"
JAX_ATE_M = 0.04638402909040451
ATE_BOUND = max(1.5 * JAX_ATE_M, JAX_ATE_M + 0.02)
KITTI_SEQUENCE = dict(num_frames=20, num_points=900, seed=0, width=1241,
                      height=376, f=718.856, base=0.5371657, speed=0.8)
MAIN_SHAPE = (3, 1280, 128)   # a frame's three match problems
SERVE_SHAPE = (12, 1280, 128)  # a 4-stream serving step's twelve
# The JAX package's Sim(3)-aligned ATE [m] of the mono path on the left
# frames of the phase-4 sequence (PipelineConfig.mono() under each metric,
# seed 0, K = P1[:, :3]; 19 of 19 frames solved under both), computed on
# the CPU with:
#   python -c "import jax; jax.config.update('jax_platforms', 'cpu')
#   from libviso_tpu.config import PipelineConfig
#   from libviso_tpu.pipeline.mono import run_mono_sequence
#   from libviso_tpu.synthetic import generate_sequence
#   from libviso_tpu.utils.metrics import ate_rmse
#   s = generate_sequence(num_frames=20, num_points=900, seed=0, width=1241,
#       height=376, f=718.856, base=0.5371657, speed=0.8)
#   for m in ('l1', 'l2'):
#       r = run_mono_sequence([f[0] for f in s.frames], s.P1[:, :3],
#           PipelineConfig.mono().with_metric(m), seed=0)
#       print(m, ate_rmse(r.poses, s.gt_poses, align='sim3'))"
JAX_MONO_ATE_M = {"l1": 0.0852750317587583, "l2": 0.10186595192174926}
MONO_ATE_BOUND = {m: max(1.5 * a, a + 0.02) for m, a in JAX_MONO_ATE_M.items()}
MONO_SHAPE = (1, 1536, 384)   # one mono match problem
MONO_STATS = ("frame", "ok", "num_matches", "num_inliers", "scale_support",
              "span")
# Phase 11: the JAX package's loop run on the 96-frame KITTI-size circle
# (radius 10 m, seed 3, 1400 points), PipelineConfig().with_metric('l1'),
# the LoopEngine defaults, keyframe_every 4, min_gap 24, min_matches 40,
# min_inliers 20, seed 0, computed on the CPU with:
#   python -c "import jax; jax.config.update('jax_platforms', 'cpu')
#   import numpy as np
#   from libviso_tpu.config import PipelineConfig
#   from libviso_tpu.pipeline.loop import run_with_loop_closure
#   from libviso_tpu.synthetic import generate_sequence
#   from libviso_tpu.utils.metrics import ate_rmse
#   T = 96; yaw = 2 * np.pi / (T - 1); st = np.zeros((T, 6))
#   st[1:] = [0, yaw, 0, 0, 0, 20 * np.sin(yaw / 2)]
#   s = generate_sequence(num_frames=T, num_points=1400, seed=3,
#       width=1241, height=376, f=718.856, base=0.5371657, trajectory=st)
#   r = run_with_loop_closure(list(s.frames), s.P1, s.P2,
#       PipelineConfig().with_metric('l1'), keyframe_every=4, min_gap=24,
#       min_matches=40, min_inliers=20, seed=0)
#   e = lambda P: np.linalg.norm(P[-1, :3, 3] - s.gt_poses[-1, :3, 3])
#   print(r.frame_ok.sum(), [(l.frame_new, l.frame_old, l.num_inliers)
#       for l in r.loops], len(r.candidates), r.graph_cost,
#       ate_rmse(r.poses_vo, s.gt_poses), ate_rmse(r.poses, s.gt_poses),
#       e(r.poses_vo), e(r.poses))"
JAX_LOOP = {
    "solved": 95, "loops": [(80, 0, 20), (84, 0, 30), (88, 0, 24),
                            (92, 0, 44)],
    "candidates": 5, "graph_cost": (2.09879732131958, 0.00498834066092968),
    "ate_vo_m": 0.07517513632774353, "ate_opt_m": 0.11447013169527054,
    "end_vo_m": 0.11620201170444489, "end_opt_m": 0.06631191074848175}
LOOP_ATE_BOUND = max(1.5 * JAX_LOOP["ate_opt_m"], JAX_LOOP["ate_opt_m"] + 0.02)
LOOP_KW = dict(keyframe_every=4, min_gap=24, min_matches=40, min_inliers=20,
               seed=0)
LOOP_SHAPE = (128, 256, 128)       # the candidate search over the store
MONO_LOOP_SHAPE = (20, 256, 128)   # the mono loop's, 20 keyframes
# Phase 13: the JAX package's mono loop on the two-lap plaza circuit, per
# metric (tests/test_mono.py's mono_config() with subpixel=True, seed 0),
# computed on the CPU with:
#   python -c "import jax; jax.config.update('jax_platforms', 'cpu')
#   import dataclasses, numpy as np
#   from libviso_tpu.pipeline.mono_loop import run_mono_sim3_loop
#   from libviso_tpu.synthetic_world import generate_plaza_sequence
#   from libviso_tpu.utils.metrics import ate_rmse
#   from tests.test_mono import mono_config
#   s = generate_plaza_sequence(num_frames=81, seed=5, circuits=2)
#   for m in ('l2', 'l1'):
#       c = mono_config(); c = dataclasses.replace(c, detector=
#           dataclasses.replace(c.detector, subpixel=True))
#       c = c.with_metric(m)
#       r = run_mono_sim3_loop([f[0] for f in s.frames], s.P1[:, :3], c,
#           seed=0, keyframe_every=4, min_gap=20)
#       print(m, r.frame_ok.sum(), [(l.frame_old, l.frame_new,
#           l.num_inliers, l.s_rel) for l in r.loops], r.edge_scale,
#           r.node_scales.max(), ate_rmse(r.poses_vo, s.gt_poses,
#           align='sim3'), ate_rmse(r.poses, s.gt_poses, align='sim3'))"
JAX_MONO_LOOP = {
    "l2": {"solved": 80, "loops": [(28, 68, 55), (32, 72, 56), (36, 76, 56)],
           "scales": (3.3669798, 1.9997605, 1.1218430),
           "edge_scale": (0.000356, 0.846078, 0.000369),
           "node_scale_max": 1.9997782707214355,
           "ate_vo_m": 8.45536317778224, "ate_m": 8.396140297593167},
    "l1": {"solved": 80, "loops": [(16, 36, 15)], "scales": (0.5491794,),
           "edge_scale": (5.19e-06,), "node_scale_max": 1.000009536743164,
           "ate_vo_m": 8.74656725391418, "ate_m": 8.74723717250361}}
# Phases 15-17: the JAX package's windowed BA, computed on the CPU.  Phase
# 15, on the phase-4 sequence, under the gate and without it:
#   python -c "import jax; jax.config.update('jax_platforms', 'cpu')
#   from libviso_tpu.config import BAConfig, PipelineConfig
#   from libviso_tpu.pipeline.windowed import run_windowed_ba
#   from libviso_tpu.synthetic import generate_sequence
#   from libviso_tpu.utils.metrics import ate_rmse
#   s = generate_sequence(num_frames=20, num_points=900, seed=0, width=1241,
#       height=376, f=718.856, base=0.5371657, speed=0.8)
#   for gate in (True, False):
#       r = run_windowed_ba(s.frames, s.P1, s.P2,
#           PipelineConfig().with_metric('l1'),
#           ba=BAConfig(window=8, stride=4, gate=gate), seed=0)
#       print(r.frame_ok.sum(), r.window_costs,
#           ate_rmse(r.poses, s.gt_poses), ate_rmse(r.poses_vo, s.gt_poses))"
# (under the gate the paired holdout ratios are 0.970-0.982 against the
# margin 0.90, so no window is accepted and the trajectory is VO's).
# Per window: (initial cost, final cost, holdout ratio 1, holdout ratio 2).
JAX_BA = {
    True: {"solved": 19, "accepted": [False] * 4,
           "windows": [
               (3.909285306930542, 0.37683430314064026, 0.9805883169174194,
                0.9819281697273254),
               (3.8778297901153564, 0.3624119460582733, 0.9780118465423584,
                0.9739909768104553),
               (3.6195480823516846, 0.35250529646873474, 0.981719970703125,
                0.9784586429595947),
               (3.633420705795288, 0.3729010820388794, 0.970205545425415,
                0.980882465839386)],
           "ate_m": 0.030982688069343567},
    False: {"solved": 19, "accepted": [True] * 4,
            "windows": [
                (3.909285306930542, 0.37683430314064026, 0.9805883169174194,
                 0.9819281697273254),
                (3.8941919803619385, 0.35551202297210693, 0.9768638014793396,
                 0.9764490723609924),
                (3.7014966011047363, 0.34283486008644104, 0.9729371070861816,
                 0.9656022787094116),
                (3.6895248889923096, 0.3686462640762329, 0.9691547751426697,
                 0.9803063273429871)],
            "ate_m": 0.01936240866780281}}
BA_RTOL = 1e-3   # window costs and ratios, as tests/test_torch_windowed.py
BA_ATE_BOUND = {g: max(1.5 * r["ate_m"], r["ate_m"] + 0.02)
                for g, r in JAX_BA.items()}
BA_WINDOW = dict(window=8, stride=4)
BA_SHAPES = ((8, 1280, 128), (14, 1280, 128))   # a window's two calls
# Phase 17, the composed back-end on phase 11's circle:
#   python -c "import jax; jax.config.update('jax_platforms', 'cpu')
#   import numpy as np
#   from libviso_tpu.config import BAConfig, PipelineConfig
#   from libviso_tpu.pipeline.ba_loop import run_windowed_ba_loop
#   from libviso_tpu.synthetic import generate_sequence
#   from libviso_tpu.utils.metrics import ate_rmse
#   T = 96; yaw = 2 * np.pi / (T - 1); st = np.zeros((T, 6))
#   st[1:] = [0, yaw, 0, 0, 0, 20 * np.sin(yaw / 2)]
#   s = generate_sequence(num_frames=T, num_points=1400, seed=3,
#       width=1241, height=376, f=718.856, base=0.5371657, trajectory=st)
#   r = run_windowed_ba_loop(list(s.frames), s.P1, s.P2,
#       PipelineConfig().with_metric('l1'), ba=BAConfig(window=8, stride=4),
#       keyframe_every=4, min_gap=24, min_matches=40, min_inliers=20, seed=0)
#   e = lambda P: np.linalg.norm(P[-1, :3, 3] - s.gt_poses[-1, :3, 3])
#   print(r.frame_ok.sum(), [c[2] for c in r.window_costs],
#       [(l.frame_new, l.frame_old, l.num_inliers) for l in r.loops],
#       len(r.candidates), r.graph_cost, ate_rmse(r.poses_ba, s.gt_poses),
#       ate_rmse(r.poses, s.gt_poses), e(r.poses_ba), e(r.poses))"
# (the optimized ATE is above the open chain's in the reference too).
JAX_BA_LOOP = {
    "solved": 95, "accepted": [False] * 23,
    "loops": [(80, 0, 20), (84, 0, 30), (88, 0, 24), (92, 0, 44)],
    "candidates": 5, "graph_cost": (2.4819581508636475, 0.007201947271823883),
    "ate_ba_m": 0.07091660052537918, "ate_opt_m": 0.12176359444856644,
    "end_ba_m": 0.09881708025932312, "end_opt_m": 0.05271231755614281}
BA_LOOP_ATE_BOUND = max(1.5 * JAX_BA_LOOP["ate_opt_m"],
                        JAX_BA_LOOP["ate_opt_m"] + 0.02)
# Phase 19: the JAX package's (solved frames, ATE [m]) on the phase-4
# sequence under the matcher variants, (metric, banded) -> record,
# computed on the CPU with:
#   python -c "import jax; jax.config.update('jax_platforms', 'cpu')
#   import dataclasses
#   from libviso_tpu.config import PipelineConfig
#   from libviso_tpu.pipeline import run_stereo_sequence
#   from libviso_tpu.synthetic import generate_sequence
#   from libviso_tpu.utils.metrics import ate_rmse
#   s = generate_sequence(num_frames=20, num_points=900, seed=0, width=1241,
#       height=376, f=718.856, base=0.5371657, speed=0.8)
#   for m, b in (('l2q8', False), ('l2', True), ('l2q8', True)):
#       c = PipelineConfig().with_metric(m)
#       c = dataclasses.replace(c, stereo_match=dataclasses.replace(
#           c.stereo_match, banded=b))
#       r = run_stereo_sequence(s.frames, s.P1, s.P2, c, seed=0)
#       print(m, b, r.frame_ok.sum(), ate_rmse(r.poses, s.gt_poses))"
JAX_VARIANTS = {("l2q8", False): (19, 0.05176869407296181),
                ("l2", True): (19, 0.05140608176589012),
                ("l2q8", True): (19, 0.05176869407296181)}
KITTI_LAYOUT = (24, 5, 10, 1280)   # (nbinx, nbiny, k, slots): 51 px strips
SHARD_SHAPE = (1, 1280, 320, 128)  # kernel #1 on a model=4 shard: P, N1, N2, D
CHUNK_SEQUENCE = {**KITTI_SEQUENCE, "num_frames": 21}   # phase 21
CHUNK_SHAPES = ((6, 1280, 128), (10, 1280, 128))   # a chunk's two calls
ENTRY_SHAPE = (6, 1280, 128)   # a sharded serving entry: 2 streams x 3
PROFILE_SHAPE = (1, 1280, 128)   # profile_matcher's default problem
KEYS = ("ok", "num_lr", "num_circle", "num_inliers")
STATS = ("frame", "ok", "num_kp1", "num_lr", "num_circle", "num_inliers")
SERVE_LENGTHS = (20, 20, 16, 12)   # streams of seeds 0..3
# The serving step before the solve took a stream axis (S calls of the
# solve in a loop), `tools/profile_torch_step.py --serve --repeats 3` on an
# NVIDIA H100 80GB HBM3 at 700 W: per-timestep means of the `solves` stage
# and the whole step [ms], and the median aggregate frames/s of 3 rounds.
PER_STREAM_SOLVES = {
    "dense": {"solves_ms": 86.1340, "step_ms": 103.2072, "fps": 25.11},
    "fused": {"solves_ms": 96.1390, "step_ms": 111.2569, "fps": 26.12},
    "sweep": {"solves_ms": 112.4198, "step_ms": 129.1269, "fps": 27.26}}
BACKEND_KERNELS = {"dense": ("l1_distance_matrix",),
                   "fused": ("fused_gated_two_min",),
                   "sweep": ("sweep_order", "fused_sweep_two_min")}
KERNELS = ("l1_distance_matrix", "fused_gated_two_min", "sweep_order",
           "fused_sweep_two_min")


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def device_phase():
    import torch

    check(torch.cuda.is_available(), "torch sees no CUDA device")
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[device] {name}, {count} visible, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(smi)
    return name, count, smi


def build_phase():
    """Build the kernels; print ptxas' registers, shared memory and spills
    of each kernel."""
    import re

    from libviso_torch import _build

    t0 = time.perf_counter()
    so = _build.build()
    print(f"[build] {os.path.relpath(so, ROOT)} in "
          f"{time.perf_counter() - t0:.2f} s")
    kernel = None
    names = []
    for line in so.with_suffix(".log").read_text().splitlines():
        mangled = re.search(r"Compiling entry function '(\w+)'", line)
        if mangled:
            kernel = _kernel_name(mangled.group(1))
            names.append(kernel)
        elif "Used" in line or "spill" in line:
            print(f"[build] ptxas {kernel}: {line.split(':', 1)[-1].strip()}")
    return names


def _kernel_name(mangled):
    """The kernel's own name in an Itanium-mangled symbol, whose names
    each follow their length: ..._cu_<hash>18fused_gated_kernelE..."""
    for i in range(len(mangled)):
        for k in (1, 2):
            digits = mangled[i:i + k]
            if not digits.isdigit() or mangled[i + k:i + k + 1].isdigit():
                continue
            name = mangled[i + k:i + k + int(digits)]
            if name.endswith("_kernel") and \
                    mangled[i + k + int(digits):].startswith("E"):
                return name
    return mangled


def reset_launches():
    from libviso_torch.ops import cuda_matching as cm
    from libviso_torch.ops import fused_matching as fm

    cm.launches = 0
    for k in fm.launches:
        fm.launches[k] = 0


def read_launches():
    from libviso_torch.ops import cuda_matching as cm
    from libviso_torch.ops import fused_matching as fm

    return {"l1_distance_matrix": cm.launches, **fm.launches}


def kernel_phase():
    import torch

    from libviso_torch.ops import cuda_matching as cm

    g = torch.Generator(device="cuda").manual_seed(0)

    def make(shape, integer):
        if integer:
            return torch.randint(-1020, 1021, shape, generator=g,
                                 device="cuda").float()
        return torch.randn(shape, generator=g, device="cuda") * 100

    max_err = 0.0
    cases = [("main, integer", MAIN_SHAPE, MAIN_SHAPE, True),
             ("main, float", MAIN_SHAPE, MAIN_SHAPE, False),
             ("serving, integer", SERVE_SHAPE, SERVE_SHAPE, True),
             ("ragged, float", (2, 1000, 128), (2, 777, 128), False)]
    for label, s1, s2, integer in cases:
        a, b = make(s1, integer), make(s2, integer)
        out = cm.l1_distance_matrix(a, b)
        ref = cm.l1_distance_matrix_plain(a, b)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        max_err = max(max_err, err)
        if integer:
            check(torch.equal(out, ref), f"{label}: kernel != plain bitwise")
        else:
            check(torch.allclose(out, ref, rtol=1e-5, atol=0.0),
                  f"{label}: kernel differs from plain beyond rtol 1e-5 "
                  f"(max abs {err})")
        print(f"[kernel] {label} {s1} x {s2}: max abs err {err}")

    times = {}
    for shape in (MAIN_SHAPE, SERVE_SHAPE):
        a, b = make(shape, False), make(shape, False)
        fns = {"plain": lambda: cm.l1_distance_matrix_plain(a, b),
               "kernel": lambda: cm.l1_distance_matrix(a, b),
               "library": lambda: torch.cdist(a, b, p=1)}
        for fn in fns.values():   # warm-up
            fn()
        torch.cuda.synchronize()
        # in turns (plain, kernel, library, library, kernel, plain)
        ms = {k: [] for k in fns}
        for k in list(fns) + list(fns)[::-1]:
            ms[k].append(_time_ms(fns[k]))
        P, N, D = shape
        bound, by = bound_ms(2 * P * N * N * D, 4 * P * (2 * N * D + N * N))
        t = {k: sum(v) / 2 for k, v in ms.items()}
        times[shape] = {"ms": t["kernel"], "plain_ms": t["plain"],
                        "library_ms": t["library"], "bound_ms": bound,
                        "bound_by": by}
        print(f"[kernel] {shape} x {shape}: kernel {t['kernel']:.4f} ms "
              f"{ms['kernel']}, bound {bound:.4f} ms ({by}, share "
              f"{bound / t['kernel']:.3f}); plain {t['plain']:.4f} ms "
              f"{ms['plain']}; torch.cdist(p=1) {t['library']:.4f} ms "
              f"{ms['library']} per call")
    return max_err, times


def main_path_phase(seq):
    import torch

    from libviso_torch.config import PipelineConfig
    from libviso_torch.pipeline.stereo import run_stereo_sequence
    from libviso_torch.utils.metrics import ate_rmse

    fps = {}
    launches = l1_result = None
    for metric in ("l1", "l2"):
        ends = []

        def on_frame(t, out):
            torch.cuda.synchronize()
            ends.append(time.perf_counter())

        cfg = PipelineConfig().with_metric(metric)
        reset_launches()
        res = run_stereo_sequence(seq.frames, seq.P1, seq.P2, cfg, seed=0,
                                  device="cuda", on_frame=on_frame)
        if metric == "l1":
            launches = read_launches()["l1_distance_matrix"]
            l1_result = res
        solved = int(res.frame_ok.sum())
        ate = ate_rmse(res.poses, seq.gt_poses)
        # frames 2..19: from the end of frame 1 to the end of frame 19
        fps[metric] = (len(ends) - 2) / (ends[-1] - ends[1])
        print(f"[main] metric {metric}: solved {solved}/{len(ends)}, "
              f"ATE {ate} m, {fps[metric]:.2f} frames/s over frames 2-19")
        if metric == "l1":
            check(solved == 19, f"solved {solved} of 20 frames, not 19")
            check(launches == len(seq.frames),
                  f"kernel launched {launches} times for "
                  f"{len(seq.frames)} frames")
            check(ate <= ATE_BOUND, f"ATE {ate} m above the bound "
                  f"{ATE_BOUND} m (JAX {JAX_ATE_M} m)")
    return launches, fps, l1_result


def card_vs_cpu_phase(seq):
    import numpy as np

    from libviso_torch.config import PipelineConfig
    from libviso_torch.pipeline.stereo import run_stereo_sequence

    cfg = PipelineConfig().with_metric("l1")
    frames = seq.frames[:4]
    # the default draws come from a CPU generator seeded from (seed, frame)
    # and are moved to the device, so both runs see the same draws
    cpu = run_stereo_sequence(frames, seq.P1, seq.P2, cfg, seed=0,
                              device="cpu")
    gpu = run_stereo_sequence(frames, seq.P1, seq.P2, cfg, seed=0,
                              device="cuda")
    for a, b in zip(gpu.stats, cpu.stats):
        check({k: a[k] for k in KEYS} == {k: b[k] for k in KEYS},
              f"frame {a['frame']}: card {a} != cpu {b}")
    err = float(np.abs(gpu.motions - cpu.motions).max())
    check(err <= 1e-4, f"card and CPU motions differ by {err}")
    print(f"[card-vs-cpu] 4 frames: ok/num_lr/num_circle/num_inliers "
          f"equal, max |tr| difference {err}")


def entry_point_phase():
    cmd = [sys.executable, "-m", "libviso_torch.cli", "synth", "--metric",
           "l1", "--frames", "12"]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    check(proc.returncode == 0,
          f"{' '.join(cmd[1:])} exited {proc.returncode}:\n{proc.stderr}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    check(out["solved"] == 11, f"cli synth solved {out['solved']} of 12")
    print(f"[cli] {' '.join(cmd[2:])}: {json.dumps(out)}")


def _serve_sequences(seq0):
    """The serving streams: the phase-4 sequence (seed 0) and seeds 1-3 of
    the same KITTI-size generator, of lengths SERVE_LENGTHS."""
    from libviso_torch.synthetic import generate_sequence

    return [seq0] + [generate_sequence(**{**KITTI_SEQUENCE, "seed": s,
                                          "num_frames": n})
                     for s, n in enumerate(SERVE_LENGTHS) if s > 0]


def _match_problems(seqs, S, integer):
    """The match problems of frame 1 of the first S streams, as
    match_frame_triple stacks them: detector output, per-stream F, Sampson
    gate on the stereo problem.  With ``integer`` the frames are first
    rounded to uint8, as KITTI's PNGs are, so the descriptors (a Sobel
    patch) are integers; else they are floats."""
    import torch

    from libviso_torch.config import PipelineConfig
    from libviso_torch.geometry.mvg import F_from_P_host
    from libviso_torch.pipeline.stereo import build_frontend

    cfg = PipelineConfig().with_metric("l1")
    frontend = build_frontend(cfg)
    feats = []
    def image(im):
        im = np.asarray(im)
        if integer:
            im = np.clip(np.round(im), 0, 255).astype(np.uint8)
        return torch.tensor(im[None], device="cuda")

    for t in (0, 1):
        ims = [image(sq.frames[t][v]) for sq in seqs[:S] for v in (0, 1)]
        feats.append(frontend(torch.cat(ims[0::2]), torch.cat(ims[1::2])))
    prev, cur = feats

    def stack(a, b, c):
        return torch.stack([a, b, c], 1).flatten(0, 1).contiguous()

    F = torch.as_tensor(np.stack([F_from_P_host(sq.P1, sq.P2)
                                  for sq in seqs[:S]]), dtype=torch.float32,
                        device="cuda")
    return dict(
        q_xy=stack(cur.kp1.xy, cur.kp1.xy, cur.kp2.xy),
        q_valid=stack(cur.kp1.valid, cur.kp1.valid, cur.kp2.valid),
        q_d=stack(cur.d1, cur.d1, cur.d2),
        t_xy=stack(cur.kp2.xy, prev.kp1.xy, prev.kp2.xy),
        t_valid=stack(cur.kp2.valid, prev.kp1.valid, prev.kp2.valid),
        t_d=stack(cur.d2, prev.d1, prev.d2),
        F=F[:, None].expand(S, 3, 3, 3).reshape(3 * S, 3, 3).contiguous(),
        use_epi=torch.tensor([True, False, False], device="cuda").repeat(S))


TRACE_DIR = os.path.join(ROOT, "build", "chip_smoke_trace")


def traced_in_fresh_process(label, calls):
    """Per call (name, args, kwargs) of ``calls``, a function of
    ``_traceable()`` by name, its device activities and counts by
    torch.profiler (libviso_torch.utils.profiling's ``traced``, which
    raises where the trace lost a kernel record), traced in a fresh
    process: a kept CUPTI loses the first kernel records of a session
    once other processes have started on the card (PERF.md §6, PR 10),
    and this one has started some.  The calls travel by torch.save."""
    import torch

    os.makedirs(TRACE_DIR, exist_ok=True)
    path = os.path.join(TRACE_DIR, f"{label}.pt")
    torch.save(calls, path)
    proc = subprocess.run(
        [sys.executable, "-c",
         f"import chip_smoke; chip_smoke._trace_saved({path!r})"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0, f"the {label} trace process exited "
          f"{proc.returncode}:\n{proc.stderr[-2000:]}")
    with open(path + ".json") as fh:
        return json.load(fh)


def _traceable():
    from libviso_torch.ops import fused_matching as fm
    from libviso_torch.pipeline import refine

    return {"sorted_fused_two_min": fm.sorted_fused_two_min,
            "refine_window_motions": refine.refine_window_motions}


def _trace_saved(path):
    """The fresh process of ``traced_in_fresh_process``: trace each call
    saved at ``path`` and write, per call, its device activities and
    ``device_counts`` to path + ".json"."""
    import functools

    import torch

    from libviso_torch.utils import profiling as prof

    fns = _traceable()
    rows = []
    for name, args, kwargs in torch.load(path, weights_only=False):
        events = prof.traced(functools.partial(fns[name], *args, **kwargs),
                             where=f"{name} ({path})")
        rows.append({"activities": prof.device_activities(events),
                     **prof.device_counts(events)})
    with open(path + ".json", "w") as fh:
        json.dump(rows, fh)


def fused_kernel_phase(seqs):
    """Kernels #2 and #3 (the order and sweep kernels) against their plain
    versions; returns, per kernel, the max abs error, and per shape the
    mean ms of each timed call and the sweep's counts: the (query block,
    window) pairs it computes and their number without the skip, the
    pairs that pass the position and validity gates, and the route's
    device launches."""
    import torch

    from libviso_torch.ops import cuda_matching as cm
    from libviso_torch.ops import fused_matching as fm
    from libviso_torch.ops import matching as mt

    radius, thresh = 80.0, 1.0
    max_err = {"fused_gated_two_min": 0.0, "sweep_order": 0.0,
               "fused_sweep_two_min": 0.0}
    times, counts, route_calls = {}, {}, []
    for S in (1, 4):
        pb = _match_problems(seqs, S, integer=True)
        args = list(pb.values())
        shape = tuple(pb["q_d"].shape)
        ref = fm.fused_gated_two_min_plain(*args, thresh, radius)
        sref = fm.sorted_fused_two_min(*args, thresh, radius,
                                       sweep=fm.fused_sweep_two_min_plain)
        before = read_launches()
        got = fm.fused_gated_two_min(*args, thresh, radius)
        sgot = fm.sorted_fused_two_min(*args, thresh, radius)
        torch.cuda.synchronize()
        after = read_launches()
        for name in max_err:
            check(after[name] == before[name] + 1,
                  f"{name}: {after[name] - before[name]} launches for 1 call")
        for name, a, b in (("fused_gated_two_min", got, ref),
                           ("fused_sweep_two_min", sgot, sref)):
            check(all(torch.equal(x, y) for x, y in zip(a, b)),
                  f"{name} {shape}: kernel != plain bitwise on detector "
                  f"output")
        # the order kernel: permutations and boxes
        sides = (pb["q_xy"], pb["q_valid"], pb["t_xy"], pb["t_valid"])
        order = fm.sweep_order(*sides)
        check(all(torch.equal(x, y) for x, y in
                  zip(order, fm.sweep_order_plain(*sides))),
              f"sweep_order {shape}: kernel != plain bitwise on detector "
              f"output")
        # the dense route's kernel on the same problems
        l1 = cm.l1_distance_matrix(pb["q_d"], pb["t_d"])
        check(torch.equal(l1, cm.l1_distance_matrix_plain(pb["q_d"],
                                                          pb["t_d"])),
              f"l1_distance_matrix {shape}: kernel != plain bitwise on "
              f"detector output")
        # every row where the sweep picks another target than the dense
        # route is an exact distance tie
        dd = torch.where(
            fm.gate(pb["q_xy"], pb["q_valid"], pb["t_xy"], pb["t_valid"],
                    pb["F"], pb["use_epi"], thresh, radius),
            l1, torch.tensor(fm.BIG, device="cuda"))
        differ = (sgot[2] != got[2]).nonzero()
        b, r = differ.unbind(1)
        check(torch.equal(dd[b, r, sgot[2][b, r].long()],
                          dd[b, r, got[2][b, r].long()]),
              "a row where the sweep's idx differs from dense's is not an "
              "exact distance tie")
        check(torch.equal(sgot[0], got[0]), "sweep best != dense best")
        # the sweep's windows, and the pairs these inputs need: those
        # that pass the position and validity gates (Sampson off)
        N2, W = pb["t_xy"].shape[1], fm.SWEEP_WINDOW
        rows, split = fm.sweep_plan(*pb["q_valid"].shape)
        c0, c1 = fm.sweep_columns(order[2], order[3], radius, N2, rows=rows)
        live = int(((c1 - c0 + W - 1) // W).sum())
        total = c0.numel() * -(-N2 // W)
        pairs = int(fm.gate(*sides[:2], *sides[2:], pb["F"],
                            torch.zeros_like(pb["use_epi"]), thresh,
                            radius).sum())
        route_calls.append(("sorted_fused_two_min",
                            (*args, thresh, radius), {}))
        counts[shape] = {"windows": live, "windows_unskipped": total,
                         "pairs": pairs}
        print(f"[fused] {shape}: gated, sweep route, order kernel and "
              f"l1_distance_matrix == plain bitwise on detector output of "
              f"uint8 frames (integer descriptors); "
              f"{differ.shape[0]} sweep rows differ from "
              f"dense, all exact ties; sweep computes {live} (block, "
              f"window) pairs of {rows} rows x {W} columns in clusters of "
              f"{split} CTAs, of {total} without the skip, skip share "
              f"{1.0 - live / total:.4f}; {pairs} pairs pass the "
              f"position and validity gates")
        # the float frames' detector output: sums in another order than
        # the plain version's, so best and second agree within rtol 1e-5
        # and idx wherever the two smallest are not within that of a tie
        fl = _match_problems(seqs, S, integer=False)
        fargs = list(fl.values())
        fref = fm.fused_gated_two_min_plain(*fargs, thresh, radius)
        for name, fn in (("fused_gated_two_min", fm.fused_gated_two_min),
                         ("fused_sweep_two_min", fm.sorted_fused_two_min)):
            out = fn(*fargs, thresh, radius)
            err = 0.0
            for x, y in zip(out[:2], fref[:2]):
                has = torch.isfinite(y)
                check(torch.equal(has, torch.isfinite(x)),
                      f"{name} {shape} float: rows with candidates differ")
                err = max(err, float((x[has] - y[has]).abs().max()))
                check(torch.allclose(x[has], y[has], rtol=1e-5, atol=0.0),
                      f"{name} {shape} float: beyond rtol 1e-5 ({err})")
            clear = fref[1] - fref[0] > 1e-5 * fref[1]
            check(torch.equal(out[2][clear], fref[2][clear]),
                  f"{name} {shape} float: idx differs away from a tie")
            max_err[name] = max(max_err[name], err)
            print(f"[fused] {name} {shape} float descriptors: max abs err "
                  f"{err}")
        # times, in turns: plain versions, kernel #2, the order and sweep
        # kernels alone and the whole sweep route, and the three matcher
        # routes
        fns = {
            "plain": lambda: fm.fused_gated_two_min_plain(*args, thresh,
                                                          radius),
            "fused": lambda: fm.fused_gated_two_min(*args, thresh, radius),
            "order plain": lambda: fm.sweep_order_plain(*sides),
            "order": lambda: fm.sweep_order(*sides),
            "sweep": lambda: fm.swept_two_min(*args, order, thresh, radius),
            "sweep route": lambda: fm.sorted_fused_two_min(*args, thresh,
                                                           radius),
            "sweep route plain": lambda: fm.sorted_fused_two_min(
                *args, thresh, radius, sweep=fm.fused_sweep_two_min_plain),
        }
        for backend in ("dense", "fused", "sweep"):
            fns[f"route {backend}"] = (
                lambda b=backend: mt.match_problem_batch(
                    *args[:6], pb["use_epi"], ~pb["use_epi"],
                    torch.full((3 * S,), 0.9, device="cuda"), radius,
                    thresh, "l1", pb["F"], backend=b))
        for fn in fns.values():
            fn()
        torch.cuda.synchronize()
        ms = {k: [] for k in fns}
        for k in list(fns) + list(fns)[::-1]:
            ms[k].append(_time_ms(fns[k], reps=10))
        mean = {k: sum(v) / len(v) for k, v in ms.items()}
        print(f"[fused] {shape} ms per call (two turns each): " + ", ".join(
            f"{k} {mean[k]:.4f} ({v[0]:.4f}, {v[1]:.4f})"
            for k, v in ms.items()))
        times[shape] = mean
    for (shape, c), row in zip(counts.items(), traced_in_fresh_process(
            "sweep_route", route_calls)):
        names = row["activities"]
        check(len(names) == 2, f"sorted_fused_two_min {shape}: "
              f"{len(names)} device launches, not 2: {names}")
        c["route_launches"] = len(names)
        print(f"[fused] {shape}: the sweep route is {len(names)} device "
              f"launches by torch.profiler in a fresh process: {names}")
    return max_err, times, counts


def serving_phase(seqs):
    """run_multistream on 4 KITTI-size streams under each backend; returns
    the launches of each backend's kernel in its run and the frames/s."""
    import torch

    from libviso_torch.config import PipelineConfig
    from libviso_torch.pipeline.multistream import StreamPool, run_multistream
    from libviso_torch.pipeline.stereo import run_stereo_sequence
    from libviso_torch.utils.metrics import ate_rmse

    cfg = PipelineConfig().with_metric("l1")
    args = ([sq.frames for sq in seqs], [sq.P1 for sq in seqs],
            [sq.P2 for sq in seqs])
    T = max(SERVE_LENGTHS)
    stats, launches, fps = {}, {}, {}
    for backend in ("dense", "fused", "sweep"):
        solos = [run_stereo_sequence(sq.frames, sq.P1, sq.P2, cfg, seed=s,
                                     device="cuda", backend=backend)
                 for s, sq in enumerate(seqs)]
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        multi = run_multistream(*args, cfg, seeds=range(len(seqs)),
                                device="cuda", backend=backend)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = read_launches()
        for name in BACKEND_KERNELS[backend]:
            launches[name] = counts[name]
            check(counts[name] == T, f"{backend}: {name} launched "
                  f"{counts[name]} times in {T} timesteps")
        name = " and ".join(BACKEND_KERNELS[backend])
        fps[backend] = sum(SERVE_LENGTHS) / dt
        tr_err = 0.0
        for s, (solo, got) in enumerate(zip(solos, multi)):
            check([{k: x[k] for k in STATS} for x in got.stats]
                  == [{k: x[k] for k in STATS} for x in solo.stats],
                  f"{backend}: stream {s} differs from its solo run")
            tr_err = max(tr_err,
                         float(np.abs(got.motions - solo.motions).max()))
        check(tr_err <= 5e-6, f"{backend}: a stream's motions differ from "
              f"its solo run by {tr_err}")
        stats[backend] = [[{k: x[k] for k in STATS} for x in r.stats]
                          for r in multi]
        ates = [ate_rmse(r.poses, sq.gt_poses) for r, sq in zip(multi, seqs)]
        solved = [int(r.frame_ok.sum()) for r in multi]
        for s, n in enumerate(SERVE_LENGTHS):
            if n == 20:
                check(solved[s] == 19 and ates[s] <= ATE_BOUND,
                      f"{backend}: stream {s} solved {solved[s]}/19, ATE "
                      f"{ates[s]} m (bound {ATE_BOUND} m)")
        print(f"[serve] {backend}: 4 streams, one batched solve a timestep, "
              f"== solo runs on every discrete stat, max |tr| difference "
              f"{tr_err}; {name} {T} launches each in {T} timesteps; "
              f"solved {solved}, ATE {ates}; {fps[backend]:.2f} aggregate "
              f"frames/s ({sum(SERVE_LENGTHS)} frames in {dt:.3f} s)")
    check(stats["fused"] == stats["dense"],
          "fused and dense differ on a discrete per-frame stat")
    print(f"[serve] fused == dense on every discrete stat; sweep == dense: "
          f"{stats['sweep'] == stats['dense']}")

    pool = StreamPool(cfg, slots=2, device="cuda", backend="fused")
    queue = list(enumerate(seqs))
    slot_seq, results = {}, {}
    for slot in range(2):
        s, sq = queue.pop(0)
        pool.attach(slot, sq.frames, sq.P1, sq.P2, seed=s)
        slot_seq[slot] = s
    while pool.active() or pool.finished():
        if pool.active():
            pool.step()
        for slot in pool.finished():
            results[slot_seq.pop(slot)] = pool.detach(slot)
            if queue:
                s, sq = queue.pop(0)
                pool.attach(slot, sq.frames, sq.P1, sq.P2, seed=s)
                slot_seq[slot] = s
    for s in range(len(seqs)):
        check([{k: x[k] for k in STATS} for x in results[s].stats]
              == stats["fused"][s], f"pool: sequence {s} differs from its "
              "solo run")
    print("[serve] StreamPool, 2 slots over 4 sequences: each equals its "
          "solo run")
    return launches, fps


def serve_cli_phase():
    """`cli serve --pool 2` on a mini KITTI tree, where PIL imports."""
    try:
        from PIL import Image
    except ImportError:
        print("[serve-cli] PIL does not import here: cli serve not run")
        return
    import shutil

    from libviso_torch.synthetic import generate_sequence

    home = os.path.join(ROOT, "build", "chip_smoke_kitti")
    shutil.rmtree(home, ignore_errors=True)
    for name, seed in (("77", 7), ("78", 8)):
        seq = generate_sequence(num_frames=6, num_points=500, seed=seed,
                                width=416, height=160)
        base = os.path.join(home, "sequences", name)
        for cam in ("image_0", "image_1"):
            os.makedirs(os.path.join(base, cam))
        with open(os.path.join(base, "calib.txt"), "w") as fh:
            for row, P in (("P0", seq.P1), ("P1", seq.P2)):
                fh.write(f"{row}: " + " ".join(f"{v:.9e}" for v in
                                              P.reshape(-1)) + "\n")
        for i, pair in enumerate(seq.frames):
            for cam, im in zip(("image_0", "image_1"), pair):
                Image.fromarray(im.astype(np.uint8)).save(
                    os.path.join(base, cam, f"{i:06d}.png"))
    cmd = [sys.executable, "-m", "libviso_torch.cli", "serve", "smoke",
           "77,78", "--pool", "2", "--kitti-home", home, "--metric", "l1",
           "--backend", "fused"]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    check(proc.returncode == 0,
          f"{' '.join(cmd[1:])} exited {proc.returncode}:\n{proc.stderr}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    for sq in out["sequences"]:
        rows = np.loadtxt(sq["poses"])
        check(sq["solved"] == 5 and rows.shape == (6, 12),
              f"cli serve: {sq}")
    shutil.rmtree(home)
    print(f"[serve-cli] cli serve --pool 2 --backend fused: "
          f"{json.dumps(out)}")


def _same_run(got, want, what):
    """Bitwise: every stat (the float ones too), motions and poses."""
    check(got.stats == want.stats, f"{what}: a per-frame stat differs")
    check(np.array_equal(got.motions, want.motions)
          and np.array_equal(got.poses, want.poses)
          and np.array_equal(got.frame_ok, want.frame_ok),
          f"{what}: motions or poses differ")


def stereo_path_phase(seq, seqs, whole, serve_fps):
    """Phase 9: chunked and resumed runs, the batched solve's stage
    time, the frame-batched window, the detector options, the hold on a
    failed frame and world frames.  ``whole`` is phase 4's l1 result,
    ``serve_fps`` phase 8's aggregate frames/s per backend.  Returns the
    kernels' launches in the windows."""
    import dataclasses
    import shutil

    import torch

    from libviso_torch.config import Calib, PipelineConfig
    from libviso_torch.geometry.mvg import F_from_P_host
    from libviso_torch.pipeline.batched import build_batched_odometry
    from libviso_torch.pipeline.multistream import run_multistream
    from libviso_torch.pipeline.stereo import run_stereo_sequence
    from libviso_torch.solvers.ransac import frame_generator, sample_gumbel
    from libviso_torch.utils.checkpoint import CheckpointManager

    cfg = PipelineConfig().with_metric("l1")
    run = lambda frames, **kw: run_stereo_sequence(  # noqa: E731
        frames, seq.P1, seq.P2, cfg, seed=0, device="cuda", **kw)
    T = len(seq.frames)

    # chunked
    reset_launches()
    chunked = run(seq.frames, chunk=4)
    n = read_launches()["l1_distance_matrix"]
    _same_run(chunked, whole, "chunk=4 against chunk=1")
    check(n == T, f"chunk=4: kernel launched {n} times for {T} frames")
    print(f"[chunk] run_stereo_sequence(chunk=4) == the chunk=1 run of the "
          f"main path bit for bit on {T} frames, {n} kernel launches")

    # resume
    ckdir = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    shutil.rmtree(ckdir, ignore_errors=True)
    mgr = CheckpointManager(ckdir, every=8)
    cut = run(seq.frames[:8], chunk=4, checkpoint=mgr)
    resumed = run(seq.frames, chunk=4, checkpoint=mgr)
    shutil.rmtree(ckdir)
    check(cut.processed == 8 and resumed.processed == T - 8,
          f"resume computed {resumed.processed} frames, not {T - 8}")
    _same_run(resumed, whole, "resumed at frame 8 against uninterrupted")
    print(f"[resume] cut at frame 8 by a checkpoint and resumed "
          f"({resumed.processed} frames computed) == the uninterrupted run "
          f"bit for bit")

    # the batched solve: stage times of the 4-stream step, sync after each
    marks = []

    def on_stage(stage):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    run_multistream([sq.frames for sq in seqs], [sq.P1 for sq in seqs],
                    [sq.P2 for sq in seqs], cfg, seeds=range(len(seqs)),
                    device="cuda", backend="fused", on_stage=on_stage)
    rows = np.diff(np.asarray(marks)).reshape(-1, 4)[2:] * 1e3
    solves, step = float(rows[:, 3].mean()), float(rows.sum(1).mean())
    live = np.mean([sum(t < k for k in SERVE_LENGTHS)
                    for t in range(2, max(SERVE_LENGTHS))])
    old = PER_STREAM_SOLVES
    print(f"[batched-solve] 4 streams, fused, timesteps 2-19, one solve "
          f"call a timestep for {live:.2f} live streams on average: solves "
          f"{solves:.4f} ms of a {step:.4f} ms timestep (per-stream solves "
          f"in another call: {old['fused']['solves_ms']} of "
          f"{old['fused']['step_ms']} ms); aggregate frames/s of the "
          f"serving phase " + ", ".join(
              f"{b} {serve_fps[b]:.2f} (was {old[b]['fps']})"
              for b in serve_fps))

    # the frame-batched window against the streaming run, same draws
    W = 8
    shape = (cfg.ransac.num_hypotheses, cfg.detector.num_slots)
    draws = torch.stack([sample_gumbel(shape, frame_generator(0, t))
                         for t in range(1, W)])
    ims = [torch.tensor(np.stack([np.asarray(f[v]) for f in seq.frames[:W]]),
                        device="cuda") for v in (0, 1)]
    calib = Calib.from_projections(seq.P1, seq.P2)
    F = torch.as_tensor(F_from_P_host(seq.P1, seq.P2), dtype=torch.float32,
                        device="cuda")
    window_launches = {}
    for backend in ("dense", "fused", "sweep"):
        fn = build_batched_odometry(calib, F, cfg, backend=backend)
        reset_launches()
        out = fn(*ims, draws.cuda())
        torch.cuda.synchronize()
        counts = read_launches()
        for name in BACKEND_KERNELS[backend]:
            window_launches[name] = counts[name]
            check(counts[name] == 2, f"window, {backend}: {name} launched "
                  f"{counts[name]} times for 2 matcher calls")
        stream = run(seq.frames[:W], backend=backend)
        for t in range(1, W):
            st = stream.stats[t]
            got = (bool(out.ok[t]), int(out.num_circle[t]),
                   int(out.num_inliers[t]), int(out.num_lr[t]))
            check(got == (st["ok"], st["num_circle"], st["num_inliers"],
                          st["num_lr"]),
                  f"window, {backend}: frame {t} {got} != streaming {st}")
        err = float(np.abs(out.motions.cpu().numpy()[1:]
                           - stream.motions[1:]).max())
        check(err <= 1e-4, f"window, {backend}: motions differ by {err}")
        print(f"[window] build_batched_odometry, {W} frames, {backend}: "
              f"frames 1-{W - 1} == the streaming run on every discrete "
              f"stat, max |tr| difference {err}; "
              f"{' and '.join(BACKEND_KERNELS[backend])} 2 launches each "
              f"for the {W} stereo and {2 * (W - 1)} temporal problems")

    # detector options: card against CPU
    opt = dataclasses.replace(cfg, detector=dataclasses.replace(
        cfg.detector, pyramid_levels=2, subpixel=True, sharpen_sigma=3.0,
        sharpen_auto=True, nms_radius=2))
    runs = [run_stereo_sequence(seq.frames[:4], seq.P1, seq.P2, opt, seed=0,
                                device=d) for d in ("cpu", "cuda")]
    for a, b in zip(runs[1].stats, runs[0].stats):
        check({k: a[k] for k in STATS} == {k: b[k] for k in STATS},
              f"options, frame {a['frame']}: card {a} != cpu {b}")
    err = float(np.abs(runs[1].motions - runs[0].motions).max())
    check(err <= 1e-4 and runs[1].frame_ok[1:].all(),
          f"options: card and CPU motions differ by {err}")
    print(f"[options] pyramid_levels=2, subpixel, sharpen_auto, "
          f"nms_radius=2, 4 frames: card == CPU on every discrete stat "
          f"({[s['num_inliers'] for s in runs[1].stats]} inliers), max |tr| "
          f"difference {err}")

    # keep_features_on_failure: frame 3 blanked
    frames = list(seq.frames[:6])
    frames[3] = tuple(np.zeros_like(np.asarray(im)) for im in frames[3])
    keep = run_stereo_sequence(
        frames, seq.P1, seq.P2,
        dataclasses.replace(cfg, keep_features_on_failure=True), seed=0,
        device="cuda")
    drop = run(frames)
    check(keep.frame_ok.tolist() == [False, True, True, False, True, True],
          f"keep_features_on_failure: ok {keep.frame_ok.tolist()}")
    check(drop.frame_ok.tolist() == [False, True, True, False, False, True],
          f"without the hold: ok {drop.frame_ok.tolist()}")
    ratio = float(keep.motions[4][5] / keep.motions[2][5])
    check(1.7 < ratio < 2.3, f"the held frame's motion spans {ratio} steps")
    print(f"[keep] frame 3 blanked: with keep_features_on_failure frame 4 "
          f"matches against frame 2 (tz {ratio:.3f} steps) and solves; "
          f"without it frame 4 fails too")

    # world frames through the CLI, at the generator's own default size
    # (620x188): its host-side ray casting takes about a second a frame
    # there and several at KITTI size
    cmd = [sys.executable, "-m", "libviso_torch.cli", "synth", "--world",
           "--chunk", "4", "--metric", "l1", "--backend", "sweep",
           "--frames", "10"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    check(proc.returncode == 0,
          f"{' '.join(cmd[1:])} exited {proc.returncode}:\n{proc.stderr}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    check(out["solved"] == 9 and out["ate_rmse_m"] < 0.2,
          f"cli synth --world: {out}")
    print(f"[world] {' '.join(cmd[2:])} (620x188 frames, the generator's "
          f"default size; {time.perf_counter() - t0:.1f} s with the "
          f"rendering): {json.dumps(out)}")
    return window_launches


def _mono_problems(seq):
    """The two match problems of frame 1 of the mono path, on the frames
    rounded to uint8 (integer descriptors), each a (1, 1536, ...) batch:
    the temporal match (radius 10, no Sampson gate) and the re-match under
    the F that frame 1's first essential matrix induces (radius 10,
    Sampson gate 1.0).  Returns {"temporal": problem, "rematch": problem}
    in match_problem_batch's argument order."""
    import torch

    from libviso_torch.config import PipelineConfig
    from libviso_torch.geometry.essential import (
        normalize_points,
        ransac_essential,
    )
    from libviso_torch.config import MonoConfig
    from libviso_torch.ops.features import detect_and_describe
    from libviso_torch.ops.matching import match_descriptors
    from libviso_torch.pipeline.mono import mono_draws, mono_hypotheses

    cfg = PipelineConfig.mono().with_metric("l1")
    K = np.asarray(seq.P1[:, :3], np.float64)
    feats = []
    for t in (0, 1):
        im = np.clip(np.round(np.asarray(seq.frames[t][0])), 0, 255)
        feats.append(detect_and_describe(
            torch.tensor(im.astype(np.uint8), device="cuda"), cfg.detector))
    (kp0, d0), (kp1, d1) = feats
    m = match_descriptors(kp1, d1, kp0, d0, cfg.temporal_match)
    Kt = torch.tensor(K, dtype=torch.float32, device="cuda")
    n = cfg.detector.num_slots
    mono = MonoConfig()
    h1, h2 = mono_hypotheses(mono)
    g1, _ = mono_draws(0, 1, (h1, n), (h2, n))     # frame 1's est1 draws
    est1 = ransac_essential(
        normalize_points(kp1.xy, Kt),
        normalize_points(kp0.xy[torch.clamp(m.idx, 0, n - 1)], Kt),
        valid=m.valid, gumbel=g1.cuda(), num_hypotheses=g1.shape[0],
        sampson_thresh=mono.sampson_thresh, method=mono.method,
        scoring=mono.scoring, soft_refit=mono.soft_refit)
    Kinv = torch.tensor(np.linalg.inv(K), dtype=torch.float32, device="cuda")
    F = (Kinv.T @ est1.E) @ Kinv
    base = [kp1.xy[None], kp1.valid[None], d1[None].contiguous(),
            kp0.xy[None], kp0.valid[None], d0[None].contiguous(),
            F[None].contiguous()]
    return {name: base + [torch.tensor([epi], device="cuda")]
            for name, epi in (("temporal", False), ("rematch", True))}


def mono_kernel_phase(seq):
    """Kernels #1-#3 at the mono shape against their plain versions, and
    their times there; returns {kernel: {"max_abs_err", "ms", ...}}."""
    import torch

    from libviso_torch.ops import cuda_matching as cm
    from libviso_torch.ops import fused_matching as fm

    radius, thresh = 10.0, 1.0
    g = torch.Generator(device="cuda").manual_seed(6)
    a, b = (torch.randint(-1020, 1021, MONO_SHAPE, generator=g,
                          device="cuda").float() for _ in range(2))
    check(torch.equal(cm.l1_distance_matrix(a, b),
                      cm.l1_distance_matrix_plain(a, b)),
          f"l1_distance_matrix {MONO_SHAPE}: kernel != plain bitwise on "
          f"random integer descriptors")
    problems = _mono_problems(seq)
    for name, args in problems.items():
        q_d, t_d = args[2], args[5]
        check(tuple(q_d.shape) == MONO_SHAPE,
              f"mono problem shape {tuple(q_d.shape)} != {MONO_SHAPE}")
        got = fm.fused_gated_two_min(*args, thresh, radius)
        ref = fm.fused_gated_two_min_plain(*args, thresh, radius)
        sgot = fm.sorted_fused_two_min(*args, thresh, radius)
        sref = fm.sorted_fused_two_min(*args, thresh, radius,
                                       sweep=fm.fused_sweep_two_min_plain)
        sides = (args[0], args[1], args[3], args[4])
        check(all(torch.equal(x, y) for x, y in zip(got, ref)),
              f"fused_gated_two_min {name} {MONO_SHAPE}: != plain bitwise")
        check(all(torch.equal(x, y) for x, y in zip(sgot, sref)),
              f"sorted_fused_two_min {name} {MONO_SHAPE}: != plain bitwise")
        check(all(torch.equal(x, y) for x, y in zip(
            fm.sweep_order(*sides), fm.sweep_order_plain(*sides))),
              f"sweep_order {name} {MONO_SHAPE}: != plain bitwise")
        check(torch.equal(cm.l1_distance_matrix(q_d, t_d),
                          cm.l1_distance_matrix_plain(q_d, t_d)),
              f"l1_distance_matrix {name} {MONO_SHAPE}: != plain bitwise")
        rows = int(torch.isfinite(ref[0]).sum())
        print(f"[mono-kernel] {name} problem of frame 1 {MONO_SHAPE}: "
              f"gated, sweep route, order kernel and l1_distance_matrix == "
              f"plain bitwise on integer descriptors; {rows} of "
              f"{int(args[1].sum())} valid query rows have a candidate")

    # times in turns on the re-match problem (the Sampson-gated one)
    args = problems["rematch"]
    q_d, t_d = args[2], args[5]
    sides = (args[0], args[1], args[3], args[4])
    order = fm.sweep_order(*sides)
    fns = {
        "l1 plain": lambda: cm.l1_distance_matrix_plain(q_d, t_d),
        "l1": lambda: cm.l1_distance_matrix(q_d, t_d),
        "cdist": lambda: torch.cdist(q_d, t_d, p=1),
        "gated plain": lambda: fm.fused_gated_two_min_plain(*args, thresh,
                                                            radius),
        "gated": lambda: fm.fused_gated_two_min(*args, thresh, radius),
        "order plain": lambda: fm.sweep_order_plain(*sides),
        "order": lambda: fm.sweep_order(*sides),
        "sweep": lambda: fm.swept_two_min(*args, order, thresh, radius),
        "sweep route": lambda: fm.sorted_fused_two_min(*args, thresh,
                                                       radius),
        "sweep route plain": lambda: fm.sorted_fused_two_min(
            *args, thresh, radius, sweep=fm.fused_sweep_two_min_plain),
    }
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    ms = {k: [] for k in fns}
    for k in list(fns) + list(fns)[::-1]:
        ms[k].append(_time_ms(fns[k], reps=10))
    t = {k: sum(v) / len(v) for k, v in ms.items()}
    B, N, D = MONO_SHAPE
    pairs = int(fm.gate(*sides[:2], *sides[2:], args[6],
                        torch.zeros_like(args[7]), thresh, radius).sum())
    l1_bound = bound_ms(2 * B * N * N * D, 4 * B * (2 * N * D + N * N))
    n_boxes = sum(-(-N // k) for k in fm.SWEEP_TILING)
    rows = {
        "l1_distance_matrix": {
            "ms": t["l1"], "plain_ms": t["l1 plain"],
            "library_ms": t["cdist"], "bound": l1_bound},
        "fused_gated_two_min": {
            "ms": t["gated"], "plain_ms": t["gated plain"],
            "library_ms": None, "pairs": pairs,
            "bound": two_min_bound(B, N, N, D, pairs)},
        "sweep_order": {
            "ms": t["order"], "plain_ms": t["order plain"],
            "library_ms": None,
            "bound": bound_ms(2 * B * N * math.log2(N),
                              B * (2 * N * 9 + 2 * N * 4 + 16 * n_boxes))},
        "fused_sweep_two_min": {
            "ms": t["sweep route"], "order_ms": t["order"],
            "sweep_ms": t["sweep"], "fused_ms": t["gated"],
            "plain_ms": t["sweep route plain"], "library_ms": None,
            "pairs": pairs, "bound": two_min_bound(B, N, N, D, pairs)},
    }
    for row in rows.values():
        row["bound_ms"], row["bound_by"] = row.pop("bound")
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
    print(f"[mono-kernel] {MONO_SHAPE} re-match problem, ms per call (two "
          f"turns each): " + ", ".join(
              f"{k} {t[k]:.4f} ({v[0]:.4f}, {v[1]:.4f})"
              for k, v in ms.items())
          + f"; {pairs} pairs pass the position and validity gates; bounds "
          + ", ".join(f"{k} {r['bound_ms']:.4f} ms ({r['bound_by']}, share "
                      f"{r['share_of_bound']:.3f})" for k, r in rows.items()))
    return rows


def mono_phase(seq):
    """run_mono_sequence at full width under each backend (metric l1) and
    under l2; returns each kernel's launches in its backend's run (the
    counts set to 0 just before the run and read just after)."""
    import torch

    from libviso_torch.config import PipelineConfig
    from libviso_torch.pipeline.mono import run_mono_sequence
    from libviso_torch.utils.metrics import ate_rmse

    K = np.asarray(seq.P1[:, :3], np.float64)
    frames = [f[0] for f in seq.frames]
    T = len(frames)
    stats, launches = {}, {}
    for metric, backend in (("l1", "dense"), ("l1", "fused"),
                            ("l1", "sweep"), ("l2", "dense")):
        ends = []

        def on_frame(t, out):
            torch.cuda.synchronize()
            ends.append(time.perf_counter())

        reset_launches()
        res = run_mono_sequence(frames, K,
                                PipelineConfig.mono().with_metric(metric),
                                seed=0, device="cuda", backend=backend,
                                on_frame=on_frame)
        counts = read_launches()
        solved = int(res.frame_ok.sum())
        ate = ate_rmse(res.poses, seq.gt_poses, align="sim3")
        fps = (len(ends) - 2) / (ends[-1] - ends[1])
        check(solved >= T - 2 and ate <= MONO_ATE_BOUND[metric],
              f"mono {metric} {backend}: solved {solved}/{T - 1}, Sim(3) "
              f"ATE {ate} m (bound {MONO_ATE_BOUND[metric]} m, JAX "
              f"{JAX_MONO_ATE_M[metric]} m)")
        note = ""
        if metric == "l1":
            for name in BACKEND_KERNELS[backend]:
                launches[name] = counts[name]
                check(counts[name] == 2 * T, f"mono {backend}: {name} "
                      f"launched {counts[name]} times in {T} frames")
            stats[backend] = [{k: x[k] for k in MONO_STATS}
                              for x in res.stats]
            note = (f"; {' and '.join(BACKEND_KERNELS[backend])} "
                    f"{2 * T} launches each in {T} frames")
        print(f"[mono] metric {metric}, {backend}: solved {solved}/{T - 1}, "
              f"Sim(3) ATE {ate} m (JAX {JAX_MONO_ATE_M[metric]} m, bound "
              f"{MONO_ATE_BOUND[metric]:.4f} m), {fps:.2f} frames/s over "
              f"frames 2-{T - 1}; inliers "
              f"{[x['num_inliers'] for x in res.stats]}{note}")
    for backend in ("fused", "sweep"):
        check(stats[backend] == stats["dense"],
              f"mono: {backend} and dense differ on a discrete stat")
    print("[mono] fused == sweep == dense on every discrete per-frame stat "
          "(ok, matches, inliers, scale support, span) on the same draws")
    return launches


def mono_cli_phase():
    """`cli mono --device cuda` on a folder of 6 generated PNG frames,
    where PIL imports."""
    try:
        from PIL import Image
    except ImportError:
        print("[mono-cli] PIL does not import here: cli mono not run")
        return
    import shutil

    from libviso_torch.synthetic import generate_sequence

    home = os.path.join(ROOT, "build", "chip_smoke_mono")
    shutil.rmtree(home, ignore_errors=True)
    os.makedirs(home)
    seq = generate_sequence(num_frames=6, num_points=500, seed=7, width=416,
                            height=160)
    for i, pair in enumerate(seq.frames):
        Image.fromarray(np.asarray(pair[0]).astype(np.uint8)).save(
            os.path.join(home, f"{i:06d}.png"))
    np.savetxt(os.path.join(home, "K.txt"), seq.P1[:, :3])
    out_path = os.path.join(home, "poses.txt")
    cmd = [sys.executable, "-m", "libviso_torch.cli", "mono", "--image-mask",
           os.path.join(home, "%06d.png"), "--calib",
           os.path.join(home, "K.txt"), "--out", out_path, "--metric", "l1",
           "--backend", "fused"]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    check(proc.returncode == 0,
          f"{' '.join(cmd[1:])} exited {proc.returncode}:\n{proc.stderr}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    rows = np.loadtxt(out_path)
    check(out["solved"] == 5 and rows.shape == (6, 12)
          and np.isfinite(rows).all(), f"cli mono: {out}")
    shutil.rmtree(home)
    print(f"[mono-cli] cli mono --metric l1 --backend fused on 6 frames: "
          f"{json.dumps(out)}")



def _jax_stereo_draws(cfg):
    """The JAX package's per-frame and loop verification draws
    (tools/threefry.py: numpy, no JAX)."""
    import torch

    from tools import threefry as tf

    shape = (cfg.ransac.num_hypotheses, cfg.detector.num_slots)
    vshape = (max(256, cfg.ransac.num_hypotheses), 256)
    return dict(
        draws=lambda t: torch.from_numpy(tf.frame_gumbel(0, t, shape)),
        verify_draws=lambda t, it: torch.from_numpy(
            tf.loop_verify_gumbel(0, t, it, vshape)))


def loop_circle_sequence(T=96):
    """The 96-frame KITTI-size circle of radius 10 m (tests/
    test_loop_closure.py's _circle_sequence at full size)."""
    from libviso_torch.synthetic import generate_sequence

    yaw = 2 * np.pi / (T - 1)
    steps = np.zeros((T, 6))
    steps[1:] = [0.0, yaw, 0.0, 0.0, 0.0, 2 * 10.0 * np.sin(yaw / 2)]
    return generate_sequence(num_frames=T, num_points=1400, seed=3,
                             width=1241, height=376, f=718.856,
                             base=0.5371657, trajectory=steps)


def loop_phase(seq):
    """Phase 11: run_with_loop_closure on the 96-frame KITTI-size circle
    ``seq`` under each backend.  Returns (per-kernel launches in its
    backend's run, the candidate search of keyframe 80 in the dense run:
    (q_xy, q_desc, q_valid, kf_xy, kf_desc, kf_valid), ms of each run)."""
    import torch

    from libviso_torch.config import PipelineConfig
    from libviso_torch.pipeline import loop as tl
    from libviso_torch.utils.metrics import ate_rmse

    frames = list(seq.frames)
    T = len(frames)
    cfg = PipelineConfig().with_metric("l1")
    draws = _jax_stereo_draws(cfg)
    captured = {}
    real_offer = tl.LoopEngine.offer

    def offer(self, t, xy, desc, obs, X, valid, pos_fn):
        # keyframe 80's candidate search, the first that closes a loop
        if t == 80 and "problem" not in captured:
            captured["problem"] = (xy, desc, valid, self.kf_xy.clone(),
                                   self.kf_desc.clone(),
                                   self.kf_valid.clone())
        return real_offer(self, t, xy, desc, obs, X, valid, pos_fn)

    gt = seq.gt_poses
    results, launches, fps = {}, {}, {}
    tl.LoopEngine.offer = offer
    try:
        for backend in ("dense", "fused", "sweep"):
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            res = tl.run_with_loop_closure(frames, seq.P1, seq.P2, cfg,
                                           backend=backend, device="cuda",
                                           **LOOP_KW, **draws)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = read_launches()
            fps[backend] = T / dt
            searches = res.keyframes_offered - 1
            guided = sum(3 for c in res.candidates if "refine_trace" in c)
            for name in BACKEND_KERNELS[backend]:
                launches[name] = counts[name]
                check(counts[name] == T + searches + guided,
                      f"loop {backend}: {name} launched {counts[name]} "
                      f"times, not {T} frames + {searches} candidate "
                      f"searches + {guided} guided matches")
            solved = int(res.frame_ok.sum())
            pairs = [(le.frame_new, le.frame_old) for le in res.loops]
            want = [(n, o) for n, o, _ in JAX_LOOP["loops"]]
            ate_vo = ate_rmse(res.poses_vo, gt)
            ate_opt = ate_rmse(res.poses, gt)
            end = [float(np.linalg.norm(P[-1, :3, 3] - gt[-1, :3, 3]))
                   for P in (res.poses_vo, res.poses)]
            check(solved == JAX_LOOP["solved"],
                  f"loop {backend}: solved {solved}/{T - 1}")
            check(pairs == want, f"loop {backend}: loops {pairs}, JAX {want}")
            for le, (_, _, n) in zip(res.loops, JAX_LOOP["loops"]):
                check(abs(le.num_inliers - n) <= 0.1 * n,
                      f"loop {backend}: {le.frame_new}->{le.frame_old} "
                      f"{le.num_inliers} inliers, JAX {n}")
            check(ate_opt <= LOOP_ATE_BOUND,
                  f"loop {backend}: optimized ATE {ate_opt} m above "
                  f"{LOOP_ATE_BOUND} m (JAX {JAX_LOOP['ate_opt_m']} m)")
            check(res.graph_cost[1] < res.graph_cost[0],
                  f"loop {backend}: graph cost {res.graph_cost}")
            check(end[1] < end[0], f"loop {backend}: endpoint error "
                  f"{end[1]} m optimized, {end[0]} m open chain (JAX "
                  f"{JAX_LOOP['end_opt_m']} < {JAX_LOOP['end_vo_m']})")
            results[backend] = (
                [(c["frame_new"], c["frame_old"], c["score"], c["ok"],
                  c["num_inliers"], c["refined_inliers"])
                 for c in res.candidates],
                [(le.frame_new, le.frame_old, le.num_inliers,
                  le.tr.tolist()) for le in res.loops])
            found = [(le.frame_new, le.frame_old, le.num_inliers)
                     for le in res.loops]
            print(f"[loop] {backend}: solved {solved}/{T - 1}; loops {found} "
                  f"(JAX {JAX_LOOP['loops']}); {len(res.candidates)} "
                  f"candidates verified (JAX {JAX_LOOP['candidates']}); "
                  f"graph cost {res.graph_cost[0]:.6f} -> "
                  f"{res.graph_cost[1]:.6g} (JAX {JAX_LOOP['graph_cost']}); "
                  f"edge scales {res.loop_edge_scale.tolist()}; ATE "
                  f"{ate_vo:.4f} m open chain, {ate_opt:.4f} m optimized "
                  f"(JAX {JAX_LOOP['ate_vo_m']:.4f} / "
                  f"{JAX_LOOP['ate_opt_m']:.4f}, bound "
                  f"{LOOP_ATE_BOUND:.4f}); endpoint {end[0]:.4f} -> "
                  f"{end[1]:.4f} m; {' and '.join(BACKEND_KERNELS[backend])}"
                  f" {counts[BACKEND_KERNELS[backend][0]]} launches each "
                  f"({T} frames, {searches} candidate searches, {guided} "
                  f"guided matches); {fps[backend]:.2f} frames/s with the "
                  f"loop work")
    finally:
        tl.LoopEngine.offer = real_offer
    check(results["fused"] == results["dense"] == results["sweep"],
          "loop: the backends' candidates or loops differ")
    print("[loop] dense == fused == sweep: the same candidates (frames, "
          "scores, seed and refined inliers) and loop edges (bitwise tr) on "
          "the same draws")
    # one candidate search through each route: one launch of each of the
    # route's kernels, by the wrappers' counts
    xy, desc, valid, kf_xy, kf_desc, kf_valid = captured["problem"]
    for backend in ("dense", "fused", "sweep"):
        match_all = tl._build_candidate_matcher(cfg, 128, 256, backend, 0.8)
        reset_launches()
        match_all(xy, desc, valid, kf_xy, kf_desc, kf_valid)
        torch.cuda.synchronize()
        got = read_launches()
        want = {k: int(k in BACKEND_KERNELS[backend]) for k in got}
        check(got == want, f"loop {backend}: a candidate search launched "
              f"{got}, not {want}")
    print("[loop] a candidate search of (128, 256, 128) is one launch of "
          "each of the route's kernels (each route)")
    return launches, captured["problem"], fps


def _finite_max_abs_diff(x, y):
    """max |x - y| where y is finite (0.0 where none is)."""
    import torch

    d = (x.float() - y.float())[torch.isfinite(y.float())]
    return float(d.abs().max()) if d.numel() else 0.0


def _problem_from_search(problem):
    """The match_problem_batch arguments of a candidate search (the new
    keyframe against each store slot): radius 1e9, no Sampson gate."""
    import torch

    xy, desc, valid, kf_xy, kf_desc, kf_valid = problem
    K, B, D = kf_desc.shape
    return [xy.expand(K, B, 2).contiguous(),
            valid.expand(K, B).contiguous(),
            desc.expand(K, B, D).contiguous(), kf_xy, kf_valid,
            kf_desc.contiguous(),
            torch.eye(3, device="cuda").expand(K, 3, 3).contiguous(),
            torch.zeros(K, dtype=torch.bool, device="cuda")]


def _integer_problem(shape, seed):
    """A (B, N, D) loop-shaped problem with integer descriptors: positions
    in a KITTI image, 90 % of the slots valid, no Sampson gate."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    B, N, D = shape

    def xy():
        return (torch.rand((B, N, 2), generator=g, device="cuda")
                * torch.tensor([1240.0, 375.0], device="cuda"))

    def valid():
        return torch.rand((B, N), generator=g, device="cuda") > 0.1

    def desc():
        return torch.randint(-1020, 1021, (B, N, D), generator=g,
                             device="cuda").float()

    q_xy, q_valid, q_d = xy(), valid(), desc()
    return [q_xy, q_valid, q_d, xy(), valid(), desc(),
            torch.eye(3, device="cuda").expand(B, 3, 3).contiguous(),
            torch.zeros(B, dtype=torch.bool, device="cuda")]


def kernel_shapes_phase(tag, problems, seed0):
    """Kernels #1-#3 against their plain versions at the shapes of a
    path, on integer descriptors and on the path's real problems
    (``problems``: {shape: (label, the match_problem_batch arguments of
    the kernels, Sampson threshold, radius)}), and timed on the real ones.
    Phase 12 (the loop shapes), phase 16 (the BA window's), and phases 21
    and 24 (the chunk's and the serving entry's).  Returns
    {shape: {kernel: row of the kernels line}} and the max abs error per
    kernel."""
    import torch

    from libviso_torch.ops import cuda_matching as cm
    from libviso_torch.ops import fused_matching as fm

    err = {k: 0.0 for k in KERNELS}
    rows = {}
    for seed, (shape, (real, real_args, thresh, radius)) in enumerate(
            problems.items()):
        for label, args in (("integer", _integer_problem(shape,
                                                         seed0 + seed)),
                            (real, real_args)):
            check(tuple(args[2].shape) == shape,
                  f"loop problem {tuple(args[2].shape)} != {shape}")
            sides = (args[0], args[1], args[3], args[4])
            outs = {
                "l1_distance_matrix": (cm.l1_distance_matrix(args[2],
                                                             args[5]),
                                       cm.l1_distance_matrix_plain(
                                           args[2], args[5])),
                "fused_gated_two_min": (
                    fm.fused_gated_two_min(*args, thresh, radius),
                    fm.fused_gated_two_min_plain(*args, thresh, radius)),
                "sweep_order": (fm.sweep_order(*sides),
                                fm.sweep_order_plain(*sides)),
                "fused_sweep_two_min": (
                    fm.sorted_fused_two_min(*args, thresh, radius),
                    fm.sorted_fused_two_min(
                        *args, thresh, radius,
                        sweep=fm.fused_sweep_two_min_plain))}
            how = {}
            for name, (got, want) in outs.items():
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                bitwise = all(torch.equal(x, y) for x, y in zip(got, want))
                e = max(_finite_max_abs_diff(x, y) for x, y in zip(got,
                                                                  want))
                if label == "integer" or name == "sweep_order":
                    check(bitwise, f"{name} {shape} {label}: != plain "
                          f"bitwise")
                elif not bitwise:
                    # float sums in another order: values within rtol
                    # 1e-5, idx wherever the two smallest are not within
                    # that of a tie
                    for x, y in zip(got[:2], want[:2]):
                        check(torch.allclose(x, y, rtol=1e-5, atol=0.0),
                              f"{name} {shape} {label}: beyond rtol 1e-5")
                    if len(want) == 3:
                        clear = want[1] - want[0] > 1e-5 * want[1]
                        check(torch.equal(got[2][clear], want[2][clear]),
                              f"{name} {shape} {label}: idx differs away "
                              f"from a tie")
                err[name] = max(err[name], e)
                how[name] = "bitwise" if bitwise else f"rtol 1e-5 ({e:.3g})"
            print(f"[{tag}] {shape} {label}: == plain: " + ", ".join(
                f"{k} {v}" for k, v in how.items()))
        # times on the real problem, in turns
        args = real_args
        sides = (args[0], args[1], args[3], args[4])
        order = fm.sweep_order(*sides)
        q_d, t_d = args[2], args[5]
        fns = {
            "l1 plain": lambda: cm.l1_distance_matrix_plain(q_d, t_d),
            "l1": lambda: cm.l1_distance_matrix(q_d, t_d),
            "cdist": lambda: torch.cdist(q_d, t_d, p=1),
            "gated plain": lambda: fm.fused_gated_two_min_plain(
                *args, thresh, radius),
            "gated": lambda: fm.fused_gated_two_min(*args, thresh, radius),
            "order plain": lambda: fm.sweep_order_plain(*sides),
            "order": lambda: fm.sweep_order(*sides),
            "sweep": lambda: fm.swept_two_min(*args, order, thresh, radius),
            "sweep route": lambda: fm.sorted_fused_two_min(*args, thresh,
                                                           radius),
            "sweep route plain": lambda: fm.sorted_fused_two_min(
                *args, thresh, radius, sweep=fm.fused_sweep_two_min_plain),
        }
        for fn in fns.values():
            fn()
        torch.cuda.synchronize()
        ms = {k: [] for k in fns}
        for k in list(fns) + list(fns)[::-1]:
            ms[k].append(_time_ms(fns[k], reps=10))
        t = {k: sum(v) / len(v) for k, v in ms.items()}
        B, N, D = shape
        pairs = int(fm.gate(*sides[:2], *sides[2:], args[6], args[7],
                            thresh, radius).sum())
        # the problems with a valid target (in the loop store the slots
        # that hold a keyframe; #2 computes all B, the sweep skips the
        # empty ones)
        filled = int(args[4].any(-1).sum())
        n_boxes = sum(-(-N // k) for k in fm.SWEEP_TILING)
        row = {
            "l1_distance_matrix": {
                "ms": t["l1"], "plain_ms": t["l1 plain"],
                "library_ms": t["cdist"],
                "bound": bound_ms(2 * B * N * N * D,
                                  4 * B * (2 * N * D + N * N))},
            "fused_gated_two_min": {
                "ms": t["gated"], "plain_ms": t["gated plain"],
                "library_ms": None, "pairs": pairs,
                "bound": two_min_bound(B, N, N, D, pairs)},
            "sweep_order": {
                "ms": t["order"], "plain_ms": t["order plain"],
                "library_ms": None,
                "bound": bound_ms(2 * B * N * math.log2(N),
                                  B * (2 * N * 9 + 2 * N * 4 + 16 * n_boxes))},
            "fused_sweep_two_min": {
                "ms": t["sweep route"], "order_ms": t["order"],
                "sweep_ms": t["sweep"], "fused_ms": t["gated"],
                "plain_ms": t["sweep route plain"], "library_ms": None,
                "pairs": pairs, "filled_problems": filled,
                "bound": two_min_bound(B, N, N, D, pairs)},
        }
        for r in row.values():
            r["bound_ms"], r["bound_by"] = r.pop("bound")
            r["share_of_bound"] = r["bound_ms"] / r["ms"]
        rows[shape] = row
        print(f"[{tag}] {shape} {real}, ms per call (two "
              f"turns each): " + ", ".join(
                  f"{k} {t[k]:.4f} ({v[0]:.4f}, {v[1]:.4f})"
                  for k, v in ms.items())
              + f"; {filled} of {B} problems have a valid target, {pairs} "
              + f"pairs pass the gates (radius {radius:g}); "
              + "bounds " + ", ".join(
                  f"{k} {r['bound_ms']:.4f} ms ({r['bound_by']}, share "
                  f"{r['share_of_bound']:.3f})" for k, r in row.items()))
    return rows, err


def _plaza_config(metric):
    """tests/test_mono.py's mono_config() with subpixel corners, in the
    port's classes (that file imports JAX)."""
    from libviso_torch.config import (
        DetectorConfig,
        MatchConfig,
        PipelineConfig,
    )

    return PipelineConfig(
        detector=DetectorConfig(max_features=480, nbinx=8, nbiny=4,
                                num_slots=512, descriptor_radius=5,
                                subpixel=True),
        temporal_match=MatchConfig(radius=60.0, use_ratio=True, ratio=0.9),
    ).with_metric(metric)


def mono_loop_phase():
    """Phase 13: run_mono_sim3_loop on the two-lap plaza circuit, l2 dense
    and l1 fused, on the JAX package's draws.  Returns the fused kernel's
    launches in the l1 run and that run's first candidate search (the
    store of (Kf, 256, 128))."""
    import torch

    from libviso_torch.config import MonoConfig
    from libviso_torch.pipeline import mono_loop as tml
    from libviso_torch.pipeline.mono import mono_hypotheses
    from libviso_torch.synthetic_world import generate_plaza_sequence
    from tools import threefry as tf
    from libviso_torch.utils.metrics import ate_rmse

    t0 = time.perf_counter()
    seq = generate_plaza_sequence(num_frames=81, seed=5, circuits=2)
    frames = [f[0] for f in seq.frames]
    T = len(frames)
    print(f"[mono-loop] 81-frame two-lap plaza of 416x160 rendered in "
          f"{time.perf_counter() - t0:.1f} s")
    K = seq.P1[:, :3]
    h1, h2 = mono_hypotheses(MonoConfig())
    captured = {}
    real_factory = tml._build_candidate_matcher

    def matcher_factory(*a, **kw):
        match_all = real_factory(*a, **kw)

        def recording(*args):
            captured.setdefault("problem", args)
            return match_all(*args)
        return recording

    launches = {}
    gt = seq.gt_poses
    tml._build_candidate_matcher = matcher_factory
    try:
        for metric, backend in (("l2", "dense"), ("l1", "fused")):
            cfg = _plaza_config(metric)
            n = cfg.detector.num_slots
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            res = tml.run_mono_sim3_loop(
                frames, K, cfg, backend=backend, device="cuda",
                keyframe_every=4, min_gap=20, seed=0,
                draws=lambda t: tuple(map(torch.from_numpy, tf.mono_gumbel(
                    0, t, (h1, n), (h2, n)))),
                verify_draws=lambda q: torch.from_numpy(
                    tf.sim3_verify_gumbel(0, q, (128, 256))))
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = read_launches()
            ref = JAX_MONO_LOOP[metric]
            solved = int(res.frame_ok.sum())
            ate_vo = ate_rmse(res.poses_vo, gt, align="sim3")
            ate_c = ate_rmse(res.poses, gt, align="sim3")
            bound = max(1.5 * ref["ate_m"], ref["ate_m"] + 0.02)
            loops = [(le.frame_old, le.frame_new, le.num_inliers)
                     for le in res.loops]
            check(solved == T - 1, f"mono loop {metric}: solved "
                  f"{solved}/{T - 1}")
            check(ate_c <= bound, f"mono loop {metric}: Sim(3) ATE {ate_c} "
                  f"m above {bound} m (JAX {ref['ate_m']} m)")
            check(ate_c <= 1.01 * ate_vo, f"mono loop {metric}: corrected "
                  f"ATE {ate_c} m above 1.01x the open chain's {ate_vo} m")
            if metric == "l2":
                check(len(loops) >= 2 and all(
                    36 <= b - a <= 44 and n_in >= 20 for a, b, n_in in loops),
                    f"mono loop l2: loops {loops} (JAX {ref['loops']})")
                check(float(np.max(res.node_scales)) > 1.3
                      and float(np.max(res.edge_scale)) > 0.5,
                      f"mono loop l2: node scale max "
                      f"{np.max(res.node_scales)}, edge weights "
                      f"{res.edge_scale.tolist()}")
            else:
                name = "fused_gated_two_min"
                # a query keyframe is searched once some earlier one is
                # min_gap frames back
                searches = int((res.kf_frames[1:] - res.kf_frames[0]
                                >= 20).sum())
                launches[name] = counts[name]
                check(counts[name] == 2 * T + searches,
                      f"mono loop l1 fused: {name} launched {counts[name]} "
                      f"times, not {2 * T} for the frames + {searches} "
                      f"candidate searches")
            print(f"[mono-loop] {metric} {backend}: solved {solved}/{T - 1}, "
                  f"{len(res.kf_frames)} keyframes; loops (old, new, "
                  f"inliers) {loops}, scales "
                  f"{[round(le.s_rel, 4) for le in res.loops]} (JAX "
                  f"{ref['loops']}, {ref['scales']}); edge weights "
                  f"{res.edge_scale.tolist()} (JAX {ref['edge_scale']}); node "
                  f"scale max {float(np.max(res.node_scales)):.4f} (JAX "
                  f"{ref['node_scale_max']:.4f}); Sim(3) ATE {ate_vo:.4f} m "
                  f"open chain, {ate_c:.4f} m corrected (JAX "
                  f"{ref['ate_vo_m']:.4f} / {ref['ate_m']:.4f}, bound "
                  f"{bound:.4f}); {T / dt:.2f} frames/s"
                  + (f"; fused_gated_two_min {counts['fused_gated_two_min']}"
                     f" launches" if backend == "fused" else ""))
            if metric == "l2":
                captured.clear()
    finally:
        tml._build_candidate_matcher = real_factory
    q_xy, q_desc, q_valid, kf_xy, kf_desc, kf_valid = captured["problem"]
    return launches, (q_xy, q_desc, q_valid, kf_xy, kf_desc, kf_valid)


def _write_mini_kitti(home):
    """A mini KITTI tree under ``home`` (emptied first): sequence 77, 6
    stereo pairs of 416x160 as PNGs and its calib.txt.  Returns the
    synthetic sequence."""
    import shutil

    from PIL import Image

    from libviso_torch.synthetic import generate_sequence

    shutil.rmtree(home, ignore_errors=True)
    seq = generate_sequence(num_frames=6, num_points=500, seed=7, width=416,
                            height=160)
    base = os.path.join(home, "sequences", "77")
    for cam in ("image_0", "image_1"):
        os.makedirs(os.path.join(base, cam))
    with open(os.path.join(base, "calib.txt"), "w") as fh:
        for row, P in (("P0", seq.P1), ("P1", seq.P2)):
            fh.write(f"{row}: " + " ".join(f"{v:.9e}" for v in P.reshape(-1))
                     + "\n")
    for i, pair in enumerate(seq.frames):
        for cam, im in zip(("image_0", "image_1"), pair):
            Image.fromarray(im.astype(np.uint8)).save(
                os.path.join(base, cam, f"{i:06d}.png"))
    return seq


def loop_cli_phase():
    """Phase 14: cli kitti --loop-closure on a mini KITTI tree, cli synth
    --world-loop and cli mono --sim3-loop, default --device cuda."""
    try:
        from PIL import Image
    except ImportError:
        print("[loop-cli] PIL does not import here: the CLI runs skipped")
        return
    import shutil

    home = os.path.join(ROOT, "build", "chip_smoke_loop")
    seq = _write_mini_kitti(home)
    os.makedirs(os.path.join(home, "mono"))
    for i, pair in enumerate(seq.frames):
        Image.fromarray(np.asarray(pair[0]).astype(np.uint8)).save(
            os.path.join(home, "mono", f"{i:06d}.png"))
    np.savetxt(os.path.join(home, "mono", "K.txt"), seq.P1[:, :3])
    cli = [sys.executable, "-m", "libviso_torch.cli"]
    runs = [
        (["kitti", "smoke", "77", "--kitti-home", home, "--metric", "l1",
          "--backend", "sweep", "--loop-closure", "--keyframe-every", "2",
          "--loop-min-gap", "4", "--loop-min-matches", "20",
          "--loop-min-inliers", "12", "--checkpoint-every", "3"],
         {"sequence", "frames", "solved", "fps", "poses", "loops",
          "graph_cost", "health", "device"}),
        (["synth", "--world-loop", "--frames", "6", "--metric", "l1",
          "--backend", "fused"],
         {"frames", "device", "solved", "ate_rmse_m", "rpe_trans_mean_m",
          "rpe_rot_mean_rad", "fps"}),
        (["mono", "--image-mask", os.path.join(home, "mono", "%06d.png"),
          "--calib", os.path.join(home, "mono", "K.txt"), "--sim3-loop",
          "--kf-every", "2", "--loop-min-gap", "2", "--metric", "l1",
          "--backend", "fused"],
         {"frames", "solved", "fps", "poses", "note", "loops", "keyframes",
          "graph_cost", "device"})]
    for argv, keys in runs:
        proc = subprocess.run(cli + argv, cwd=ROOT, capture_output=True,
                              text=True, timeout=600)
        check(proc.returncode == 0,
              f"cli {' '.join(argv)} exited {proc.returncode}:\n{proc.stderr}")
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        check(set(out) == keys and out["device"] == "cuda",
              f"cli {argv[0]}: keys {sorted(out)}")
        if argv[0] == "kitti":
            check(out["solved"] == 5 and out["graph_cost"][1]
                  <= out["graph_cost"][0], f"cli kitti --loop-closure: {out}")
            check(os.listdir(os.path.join(home, "results", "77", "smoke",
                                          "checkpoints", "loop")),
                  "cli kitti --loop-closure wrote no loop checkpoint")
        elif argv[0] == "mono":
            check(out["solved"] == 5 and out["keyframes"] == 2,
                  f"cli mono --sim3-loop: {out}")
        else:
            check(out["frames"] == 6, f"cli synth --world-loop: {out}")
        flags = [a for a in argv[1:] if a.startswith("--")]
        print(f"[loop-cli] cli {argv[0]} {' '.join(flags)}: "
              f"{json.dumps(out)}")
    shutil.rmtree(home)


@contextlib.contextmanager
def _capturing(module, label):
    """Within the block, module.match_problem_batch records the first
    call's arguments of each shape as kernel_shapes_phase takes them,
    {shape: (label(arguments), kernel arguments, Sampson threshold,
    radius)}, and each shape's launches by kernel, {shape: {kernel: n}}.
    Yields the two dicts."""
    import inspect

    real = module.match_problem_batch
    sig = inspect.signature(real)
    problems, per_shape = {}, {}

    def capture(*args, **kw):
        a = sig.bind(*args, **kw).arguments
        shape = tuple(a["q_d"].shape)
        if shape not in problems:
            B = shape[0]
            problems[shape] = (
                label(a),
                [a[k] for k in ("q_xy", "q_valid", "q_d", "t_xy", "t_valid",
                                "t_d")]
                + [a["F"].expand(B, 3, 3).contiguous(),
                   a["use_epi"].expand(B).contiguous()],
                a["sampson_thresh"], a["radius"])
        before = read_launches()
        out = real(*args, **kw)
        row = per_shape.setdefault(shape, dict.fromkeys(KERNELS, 0))
        for k, n in read_launches().items():
            row[k] += n - before[k]
        return out

    module.match_problem_batch = capture
    try:
        yield problems, per_shape
    finally:
        module.match_problem_batch = real


def _window_draws(cfg):
    """The JAX package's window draws (tools/threefry.py): the port's
    ``draws(w, n)`` seam."""
    import torch

    from tools import threefry as tf

    shape = (cfg.ransac.num_hypotheses, cfg.detector.num_slots)
    return lambda w, n: torch.from_numpy(tf.window_gumbel(0, w, n + 1,
                                                          shape))


def ba_phase(seq):
    """Phase 15: run_windowed_ba on the phase-4 sequence, l1, windows of 8
    frames every 4, on the JAX package's window draws: under the gate with
    each backend, and without it (dense).  Returns the kernels' launches
    under their backends, in all and per shape ({shape: {kernel:
    launches}}), and the first window's two match problems as {shape:
    (label, kernel arguments, Sampson threshold, radius)}."""
    import torch

    from libviso_torch.config import BAConfig, PipelineConfig
    from libviso_torch.pipeline import batched, windowed
    from libviso_torch.utils.metrics import ate_rmse

    cfg = PipelineConfig().with_metric("l1")
    draws = _window_draws(cfg)
    gt = seq.gt_poses
    T = len(seq.frames)
    problems = {}

    def problem_label(a):
        kind = "stereo" if bool(a["use_epi"].any()) else "temporal"
        return f"{kind} problems of window 0"

    def timed(fn, ms):
        # fn with a sync before and after, its wall ms appended to ms
        def call(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            return out
        return call

    launches, shape_launches, runs = {}, {s: {} for s in BA_SHAPES}, {}
    real_build = windowed.build_batched_odometry
    real_refine = windowed.refine_window_motions
    try:
        for backend, gate in (("dense", True), ("fused", True),
                              ("sweep", True), ("dense", False)):
            front_ms, refine_ms, saved = [], [], []
            # the per-window stages, timed: the front-end and the
            # refinement; without the gate each window's refinement is
            # saved, and its launches and syncs counted in a fresh process
            windowed.build_batched_odometry = lambda *a, **kw: timed(
                real_build(*a, **kw), front_ms)
            if gate:
                windowed.refine_window_motions = timed(real_refine,
                                                       refine_ms)
            else:
                def refine(*a, **kw):
                    saved.append(("refine_window_motions", a, kw))
                    return real_refine(*a, **kw)
                windowed.refine_window_motions = refine
            reset_launches()
            # the first window's problems, and each call's launches
            with _capturing(batched, problem_label) as (seen, per_shape):
                res = windowed.run_windowed_ba(
                    seq.frames, seq.P1, seq.P2, cfg,
                    ba=BAConfig(**BA_WINDOW, gate=gate), backend=backend,
                    device="cuda", draws=draws)
            problems = problems or seen
            counts = read_launches()
            if not gate:
                counted = [(r["kernel_launches"], r["stream_syncs"]) for r
                           in traced_in_fresh_process("ba_refine", saved)]
            n_win = len(res.window_costs)
            ref = JAX_BA[gate]
            solved = int(res.frame_ok.sum())
            accepted = [c[2] for c in res.window_costs]
            ate = ate_rmse(res.poses, gt)
            ate_vo = ate_rmse(res.poses_vo, gt)
            what = f"ba {backend}, gate {'on' if gate else 'off'}"
            check(solved == ref["solved"], f"{what}: solved {solved}/{T - 1}")
            check(accepted == ref["accepted"],
                  f"{what}: accepted {accepted}, JAX {ref['accepted']}")
            check(all(c[1] <= c[0] for c in res.window_costs),
                  f"{what}: a window's cost rose {res.window_costs}")
            got = [(c[0], c[1], c[3], c[4]) for c in res.window_costs]
            check(len(got) == len(ref["windows"]) and np.allclose(
                      got, ref["windows"], rtol=BA_RTOL, atol=0.0),
                  f"{what}: window (initial, final cost, holdout ratios) "
                  f"{got}, JAX {ref['windows']} (rtol {BA_RTOL})")
            gap = float(np.max(np.abs(np.subtract(got, ref["windows"]))
                               / np.abs(ref["windows"])))
            check(ate <= BA_ATE_BOUND[gate], f"{what}: ATE {ate} m above "
                  f"{BA_ATE_BOUND[gate]} m (JAX {ref['ate_m']} m)")
            if gate:
                check(np.array_equal(res.poses, res.poses_vo),
                      f"{what}: no window accepted, but the trajectory is "
                      f"not VO's")
            else:
                check(ate < ate_vo, f"{what}: ATE {ate} m not below VO's "
                      f"{ate_vo} m")
            check(set(per_shape) == set(BA_SHAPES),
                  f"{what}: match problems of the shapes "
                  f"{sorted(per_shape)}, not {BA_SHAPES}")
            for name in BACKEND_KERNELS[backend]:
                by_shape = [per_shape[sh][name] for sh in BA_SHAPES]
                check(counts[name] == 2 * n_win
                      and by_shape == [n_win] * len(BA_SHAPES),
                      f"{what}: {name} launched {counts[name]} times for "
                      f"{n_win} windows, {by_shape} at {BA_SHAPES}")
                if gate:
                    launches[name] = counts[name]
                    for sh in BA_SHAPES:
                        shape_launches[sh][name] = per_shape[sh][name]
            runs[(backend, gate)] = res
            print(f"[ba] {what}: solved {solved}/{T - 1}, {n_win} windows, "
                  f"accepted {accepted} (JAX {ref['accepted']}); costs "
                  + ", ".join(f"{c[0]:.6f} -> {c[1]:.6f}"
                              for c in res.window_costs)
                  + "; holdout ratios " + ", ".join(
                      f"{c[3]:.6f}/{c[4]:.6f}" for c in res.window_costs)
                  + f" (JAX's within rtol {BA_RTOL:g}, largest gap "
                  f"{gap:.3g})"
                  + f"; ATE {ate:.5f} m (VO {ate_vo:.5f}; JAX "
                  f"{ref['ate_m']:.5f}, bound {BA_ATE_BOUND[gate]:.5f}); "
                  f"{' and '.join(BACKEND_KERNELS[backend])} "
                  f"{counts[BACKEND_KERNELS[backend][0]]} launches each, "
                  + ", ".join(f"{per_shape[sh][BACKEND_KERNELS[backend][0]]}"
                              f" at {sh}" for sh in BA_SHAPES))
            print(f"[ba] {what}: ms per window, front-end "
                  f"{[round(x, 3) for x in front_ms]}"
                  + (f", refinement {[round(x, 3) for x in refine_ms]}"
                     if gate else
                     f"; the refinement's device kernels and stream syncs "
                     f"per window (torch.profiler, in a fresh process): "
                     f"{counted}"))
    finally:
        windowed.build_batched_odometry = real_build
        windowed.refine_window_motions = real_refine
    for backend in ("fused", "sweep"):
        a, b = runs[(backend, True)], runs[("dense", True)]
        check(np.array_equal(a.motions, b.motions)
              and np.array_equal(a.frame_ok, b.frame_ok)
              and a.window_costs == b.window_costs,
              f"ba: {backend} differs from dense")
    print("[ba] dense == fused == sweep under the gate: motions, ok flags "
          "and window costs bit for bit")
    check(set(problems) == set(BA_SHAPES),
          f"ba: captured the shapes {sorted(problems)}, not {BA_SHAPES}")
    return launches, shape_launches, problems


def ba_loop_phase(seq):
    """Phase 17: run_windowed_ba_loop on phase 11's 96-frame circle, l1,
    sweep, on the JAX package's window and loop draws.  Returns the
    route's launches."""
    import torch

    from libviso_torch.config import BAConfig, PipelineConfig
    from libviso_torch.pipeline.ba_loop import run_windowed_ba_loop
    from libviso_torch.utils.metrics import ate_rmse

    cfg = PipelineConfig().with_metric("l1")
    frames = list(seq.frames)
    T = len(frames)
    gt = seq.gt_poses
    ref = JAX_BA_LOOP
    backend = "sweep"
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    res = run_windowed_ba_loop(
        frames, seq.P1, seq.P2, cfg, ba=BAConfig(**BA_WINDOW),
        backend=backend, device="cuda", draws=_window_draws(cfg),
        verify_draws=_jax_stereo_draws(cfg)["verify_draws"], **LOOP_KW)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_launches()
    n_win = len(res.window_costs)
    searches = res.keyframes_offered - 1
    guided = sum(3 for c in res.candidates if "refine_trace" in c)
    launches = {}
    for name in BACKEND_KERNELS[backend]:
        launches[name] = counts[name]
        check(counts[name] == 2 * n_win + searches + guided,
              f"ba loop: {name} launched {counts[name]} times, not "
              f"{2 * n_win} for the windows + {searches} candidate "
              f"searches + {guided} guided matches")
    solved = int(res.frame_ok.sum())
    accepted = [c[2] for c in res.window_costs]
    found = [(le.frame_new, le.frame_old, le.num_inliers) for le in res.loops]
    ate_ba = ate_rmse(res.poses_ba, gt)
    ate_opt = ate_rmse(res.poses, gt)
    end = [float(np.linalg.norm(P[-1, :3, 3] - gt[-1, :3, 3]))
           for P in (res.poses_ba, res.poses)]
    check(solved == ref["solved"], f"ba loop: solved {solved}/{T - 1}")
    check(accepted == ref["accepted"], f"ba loop: accepted {accepted}")
    check([f[:2] for f in found] == [r[:2] for r in ref["loops"]],
          f"ba loop: loops {found}, JAX {ref['loops']}")
    for (_, _, n), (_, _, want) in zip(found, ref["loops"]):
        check(abs(n - want) <= 0.1 * want,
              f"ba loop: inliers {found}, JAX {ref['loops']}")
    check(res.graph_cost[1] < res.graph_cost[0],
          f"ba loop: graph cost {res.graph_cost}")
    check(ref["graph_cost"][1] / 2 <= res.graph_cost[1]
          <= 2 * ref["graph_cost"][1],
          f"ba loop: optimized graph cost {res.graph_cost[1]}, JAX "
          f"{ref['graph_cost'][1]}")
    check(end[1] <= end[0], f"ba loop: endpoint {end[1]} m optimized, "
          f"{end[0]} m BA chain")
    check(ate_opt <= BA_LOOP_ATE_BOUND, f"ba loop: optimized ATE {ate_opt} "
          f"m above {BA_LOOP_ATE_BOUND} m (JAX {ref['ate_opt_m']} m)")
    print(f"[ba-loop] {backend}: solved {solved}/{T - 1}, {n_win} windows, "
          f"{sum(accepted)} accepted (JAX 0); loops {found} (JAX "
          f"{ref['loops']}); {len(res.candidates)} candidates verified (JAX "
          f"{ref['candidates']}); graph cost {res.graph_cost[0]:.6f} -> "
          f"{res.graph_cost[1]:.6g} (JAX {ref['graph_cost']}); ATE "
          f"{ate_ba:.4f} m BA chain, {ate_opt:.4f} m optimized (JAX "
          f"{ref['ate_ba_m']:.4f} / {ref['ate_opt_m']:.4f}, bound "
          f"{BA_LOOP_ATE_BOUND:.4f}); endpoint {end[0]:.4f} -> {end[1]:.4f} "
          f"m (JAX {ref['end_ba_m']:.4f} -> {ref['end_opt_m']:.4f}); "
          f"{' and '.join(BACKEND_KERNELS[backend])} "
          f"{counts[BACKEND_KERNELS[backend][0]]} launches each ({n_win} "
          f"windows, {searches} candidate searches, {guided} guided "
          f"matches); {T / dt:.2f} frames/s")
    return launches


def ba_cli_phase():
    """Phase 18: cli kitti --ba-window 4, alone and with --loop-closure,
    on a mini KITTI tree with --checkpoint-every 1 and the default
    --device cuda, each resumed from its next-to-last snapshot with the
    same poses; --keep-on-failure with --ba-window exits non-zero."""
    try:
        import PIL  # noqa: F401
    except ImportError:
        print("[ba-cli] PIL does not import here: the CLI runs skipped")
        return
    import contextlib
    import io
    import shutil

    from libviso_torch import cli

    home = os.path.join(ROOT, "build", "chip_smoke_ba")
    _write_mini_kitti(home)
    base = ["77", "--kitti-home", home, "--metric", "l1", "--backend",
            "sweep", "--ba-window", "4", "--checkpoint-every", "1"]
    loop = ["--loop-closure", "--keyframe-every", "2", "--loop-min-gap", "4",
            "--loop-min-matches", "20", "--loop-min-inliers", "12"]
    keys = {"sequence", "frames", "device", "solved", "fps", "poses",
            "ba_windows", "ba_improved", "health"}

    def run(argv):
        # in this process (the kernels are built): the CLI's main, as
        # `python -m libviso_torch.cli kitti ...` calls it
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli.main(["kitti", *argv])
        return json.loads(out.getvalue().strip().splitlines()[-1])

    for sha, extra, mode in (("ba", [], "ba"), ("baloop", loop, "ba_loop")):
        out = run([sha, *base, *extra])
        want = keys | ({"loops", "graph_cost"} if extra else set())
        check(set(out) == want and out["device"] == "cuda",
              f"cli kitti {mode}: keys {sorted(out)}")
        check(out["solved"] == 5 and out["ba_windows"] == 2,
              f"cli kitti {mode}: {out}")
        with open(out["poses"]) as fh:
            poses = fh.read()
        ckdir = os.path.join(home, "results", "77", sha, "checkpoints", mode)
        snaps = sorted(os.listdir(ckdir))
        check(snaps, f"cli kitti {mode}: no checkpoint in {ckdir}")
        os.remove(os.path.join(ckdir, snaps[-1]))
        again = run([sha, *base, *extra])
        with open(again["poses"]) as fh:
            check(fh.read() == poses, f"cli kitti {mode}: the resumed run's "
                  f"poses differ")
        check(again.get("loops") == out.get("loops"),
              f"cli kitti {mode}: resumed loops {again.get('loops')}")
        print(f"[ba-cli] cli kitti --ba-window 4"
              f"{' --loop-closure' if extra else ''}: {json.dumps(out)}; "
              f"resumed from {snaps[-2] if len(snaps) > 1 else 'nothing'}: "
              f"the same poses")
    try:
        cli.main(["kitti", "bad", *base, "--keep-on-failure"])
        refused = None
    except SystemExit as e:
        refused = e.code
    check(isinstance(refused, str) and "--keep-on-failure" in refused,
          f"--keep-on-failure --ba-window exited with {refused!r}")
    print(f"[ba-cli] --keep-on-failure --ba-window 4 exits non-zero: "
          f"{refused}")
    shutil.rmtree(home)


def _variant_cfg(metric, banded):
    import dataclasses

    from libviso_torch.config import PipelineConfig

    cfg = PipelineConfig().with_metric(metric)
    return dataclasses.replace(cfg, stereo_match=dataclasses.replace(
        cfg.stereo_match, banded=banded))


def _timed_run(fn):
    """(result, frames/s over frames 2..T-1) of a run_stereo_sequence-like
    call given its on_frame callback."""
    import torch

    ends = []

    def on_frame(t, out):
        torch.cuda.synchronize()
        ends.append(time.perf_counter())

    res = fn(on_frame)
    return res, (len(ends) - 2) / (ends[-1] - ends[1])


def variants_phase(seq):
    """Phase 19: the matcher variants at KITTI width.  Returns the times
    of the variant routes."""
    import torch

    from libviso_torch.config import PipelineConfig
    from libviso_torch.ops import matching as mt
    from libviso_torch.pipeline.stereo import match_layout, run_stereo_sequence
    from libviso_torch.utils.metrics import ate_rmse

    for (metric, banded), (jax_solved, jax_ate) in JAX_VARIANTS.items():
        cfg = _variant_cfg(metric, banded)
        res, fps = _timed_run(lambda cb: run_stereo_sequence(
            seq.frames, seq.P1, seq.P2, cfg, seed=0, device="cuda",
            on_frame=cb))
        solved = int(res.frame_ok.sum())
        ate = ate_rmse(res.poses, seq.gt_poses)
        bound = max(1.5 * jax_ate, jax_ate + 0.02)
        label = f"{metric}{' banded' if banded else ''}"
        print(f"[variants] {label}: solved {solved}/20, ATE {ate} m "
              f"(JAX {jax_ate} m, bound {bound} m), {fps:.2f} frames/s")
        check(solved == jax_solved, f"{label}: solved {solved}, JAX "
              f"{jax_solved}")
        check(ate <= bound, f"{label}: ATE {ate} m above {bound} m")

    # frame 1's three problems against frame 0 (float descriptors)
    p = _match_problems([seq], 1, integer=False)
    layout = match_layout(_variant_cfg("l2", True), 1241)
    check(layout == KITTI_LAYOUT, f"layout {layout}")
    band = mt.band_of(layout, "l2", 80.0, 1241, 1280)
    check(band == 2, f"band {band} at KITTI width, not 2")
    sm, tm = PipelineConfig().stereo_match, PipelineConfig().temporal_match
    flags = dict(
        use_epi=p["use_epi"],
        use_rat=torch.tensor([sm.use_ratio, tm.use_ratio, tm.use_ratio],
                             device="cuda"),
        ratios=torch.tensor([sm.ratio, tm.ratio, tm.ratio], device="cuda"),
        radius=sm.radius, sampson_thresh=sm.sampson_thresh, F=p["F"],
        image_width=1241)
    args = [p[k] for k in ("q_xy", "q_valid", "q_d", "t_xy", "t_valid",
                           "t_d")]

    def match(metric, lay):
        return mt.match_problem_batch(*args, metric=metric, layout=lay,
                                      **flags)

    times = {}
    for metric in ("l2", "l2q8"):
        b, d = match(metric, layout), match(metric, None)
        check(torch.equal(b.valid, d.valid),
              f"banded {metric}: validity differs from dense")
        diff = b.idx != d.idx
        dd = mt.descriptor_distances(p["q_d"], p["t_d"], metric)
        pick = lambda r: dd.gather(  # noqa: E731
            -1, r.idx.clamp(min=0)[..., None])[..., 0][diff]
        pb, pd = pick(b), pick(d)
        exact = int((pb == pd).sum())
        if metric == "l2q8":
            check(exact == len(pb), f"banded l2q8: {len(pb) - exact} rows "
                  f"differ from dense without an exact tie")
        else:
            check(bool(((pb - pd).abs() <= 1e-6 * pd).all()),
                  "banded l2: a differing row is no tie within rtol 1e-6")
        print(f"[variants] banded {metric} == dense on the frame's 3 "
              f"problems: {int(d.valid.sum())} matches, "
              f"{int(diff.sum())} rows differ, each a distance tie "
              f"({exact} bit-exact)")
        times[metric] = {
            "distances_ms": _time_ms(lambda m=metric: mt.descriptor_distances(
                p["q_d"], p["t_d"], m)),
            "dense_ms": _time_ms(lambda m=metric: match(m, None)),
            "banded_ms": _time_ms(lambda m=metric: match(m, layout))}
    qa, qb = mt.quantize_q8(p["q_d"]), mt.quantize_q8(p["t_d"])
    cross = mt.q8_cross(qa, qb)
    exact = torch.matmul(qa.cpu().long(), qb.cpu().long().transpose(-1, -2))
    check(torch.equal(cross.cpu().long(), exact)
          and bool((cross == cross.round()).all()),
          "the l2q8 cross term differs from the int64 product")
    print(f"[variants] l2q8 cross term == the int64 product on (3, 1280, "
          f"128) x (3, 1280, 128) (max |cross| {int(exact.abs().max())})")
    for metric, t in times.items():
        print(f"[variants] {metric} at (3, 1280, 128): distances "
              f"{t['distances_ms']:.4f} ms, dense match "
              f"{t['dense_ms']:.4f} ms, banded match {t['banded_ms']:.4f} ms "
              f"per call")
    return times


def tp_phase(seq):
    """Phase 20: the tensor-parallel matcher on a real frame's stereo and
    temporal problems at (1280, 1280, 128), l1, model = 1, 2, 4 entries of
    cuda:0.  Returns (kernel #1's launches in phase 20's tensor-parallel
    calls, its row at the shard shape with its launches at model = 4)."""
    import torch

    from libviso_torch.config import PipelineConfig
    from libviso_torch.ops import cuda_matching as cm
    from libviso_torch.ops.features import Keypoints
    from libviso_torch.ops.matching import match_descriptors
    from libviso_torch.parallel import make_mesh, tp_match_descriptors

    p = _match_problems([seq], 1, integer=True)
    cfg = PipelineConfig().with_metric("l1")

    def kp(side, i):
        v = p[f"{side}_valid"][i]
        return Keypoints(xy=p[f"{side}_xy"][i],
                         response=torch.zeros(v.shape, device="cuda"),
                         valid=v)

    problems = {
        "stereo": (kp("q", 0), p["q_d"][0], kp("t", 0), p["t_d"][0],
                   cfg.stereo_match, p["F"][0]),
        "temporal": (kp("q", 1), p["q_d"][1], kp("t", 1), p["t_d"][1],
                     cfg.temporal_match, None)}
    local = {k: match_descriptors(*v[:5], F=v[5])
             for k, v in problems.items()}
    reset_launches()
    shard_launches = 0   # kernel #1's launches at the shard shape
    for k in (1, 2, 4):
        mesh = make_mesh(n_data=1, n_model=k, devices=["cuda:0"] * k)
        for label, (kp1, d1, kp2, d2, mc, F) in problems.items():
            before = read_launches()["l1_distance_matrix"]
            got = tp_match_descriptors(mesh, kp1, d1, kp2, d2, mc, F=F)
            n = read_launches()["l1_distance_matrix"] - before
            check(n == k, f"tp {label} model={k}: {n} launches, not {k}")
            if k == 4:
                shard_launches += n
            check(all(torch.equal(a, b) for a, b in zip(got, local[label])),
                  f"tp {label} model={k} differs from match_descriptors")
        print(f"[tp] model={k}: stereo (F) and temporal == "
              f"match_descriptors bit for bit, {k} launches of kernel #1 a "
              f"problem ({int(local['stereo'].valid.sum())} and "
              f"{int(local['temporal'].valid.sum())} matches)")
    tp_launches = read_launches()["l1_distance_matrix"]

    # kernel #1 at a model=4 shard: (1280 x 320, 128)
    _, N1, N2, D = SHARD_SHAPE
    a, b = p["q_d"][:1], p["t_d"][:1, :N2]
    check(torch.equal(cm.l1_distance_matrix(a, b),
                      cm.l1_distance_matrix_plain(a, b)),
          "kernel #1 != plain at the shard shape")
    fns = {"plain": lambda: cm.l1_distance_matrix_plain(a, b),
           "kernel": lambda: cm.l1_distance_matrix(a, b),
           "library": lambda: torch.cdist(a, b, p=1)}
    ms = {k: [] for k in fns}
    for k in list(fns) + list(fns)[::-1]:
        ms[k].append(_time_ms(fns[k]))
    t = {k: sum(v) / 2 for k, v in ms.items()}
    bound, by = bound_ms(2 * N1 * N2 * D, 4 * (N1 * D + N2 * D + N1 * N2))
    print(f"[tp] kernel #1 at the shard shape {SHARD_SHAPE[1:]}: "
          f"{t['kernel']:.4f} ms {ms['kernel']}, bound {bound:.4f} ms ({by}, "
          f"share {bound / t['kernel']:.3f}); plain {t['plain']:.4f} ms; "
          f"torch.cdist(p=1) {t['library']:.4f} ms")
    row = {"ms": t["kernel"], "plain_ms": t["plain"],
           "library_ms": t["library"], "bound_ms": bound, "bound_by": by,
           "share_of_bound": bound / t["kernel"],
           "path": "tensor-parallel shard (model = 4)",
           "launches": shard_launches}
    return tp_launches, row


def chunk_phase():
    """Phase 21: run_sharded_odometry on 21 KITTI-size frames over data =
    4 entries of cuda:0 under each backend.  Returns each kernel's
    launches in the entry point's run under its backend, in all and per
    shape ({shape: {kernel: launches}}), and chunk 0's two match problems
    as kernel_shapes_phase takes them."""
    import torch

    from libviso_torch.config import Calib, PipelineConfig
    from libviso_torch.geometry.mvg import F_from_P_host
    from libviso_torch.parallel import (
        build_chunk_odometry,
        chunk_frames_with_halo,
        host_chunk_assignment,
        make_mesh,
        run_sharded_odometry,
        run_sharded_odometry_multihost,
        stitch_chunk_motions,
    )
    from libviso_torch.pipeline import batched
    from libviso_torch.pipeline.stereo import run_stereo_sequence
    from libviso_torch.solvers.ransac import frame_generator, sample_gumbel
    from libviso_torch.synthetic import generate_sequence
    from libviso_torch.utils.metrics import ate_rmse

    seq = generate_sequence(**CHUNK_SEQUENCE)
    T = len(seq.frames)
    left = np.stack([f[0] for f in seq.frames])
    right = np.stack([f[1] for f in seq.frames])
    ims1, ims2, n_valid = chunk_frames_with_halo(left, right, 4)
    per = ims1.shape[1] - 1
    cfg0 = PipelineConfig()
    shape = (cfg0.ransac.num_hypotheses, cfg0.detector.num_slots)

    def g(t):   # the streaming run's draws
        return sample_gumbel(shape, frame_generator(0, t))

    def chunk_draws(c, n):
        return torch.stack([g(c * per + j) for j in range(1, n + 1)])

    mesh = make_mesh(n_data=4, devices=["cuda:0"] * 4)
    calib = Calib.from_projections(seq.P1, seq.P2)
    F = torch.as_tensor(F_from_P_host(seq.P1, seq.P2), dtype=torch.float32,
                        device="cuda")
    launches, problems = {}, {}
    shape_launches = {s: {} for s in CHUNK_SHAPES}

    def problem_label(a):
        kind = "stereo" if bool(a["use_epi"].any()) else "temporal"
        return f"{kind} problems of chunk 0"

    for backend, metric in (("dense", "l1"), ("fused", "l1"),
                            ("sweep", "l1"), ("dense", "l2")):
        cfg = cfg0.with_metric(metric)
        label = f"{backend} {metric}"
        stream = run_stereo_sequence(seq.frames, seq.P1, seq.P2, cfg,
                                     device="cuda", backend=backend,
                                     draws=g)
        fn = build_chunk_odometry(calib, F, cfg, backend=backend)
        trs, oks, worst = [], [], 0.0
        for c in range(4):
            tr, ok = fn(torch.as_tensor(ims1[c], device="cuda"),
                        torch.as_tensor(ims2[c], device="cuda"),
                        chunk_draws(c, per).cuda())
            trs.append(tr)
            oks.append(ok)
            n = int(n_valid[c])
            rows = slice(c * per + 1, c * per + 1 + n)
            check(np.array_equal(ok[1:1 + n].cpu().numpy(),
                                 stream.frame_ok[rows]),
                  f"chunk {c} ({label}): ok flags differ from streaming")
            worst = max(worst, float(np.abs(tr[1:1 + n].cpu().numpy()
                                            - stream.motions[rows]).max()))
        check(worst <= 5e-6, f"{label}: chunk motions differ from the "
              f"streaming run's by {worst}")
        want, keep = stitch_chunk_motions(torch.stack(trs), torch.stack(oks),
                                          torch.as_tensor(n_valid,
                                                          device="cuda"))
        want = want[keep].cpu().numpy()
        reset_launches()
        with _capturing(batched, problem_label) as (seen, per_shape):
            t0 = time.perf_counter()
            poses, _ = run_sharded_odometry(mesh, seq.P1, seq.P2, left,
                                            right, cfg, backend=backend,
                                            draws=chunk_draws)
            wall = time.perf_counter() - t0
        counts = read_launches()
        kernels = BACKEND_KERNELS[backend] if metric == "l1" else ()
        for k in KERNELS:
            check(counts[k] == (8 if k in kernels else 0),
                  f"{label}: {k} launched {counts[k]} times in 4 chunks")
        check(set(per_shape) == set(CHUNK_SHAPES),
              f"{label}: match problems of the shapes {sorted(per_shape)}, "
              f"not {CHUNK_SHAPES}")
        if metric == "l1":
            launches.update({k: counts[k] for k in kernels})
            for sh in CHUNK_SHAPES:
                for k in kernels:
                    check(per_shape[sh][k] == 4, f"{label}: {k} launched "
                          f"{per_shape[sh][k]} times at {sh} in 4 chunks")
                    shape_launches[sh][k] = per_shape[sh][k]
            problems = problems or seen
        check(np.array_equal(poses, want),
              f"{label}: run_sharded_odometry != its chunks stitched")
        print(f"[chunk] {label}: 4 chunks of {per + 1} frames, each chunk's "
              f"ok flags == streaming, motions within {worst} of it; "
              f"{[counts[k] for k in kernels]} launches of the route's "
              f"kernels (2 a chunk); {T} frames in {wall:.3f} s; ATE "
              f"{ate_rmse(poses, seq.gt_poses)} m (streaming "
              f"{ate_rmse(stream.poses, seq.gt_poses)} m)")
        if (backend, metric) == ("dense", "l1"):
            plan = host_chunk_assignment(T, 4, 0, 1)
            span = slice(plan["frame_start"], plan["frame_stop"])
            multi, _ = run_sharded_odometry_multihost(
                mesh, seq.P1, seq.P2, left[span], right[span], T, cfg,
                backend=backend, draws=chunk_draws)
            check(np.array_equal(multi, poses),
                  "run_sharded_odometry_multihost (1 process) != "
                  "run_sharded_odometry")
            print("[chunk] run_sharded_odometry_multihost in one process "
                  "== run_sharded_odometry bit for bit")
    return launches, shape_launches, problems


def staged_phase(seq, whole):
    """Phase 22: run_pipelined_odometry and StreamPipeline on [cuda:0,
    cuda:0] (two CUDA streams), l1, each backend, against the serial run.
    Returns each kernel's launches in the staged run under its backend."""
    import torch

    from libviso_torch.config import PipelineConfig
    from libviso_torch.parallel import make_pipe_mesh, run_pipelined_odometry
    from libviso_torch.parallel.pp_odometry import StreamPipeline
    from libviso_torch.pipeline.stereo import run_stereo_sequence

    cfg = PipelineConfig().with_metric("l1")
    mesh = make_pipe_mesh(["cuda:0", "cuda:0"])
    left = np.stack([f[0] for f in seq.frames])
    right = np.stack([f[1] for f in seq.frames])
    launches = {}

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    for backend in BACKEND_KERNELS:
        def serial():
            return run_stereo_sequence(seq.frames, seq.P1, seq.P2, cfg,
                                       device="cuda", backend=backend)

        def staged():
            return run_pipelined_odometry(mesh, seq.P1, seq.P2, left, right,
                                          cfg, backend=backend)

        def stream():
            sp = StreamPipeline(seq.P1, seq.P2, cfg,
                                devices=["cuda:0", "cuda:0"],
                                backend=backend)
            outs = [sp.push(a, b) for a, b in seq.frames][1:] + [sp.flush()]
            return (np.stack([o.tr.cpu().numpy() for o in outs]),
                    np.array([bool(o.ok) for o in outs]))

        want = whole if backend == "dense" else serial()
        reset_launches()
        (poses, motions, ok), _ = wall(staged)
        counts = read_launches()
        for k in BACKEND_KERNELS[backend]:
            check(counts[k] == len(seq.frames),
                  f"staged {backend}: {k} launched {counts[k]} times")
            launches[k] = counts[k]
        check(np.array_equal(motions, want.motions)
              and np.array_equal(ok, want.frame_ok)
              and np.array_equal(poses, want.poses),
              f"staged {backend} != serial")
        (s_motions, s_ok), _ = wall(stream)
        s_ok[0] = False
        check(np.array_equal(s_motions, want.motions)
              and np.array_equal(s_ok, want.frame_ok),
              f"StreamPipeline {backend} != serial")
        # frames/s in turns: serial, staged, stream, stream, staged, serial
        secs = {"serial": [], "staged": [], "stream": []}
        fns = {"serial": serial, "staged": staged, "stream": stream}
        for k in list(fns) + list(fns)[::-1]:
            secs[k].append(wall(fns[k])[1])
        fps = {k: len(seq.frames) * 2 / sum(v) for k, v in secs.items()}
        print(f"[staged] {backend}: run_pipelined_odometry and "
              f"StreamPipeline on [cuda:0, cuda:0] == run_stereo_sequence "
              f"bit for bit; {launches[BACKEND_KERNELS[backend][0]]} "
              f"launches in 20 frames; frames/s over the whole run "
              f"(2 rounds in turns): serial {fps['serial']:.2f}, staged "
              f"{fps['staged']:.2f}, StreamPipeline {fps['stream']:.2f}")
    return launches


def sharded_ba_phase(seq):
    """Phase 23: the first window of phase 15 (frames 0-7, l1, JAX's
    window draws) with the landmark axis over model = 4 entries of
    cuda:0, against bundle_adjust; no host sync."""
    import torch

    from libviso_torch.config import BAConfig, Calib, PipelineConfig
    from libviso_torch.geometry.mvg import F_from_P_host
    from libviso_torch.parallel import make_mesh, sharded_bundle_adjust
    from libviso_torch.pipeline.batched import build_batched_odometry
    from libviso_torch.pipeline.refine import build_window_problem
    from libviso_torch.solvers.bundle_adjust import bundle_adjust
    from libviso_torch.solvers.gauss_newton import stereo_predict

    cfg = PipelineConfig().with_metric("l1")
    calib = Calib.from_projections(seq.P1, seq.P2)
    F = torch.as_tensor(F_from_P_host(seq.P1, seq.P2), dtype=torch.float32,
                        device="cuda")
    W = BA_WINDOW["window"]
    ims = [torch.as_tensor(np.stack([f[v] for f in seq.frames[:W]]),
                           device="cuda") for v in (0, 1)]
    front = build_batched_odometry(calib, F, cfg, with_tracks=True)
    out, tr = front(*ims, _window_draws(cfg)(0, W - 1).cuda())
    prob = build_window_problem(
        tr.kp1_xy, tr.kp2_xy, tr.mlr_idx, tr.mlr_valid, tr.m11_idx,
        tr.m11_valid, tr.X, out.motions, cfg.detector.num_slots,
        circ_valid=tr.circ_valid)
    mask = prob.mask & (prob.mask.sum(0) >= 2)[None]
    args = (prob.poses0, prob.X0, prob.obs, mask)
    iters = BAConfig().iters
    mesh = make_mesh(n_data=1, n_model=4, devices=["cuda:0"] * 4)
    ref = bundle_adjust(*args, calib, iters=iters)
    sharded_bundle_adjust(mesh, *args, calib, iters=iters)   # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = sharded_bundle_adjust(mesh, *args, calib, iters=iters)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    # the landmarks' sums are added in another order.  Held: the poses
    # within 1e-4 (JAX's test), the final cost within rtol 1e-4, and every
    # observation's reprojection within 0.01 px.  Not held: JAX's 1e-3 m
    # on each landmark.  The window keeps landmarks of near-zero disparity
    # or short tracks, whose V block is near-singular along the viewing
    # ray: there the 1e-6 pose difference, back-substituted, moves a
    # point metres along its ray without moving its reprojection.
    dp = float((res.poses - ref.poses).abs().max())
    pr, _ = stereo_predict(res.poses, res.landmarks, calib)
    pf, _ = stereo_predict(ref.poses, ref.landmarks, calib)
    dpx = float((pr - pf).abs().amax(-1)[mask].max())
    dX = (res.landmarks - ref.landmarks).norm(dim=-1)
    worst = int(dX.argmax())
    check(dp <= 1e-4, f"sharded BA: poses {dp} from bundle_adjust")
    check(dpx <= 1e-2, f"sharded BA: a reprojection {dpx} px from "
          f"bundle_adjust's")
    check(abs(float(res.cost) - float(ref.cost)) <= 1e-4 * float(ref.cost),
          f"sharded BA: cost {float(res.cost)} against {float(ref.cost)}")
    check(float(res.cost) < float(res.initial_cost), "sharded BA: cost rose")
    print(f"[sharded-ba] window 0 ({W} x {prob.X0.shape[0]}, "
          f"{int(mask.sum())} observations), landmarks over 4 entries of "
          f"cuda:0: poses within {dp}, reprojections within {dpx} px of "
          f"bundle_adjust, cost {float(res.initial_cost):.6f} -> "
          f"{float(res.cost):.6f} (unsharded {float(ref.cost):.6f}), no "
          f"host sync; landmarks: {int((dX <= 1e-3).sum())} of {len(dX)} "
          f"within 1e-3 m, the farthest apart {float(dX[worst]):.4f} m "
          f"({int(mask[:, worst].sum())} observations, "
          f"{float(ref.landmarks[worst].norm()):.1f} m away)")
    fns = {"bundle_adjust": lambda: bundle_adjust(*args, calib, iters=iters),
           "sharded": lambda: sharded_bundle_adjust(mesh, *args, calib,
                                                    iters=iters)}
    ms = {k: [] for k in fns}
    for k in list(fns) + list(fns)[::-1]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fns[k]()
        torch.cuda.synchronize()
        ms[k].append(1e3 * (time.perf_counter() - t0))
    print(f"[sharded-ba] wall ms per solve in turns: bundle_adjust "
          f"{ms['bundle_adjust']}, sharded {ms['sharded']}")


_MULTIHOST_WORKER = """
import json
import sys
import numpy as np
from libviso_torch.config import PipelineConfig
from libviso_torch.parallel import (
    host_chunk_assignment, make_mesh, run_sharded_odometry_multihost)
from libviso_torch.parallel.distributed import (
    describe, initialize_from_env, process_index)
from libviso_torch.synthetic import generate_sequence

if not (initialize_from_env() and describe()["process_count"] == 2):
    raise SystemExit("the VISO_* variables did not make a 2-process group")
seq = generate_sequence(**json.loads(sys.argv[2]))
T = len(seq.frames)
plan = host_chunk_assignment(T, 2, process_index(), 2)
span = slice(plan["frame_start"], plan["frame_stop"])
poses, _ = run_sharded_odometry_multihost(
    make_mesh(n_data=2, devices=["cuda:0"] * 2), seq.P1, seq.P2,
    np.stack([f[0] for f in seq.frames])[span],
    np.stack([f[1] for f in seq.frames])[span], T,
    PipelineConfig().with_metric("l1"), seed=0)
np.save(sys.argv[1], poses)
"""


def _same_bits(a, b):
    """Equal bit for bit, NaN in the same places included."""
    import torch

    return a.shape == b.shape and torch.equal(
        a.view(torch.int32) if a.dtype == torch.float32 else a,
        b.view(torch.int32) if b.dtype == torch.float32 else b)


def sharded_serve_phase(seqs):
    """Phase 24: jit_multistream_sharded (4 streams over 2 entries of
    cuda:0) against the unsharded step; cli kitti with the VISO_*
    variables unset; a two-process gloo run of
    run_sharded_odometry_multihost on cuda:0.  Returns each kernel's
    launches in the sharded serving run under its backend, and an entry's
    match problems as kernel_shapes_phase takes them."""
    import socket

    import torch

    from libviso_torch.config import Calib, PipelineConfig
    from libviso_torch.geometry.mvg import F_from_P_host
    from libviso_torch.ops import matching
    from libviso_torch.parallel import make_mesh, run_sharded_odometry
    from libviso_torch.pipeline import multistream as ms
    from libviso_torch.solvers.ransac import frame_generator, sample_gumbel
    from libviso_torch.synthetic import generate_sequence

    cfg = PipelineConfig().with_metric("l1")
    S, steps = 4, 6
    streams = seqs[:S]
    calibs = [Calib.from_projections(s.P1, s.P2) for s in streams]
    F = torch.as_tensor(np.stack([F_from_P_host(s.P1, s.P2)
                                  for s in streams]), dtype=torch.float32,
                        device="cuda")
    mesh = make_mesh(n_data=2, devices=["cuda:0"] * 2)
    shape = (cfg.ransac.num_hypotheses, cfg.detector.num_slots)
    launches, problems = {}, {}
    for backend, kernels in BACKEND_KERNELS.items():
        plain = ms.build_multistream_step(cfg, backend)
        sharded = ms.jit_multistream_sharded(mesh, cfg, backend=backend)
        st_p = st_s = ms.stack_states([ms.empty_state(cfg, "cuda")] * S)
        reset_launches()
        for t in range(steps):
            ims = [torch.as_tensor(np.stack([s.frames[t][v]
                                             for s in streams]),
                                   device="cuda") for v in (0, 1)]
            g = [sample_gumbel(shape, frame_generator(s, t)).cuda()
                 for s in range(S)]
            st_p, out_p = plain(calibs, F, st_p, *ims, g)
            before = read_launches()
            with _capturing(matching, lambda a: f"problems of a serving "
                            f"entry at step {t} (2 streams x 3)") as (
                                seen, per_shape):
                st_s, out_s = sharded(calibs, F, st_s, *ims, g)
            check(set(per_shape) == {ENTRY_SHAPE}, f"sharded serving "
                  f"{backend}: match problems of the shapes "
                  f"{sorted(per_shape)}, not {ENTRY_SHAPE}")
            for k, n in read_launches().items():
                launches[k] = launches.get(k, 0) + n - before[k]
            if t == 1 and backend == "dense":
                problems = seen   # step 0's temporal targets are empty
            check(all(_same_bits(a, b) for a, b in zip(
                ms.state_leaves(st_p), ms.state_leaves(st_s))),
                f"sharded serving {backend} step {t}: a state differs")
            for s_, (op, os_) in enumerate(zip(out_p, out_s)):
                for name, a, b in zip(op._fields, op, os_):
                    check(_same_bits(a, b), f"sharded serving {backend} "
                          f"step {t}, stream {s_}: {name} {a.tolist()} != "
                          f"{b.tolist()}")
        for k in kernels:
            check(launches[k] == 2 * steps, f"sharded serving {backend}: "
                  f"{launches[k]} launches of {k} in {steps} steps over 2 "
                  f"entries")
        print(f"[sharded-serve] jit_multistream_sharded {backend}, {S} "
              f"streams over 2 entries of cuda:0, {steps} steps: every state "
              f"and output == the unsharded step bit for bit, "
              f"{[launches[k] for k in kernels]} launches of "
              f"{' and '.join(kernels)} (one an entry a step)")

    for var in ("VISO_COORDINATOR", "VISO_NUM_PROCESSES", "VISO_PROCESS_ID"):
        os.environ.pop(var, None)
    try:
        import PIL  # noqa: F401
        have_pil = True
    except ImportError:
        have_pil = False
        print("[sharded-serve] PIL does not import here: cli kitti not run")
    if have_pil:
        import contextlib
        import io
        import shutil

        from libviso_torch import cli

        home = os.path.join(ROOT, "build", "chip_smoke_viso")
        _write_mini_kitti(home)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(["kitti", "viso", "77", "--kitti-home", home,
                      "--metric", "l2q8"])
        out = json.loads(buf.getvalue().strip().splitlines()[-1])
        check(out["solved"] == 5 and out["device"] == "cuda",
              f"cli kitti --metric l2q8: {out}")
        print(f"[sharded-serve] cli kitti --metric l2q8 with VISO_* unset: "
              f"{json.dumps(out)}")
        shutil.rmtree(home)

    # two processes on cuda:0, rendezvous over localhost, gloo exchange
    spec = {**KITTI_SEQUENCE, "num_frames": 9}
    out_dir = os.path.join(ROOT, "build", "chip_smoke_multihost")
    os.makedirs(out_dir, exist_ok=True)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    t0 = time.perf_counter()
    try:
        for pid in range(2):
            env = dict(os.environ, VISO_COORDINATOR=f"localhost:{port}",
                       VISO_NUM_PROCESSES="2", VISO_PROCESS_ID=str(pid),
                       PYTHONPATH=ROOT)
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _MULTIHOST_WORKER,
                 os.path.join(out_dir, f"p{pid}.npy"), json.dumps(spec)],
                cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for pid, (p, log) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"multihost process {pid} exited "
              f"{p.returncode}: {log[-2000:]}")
    seq = generate_sequence(**spec)
    ref, _ = run_sharded_odometry(
        mesh, seq.P1, seq.P2, np.stack([f[0] for f in seq.frames]),
        np.stack([f[1] for f in seq.frames]), cfg, seed=0)
    for pid in range(2):
        got = np.load(os.path.join(out_dir, f"p{pid}.npy"))
        check(np.array_equal(got, ref), f"multihost process {pid} != the "
              f"one-process run")
    print(f"[sharded-serve] two processes on cuda:0 (gloo over "
          f"localhost:{port}), 2 chunks of 5 KITTI-size frames: both == "
          f"run_sharded_odometry in one process bit for bit ({wall:.1f} s "
          f"with start-up)")
    return launches, problems


def profiling_phase(kernel_names):
    """Phase 25: libviso_torch.utils.profiling on the card.  Returns
    kernel #1's launches in the l1 profile through the kernel, and the
    kernel's row at the profile's shape, timed alone."""
    import re

    import torch

    from libviso_torch.ops import cuda_matching as cm
    from libviso_torch.utils import profiling as prof

    peak_f, peak_b = prof.device_peaks()
    check(peak_f is not None and peak_b is not None,
          f"device_peaks() has no row for {torch.cuda.get_device_name(0)}")
    print(f"[profile] device_peaks(): {peak_f:.6g} FLOP/s (FP32), "
          f"{peak_b:.6g} B/s")
    reps, warmup = 20, 3   # profile_matcher's reps, time_call's warm-up
    stats, profile_launches = [], None
    for metric, backend in (("l1", "kernel"), ("l1", "plain"),
                            ("l2", "kernel"), ("l2q8", "kernel")):
        before = cm.launches
        stats.append(prof.profile_matcher(1280, 1280, 128, metric=metric,
                                          backend=backend, reps=reps))
        n = cm.launches - before
        want = (warmup + reps) if (metric, backend) == ("l1", "kernel") \
            else 0
        check(n == want, f"profile_matcher({metric}, {backend}) launched "
              f"kernel #1 {n} times, not {want}")
        if want:
            profile_launches = n
    t0 = time.perf_counter()
    stats.append(prof.profile_solver())
    stats.append(prof.profile_frame_step(chain=16, reps=3))
    stats.append(prof.profile_mono_step(chain=4, reps=2))
    print(f"[profile] solver, frame step and mono step profiled in "
          f"{time.perf_counter() - t0:.1f} s")
    for st in stats:
        print(f"[profile] {st.pretty()}  ({st.seconds!r} s)")
        check(st.flop_util <= 1.05 and st.bw_util <= 1.05,
              f"{st.name}: flop_util {st.flop_util}, bw_util "
              f"{st.bw_util} above 1.05: the cost model or the timer is "
              f"wrong")

    # kernel #1 alone at the profile's shape, on integer descriptors
    _, N, D = PROFILE_SHAPE
    rng = np.random.default_rng(25)
    a, b = (torch.tensor(rng.integers(0, 256, (N, D)), dtype=torch.float32,
                         device="cuda") for _ in range(2))
    check(torch.equal(cm.l1_distance_matrix(a, b),
                      cm.l1_distance_matrix_plain(a, b)),
          f"kernel #1 != plain at the profile's shape {PROFILE_SHAPE}")
    fns = {"plain": lambda: cm.l1_distance_matrix_plain(a, b),
           "kernel": lambda: cm.l1_distance_matrix(a, b),
           "library": lambda: torch.cdist(a, b, p=1)}
    ms = {k: [] for k in fns}
    for k in list(fns) + list(fns)[::-1]:
        ms[k].append(_time_ms(fns[k]))
    t = {k: sum(v) / 2 for k, v in ms.items()}
    per_call = 1e3 * prof.time_call(fns["kernel"], reps=20,
                                      clock="device")
    bound, by = bound_ms(2 * N * N * D, 4 * (2 * N * D + N * N))
    print(f"[profile] kernel #1 alone at {PROFILE_SHAPE}: {t['kernel']:.4f} "
          f"ms {ms['kernel']} (device_ms, a mean of 20 calls; time_call's "
          f"median of single calls {per_call:.4f} ms), bound {bound:.4f} ms "
          f"({by}, share {bound / t['kernel']:.3f}); plain {t['plain']:.4f} "
          f"ms; torch.cdist(p=1) {t['library']:.4f} ms")
    row = {"ms": t["kernel"], "plain_ms": t["plain"],
           "library_ms": t["library"], "bound_ms": bound, "bound_by": by,
           "share_of_bound": bound / t["kernel"], "path": "profile_matcher",
           "launches": profile_launches}

    source = open(os.path.join(ROOT, "libviso_torch", "csrc",
                               "l1_distance.cu")).read()
    name = next((k for k in kernel_names if re.search(
        rf"\b{k}\s*\(", source)), None)
    check(name is not None, f"no kernel of the build {kernel_names} is "
          f"defined in csrc/l1_distance.cu")
    # trace() around one l1 match in a fresh process, where it must name
    # the kernel, and here, after phases 4-24 and the processes they
    # started: here the profiler may lose the kernel's record (PERF.md
    # §7), and then trace() must raise rather than return the trace
    base = os.path.join(ROOT, "build", "chip_smoke_trace")
    here, fresh = os.path.join(base, "here"), os.path.join(base, "fresh")
    cmd = [sys.executable, "-c",
           f"import chip_smoke; chip_smoke._trace_l1({fresh!r})"]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    check(proc.returncode == 0, f"the trace process exited "
          f"{proc.returncode}:\n{proc.stderr[-2000:]}")
    try:
        _trace_l1(here)
        raised = None
    except RuntimeError as e:
        raised = str(e)
    for label, logdir in (("in a fresh process", fresh),
                          ("in this process", here)):
        path = os.path.join(logdir, "trace.json")
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
        kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
        launches = [e["name"] for e in events
                    if e.get("cat") == "cuda_runtime"
                    and "LaunchKernel" in e.get("name", "")]
        named = any(name in k for k in kernels)
        if logdir == here and raised is not None:
            check(launches and not named, f"trace() raised but {path} "
                  f"holds the kernel's record: {raised}")
            print(f"[profile] trace() around one l1 match, {label}: the "
                  f"profiler lost the kernel's record and trace() raised: "
                  f"{raised}")
            continue
        cats = sorted({str(e.get("cat")) for e in events})
        check(named, f"the trace {path} does not name {name}: its kernels "
              f"{kernels}, its categories {cats}")
        print(f"[profile] trace() around one l1 match, {label}: {path} "
              f"({os.path.getsize(path)} bytes) names {name}: {kernels}")
    return profile_launches, row


def _trace_l1(logdir):
    """One l1 match under profiling.trace(logdir), after a warm-up call
    outside it."""
    import torch

    from libviso_torch.ops import cuda_matching as cm
    from libviso_torch.utils import profiling as prof

    g = torch.Generator(device="cuda").manual_seed(25)
    a, b = (torch.randn((1280, 128), generator=g, device="cuda")
            for _ in range(2))
    cm.l1_distance_matrix(a, b)
    torch.cuda.synchronize()
    with prof.trace(logdir):
        cm.l1_distance_matrix(a, b)
        torch.cuda.synchronize()


def _cpu_model():
    with open("/proc/cpuinfo") as fh:
        for line in fh:
            if line.startswith("model name"):
                return line.split(":", 1)[1].strip()
    return "unknown"


def native_phase(seq):
    """Phase 26: the native image runtime against PIL on PNG frames."""
    from libviso_torch import native

    reason = native.unavailable_reason()
    print(f"[native] available() {reason is None}"
          + ("" if reason is None else f": {reason}"))
    if reason is not None:
        return
    try:
        from PIL import Image
    except ImportError:
        print("[native] PIL does not import here: no comparison made")
        return
    import shutil

    from libviso_torch.io import kitti

    home = os.path.join(ROOT, "build", "chip_smoke_native")
    _write_mini_kitti(home)
    base = os.path.join(home, "sequences", "00")
    for cam in ("image_0", "image_1"):
        os.makedirs(os.path.join(base, cam))
    for i, pair in enumerate(seq.frames):
        for cam, im in zip(("image_0", "image_1"), pair):
            Image.fromarray(np.asarray(im).astype(np.uint8)).save(
                os.path.join(base, cam, f"{i:06d}.png"))

    def pil(path):
        with Image.open(path) as im:
            return np.asarray(im.convert("L"), dtype=np.uint8)

    for name, count in (("77", 6), ("00", len(seq.frames))):
        masks = [os.path.join(home, "sequences", name, cam, "%06d.png")
                 for cam in ("image_0", "image_1")]
        frames = list(kitti.StereoImageStream(*masks))
        check(len(frames) == count, f"sequence {name}: {len(frames)} "
              f"frames streamed, not {count}")
        for i, pair in enumerate(frames):
            for mask, got in zip(masks, pair):
                want = pil(mask % i)
                check(np.array_equal(native.decode_png_gray(mask % i),
                                     want) and np.array_equal(got, want),
                      f"{mask % i}: native decode != PIL")
        print(f"[native] sequence {name}: {count} pairs of "
              f"{frames[0][0].shape[1]}x{frames[0][0].shape[0]} byte-equal "
              f"to PIL, in order through StereoImageStream")

    masks = [os.path.join(base, cam, "%06d.png")
             for cam in ("image_0", "image_1")]
    routes = {"native": kitti._native, "PIL": lambda: None}
    ms = {k: [] for k in routes}
    try:
        for route in ("native", "PIL", "PIL", "native"):
            kitti._native = routes[route]
            t0 = time.perf_counter()
            n = sum(1 for _ in kitti.StereoImageStream(*masks))
            ms[route].append(1e3 * (time.perf_counter() - t0) / n)
    finally:
        kitti._native = routes["native"]
    shutil.rmtree(home)
    print(f"[native] host ms a 1241x376 stereo pair over {n} pairs, in "
          f"turns: native stream {ms['native']}, PIL read-ahead "
          f"{ms['PIL']}; {os.cpu_count()} cores of {_cpu_model()}")


# phase 27: bench_torch.py's modes at --reps=8 --window=8, each with the
# kernels its route launches (l2, the default, and mono's l2 launch none)
BENCH_ARGS = ("--reps=8", "--window=8")
BENCH_MODES = (
    ((), ()),
    (("--chunk=1", "--metric=l1"), ("l1_distance_matrix",)),
    (("--streams=4", "--metric=l1", "--backend=fused"),
     ("fused_gated_two_min",)),
    (("--metric=l1", "--backend=sweep"),
     ("sweep_order", "fused_sweep_two_min")),
    (("--staged",), ()),
    (("--upload",), ()),
    (("--mono", "--reps=4"), ()),
    (("--profile",), ()))
BENCH_KEYS = ["metric", "value", "unit", "vs_baseline"]
BENCH_STREAM_KEYS = BENCH_KEYS + ["value_best_window", "mode"]


def _bench_steps(args):
    """The frame steps (serving: timesteps) one run of bench_torch's args
    makes, warm-up included: one launch each of its route's kernels."""
    W, reps, K = bench_torch.WINDOWS, args.reps, args.chunk
    if args.streams > 1:
        K = max(1, K)
        return (bench_torch.WARMUP_STEPS + W * max(1, reps // K)) * K
    if K > 1:
        return (1 + W * max(1, reps // K)) * K
    return bench_torch.WARMUP_STEPS + W * reps


def check_bench_line(line, args):
    """bench.py's keys for the mode, a finite positive value, and
    vs_baseline the value over the mode's baseline, rounded to 3."""
    streaming = args.mono or not (args.staged or args.upload)
    keys = BENCH_STREAM_KEYS if streaming else BENCH_KEYS
    check(list(line) == keys, f"bench line keys {list(line)}, not {keys}")
    metric, base = (
        ("mono_sfm_fps", bench_torch.MONO_BASELINE_FPS) if args.mono
        else ("stereo_vo_fps", bench_torch.BASELINE_FPS))
    check(line["metric"] == metric and line["unit"] == "frames/s",
          f"bench line {line}: not {metric} in frames/s")
    check(math.isfinite(line["value"]) and line["value"] > 0,
          f"bench value {line['value']}")
    check(line["vs_baseline"] == round(line["value"] / base, 3),
          f"bench vs_baseline {line['vs_baseline']} != round("
          f"{line['value']} / {base}, 3)")


def bench_phase():
    """Phase 27: bench_torch.main in this process in each of BENCH_MODES;
    returns, per kernel, its launches in the modes that reach it."""
    import io

    launches = {k: {} for k in KERNELS}
    for mode, kernels in BENCH_MODES:
        argv = [*BENCH_ARGS, *mode]
        args = bench_torch.parse_args(argv)
        out = io.StringIO()
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            line = bench_torch.main(argv)
        wall = time.perf_counter() - t0
        counts = read_launches()
        printed = out.getvalue().splitlines()
        check(len(printed) == 1 and json.loads(printed[0]) == line,
              f"bench_torch {' '.join(argv)} printed {printed!r}")
        check_bench_line(line, args)
        steps = _bench_steps(args)
        for name in KERNELS:
            want = steps if name in kernels else 0
            check(counts[name] == want, f"bench_torch {' '.join(argv)}: "
                  f"{name} launched {counts[name]} times, not {want}")
            if want:
                launches[name][" ".join(mode)] = counts[name]
        print(f"[bench] {' '.join(argv)} ({wall:.1f} s; "
              + (", ".join(f"{k} {counts[k]} launches" for k in kernels)
                 or "no kernel launched") + f"): {printed[0]}")
    return launches


def bench_cli_phase():
    """The smoke's last act, after every trace: `python3 bench_torch.py
    --reps=4` exits 0 with exactly one JSON line on stdout."""
    cmd = [sys.executable, "bench_torch.py", "--reps=4"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"{' '.join(cmd[1:])} exited "
          f"{proc.returncode}:\n{proc.stderr[-2000:]}")
    printed = proc.stdout.splitlines()
    check(len(printed) == 1, f"{' '.join(cmd[1:])} printed {printed!r}")
    line = json.loads(printed[0])
    check_bench_line(line, bench_torch.parse_args(cmd[2:]))
    check(line["mode"] == "streaming_chunk4", f"bench mode {line['mode']}")
    print(f"[bench-cli] {' '.join(cmd[1:])} ({wall:.1f} s with start-up; "
          f"stderr {proc.stderr.strip().splitlines()[0]!r}): {printed[0]}")


def kernels_line(launches, l1_err, l1_times, serve_launches, fused_err,
                 fused_times, counts):
    """The kernel table: per kernel its main-path launches and, at the
    shape of the path that launched it, its time, bound and share, plain
    and library times; ``shapes`` holds the same at both shapes."""
    from libviso_torch.ops import fused_matching as fm

    def gated(shape):
        # the same function as the route: the pairs these inputs need
        B, N, D = shape
        c = counts[shape]
        bound, by = two_min_bound(B, N, N, D, c["pairs"])
        t = fused_times[shape]
        return {"ms": t["fused"], "plain_ms": t["plain"], "library_ms": None,
                "bound_ms": bound, "bound_by": by, "pairs": c["pairs"]}

    def order(shape):
        # read xy and validity, write both permutations and the boxes; at
        # least log2(N!) ~ N log2 N comparisons a side
        B, N, _ = shape
        n_boxes = sum(-(-N // k) for k in fm.SWEEP_TILING)
        bound, by = bound_ms(2 * B * N * math.log2(N),
                             B * (2 * N * 9 + 2 * N * 4 + 16 * n_boxes))
        t = fused_times[shape]
        return {"ms": t["order"], "plain_ms": t["order plain"],
                "library_ms": None, "bound_ms": bound, "bound_by": by}

    def sweep(shape):
        # the route: the pairs these inputs need, at any tiling
        B, N, D = shape
        c = counts[shape]
        bound, by = two_min_bound(B, N, N, D, c["pairs"])
        t = fused_times[shape]
        return {"ms": t["sweep route"], "order_ms": t["order"],
                "sweep_ms": t["sweep"], "fused_ms": t["fused"],
                "plain_ms": t["sweep route plain"], "library_ms": None,
                "bound_ms": bound, "bound_by": by,
                "route_launches": c["route_launches"], "pairs": c["pairs"],
                "windows": c["windows"],
                "skip_share": 1.0 - c["windows"] / c["windows_unskipped"]}

    def entry(name, source, replaces, n, err, per_shape, shape):
        for row in per_shape.values():
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": n, "max_abs_err": err,
                **per_shape[shape],
                "shapes": [{"shape": list(k), **v}
                           for k, v in per_shape.items()]}

    shapes = (MAIN_SHAPE, SERVE_SHAPE)
    return {"kernels": [
        entry("l1_distance_matrix", "libviso_torch/csrc/l1_distance.cu",
              "libviso_tpu/ops/pallas_matching.py:53", launches, l1_err,
              l1_times, MAIN_SHAPE),
        entry("fused_gated_two_min", "libviso_torch/csrc/fused_two_min.cu",
              "libviso_tpu/ops/pallas_fused_match.py:214",
              serve_launches["fused_gated_two_min"],
              fused_err["fused_gated_two_min"],
              {k: gated(k) for k in shapes}, SERVE_SHAPE),
        entry("sweep_order", "libviso_torch/csrc/sweep_order.cu",
              "libviso_tpu/ops/pallas_fused_match.py:375",
              serve_launches["sweep_order"], fused_err["sweep_order"],
              {k: order(k) for k in shapes}, SERVE_SHAPE),
        entry("fused_sweep_two_min", "libviso_torch/csrc/fused_sweep.cu",
              "libviso_tpu/ops/pallas_fused_match.py:314",
              serve_launches["fused_sweep_two_min"],
              fused_err["fused_sweep_two_min"],
              {k: sweep(k) for k in shapes}, SERVE_SHAPE)]}


def main():
    t_start = time.perf_counter()
    device_name, count, smi = device_phase()
    kernel_names = build_phase()
    l1_err, l1_times = kernel_phase()

    from libviso_torch.synthetic import generate_sequence

    seq = generate_sequence(**KITTI_SEQUENCE)
    launches, _, whole = main_path_phase(seq)
    card_vs_cpu_phase(seq)
    entry_point_phase()
    seqs = _serve_sequences(seq)
    fused_err, fused_times, counts = fused_kernel_phase(seqs)
    serve_launches, serve_fps = serving_phase(seqs)
    serve_cli_phase()
    window_launches = stereo_path_phase(seq, seqs, whole, serve_fps)

    mono_rows = mono_kernel_phase(seq)
    mono_launches = mono_phase(seq)
    mono_cli_phase()

    t0 = time.perf_counter()
    circle = loop_circle_sequence()
    print(f"[loop] {len(circle.frames)}-frame circle of 1241x376 generated "
          f"in {time.perf_counter() - t0:.1f} s")
    loop_launches, search, _ = loop_phase(circle)
    mono_loop_launches, mono_search = mono_loop_phase()
    check(tuple(mono_search[4].shape) == MONO_LOOP_SHAPE,
          f"the mono loop's store is {tuple(mono_search[4].shape)}, not "
          f"{MONO_LOOP_SHAPE}")
    loop_rows, loop_err = kernel_shapes_phase("loop-kernel", {
        shape: ("candidate search", _problem_from_search(problem), 1.0, 1e9)
        for shape, problem in ((LOOP_SHAPE, search),
                               (MONO_LOOP_SHAPE, mono_search))}, 12)
    loop_cli_phase()

    ba_launches, ba_shape_launches, ba_problems = ba_phase(seq)
    ba_rows, ba_err = kernel_shapes_phase("ba-kernel", ba_problems, 20)
    ba_loop_launches = ba_loop_phase(circle)
    ba_cli_phase()

    variants_phase(seq)
    tp_launches, shard_row = tp_phase(seq)
    chunk_launches, chunk_shape_launches, chunk_problems = chunk_phase()
    chunk_rows, chunk_err = kernel_shapes_phase("chunk-kernel",
                                                chunk_problems, 30)
    pp_launches = staged_phase(seq, whole)
    sharded_ba_phase(seq)
    sharded_serve_launches, entry_problems = sharded_serve_phase(seqs)
    entry_rows, entry_err = kernel_shapes_phase("entry-kernel",
                                                entry_problems, 40)
    profile_launches, profile_row = profiling_phase(kernel_names)
    native_phase(seq)
    bench_launches = bench_phase()
    bench_cli_phase()

    line = kernels_line(launches, l1_err, l1_times, serve_launches,
                        fused_err, fused_times, counts)
    for k in line["kernels"]:
        kernel = k["name"]
        k["window_launches"] = window_launches.get(kernel)
        k["mono_launches"] = mono_launches[kernel]
        k["loop_launches"] = loop_launches.get(kernel)
        k["mono_loop_launches"] = mono_loop_launches.get(kernel)
        k["ba_launches"] = ba_launches.get(kernel)
        k["ba_loop_launches"] = ba_loop_launches.get(kernel)
        k["max_abs_err"] = max(k["max_abs_err"], loop_err[kernel],
                               ba_err[kernel], chunk_err[kernel],
                               entry_err[kernel])
        k["shapes"].append({"shape": list(MONO_SHAPE), **mono_rows[kernel]})
        k["shapes"].append({"shape": list(LOOP_SHAPE),
                            "launches": loop_launches.get(kernel),
                            **loop_rows[LOOP_SHAPE][kernel]})
        k["shapes"].append({"shape": list(MONO_LOOP_SHAPE),
                            "launches": mono_loop_launches.get(kernel),
                            **loop_rows[MONO_LOOP_SHAPE][kernel]})
        for shape in BA_SHAPES:
            k["shapes"].append({"shape": list(shape),
                                "launches": ba_shape_launches[shape][kernel],
                                **ba_rows[shape][kernel]})
        # phase 20 runs kernel #1 only
        k["tp_launches"] = {"l1_distance_matrix": tp_launches}.get(kernel)
        k["chunk_launches"] = chunk_launches.get(kernel)
        k["pp_launches"] = pp_launches.get(kernel)
        k["sharded_serve_launches"] = sharded_serve_launches[kernel]
        k["profile_launches"] = {
            "l1_distance_matrix": profile_launches}.get(kernel)
        k["bench_launches"] = bench_launches[kernel]
        if kernel == "l1_distance_matrix":
            k["shapes"].append({"shape": list(SHARD_SHAPE), **shard_row})
            k["shapes"].append({"shape": list(PROFILE_SHAPE), **profile_row})
        for shape in CHUNK_SHAPES:
            k["shapes"].append({"shape": list(shape),
                                "path": "chunked odometry",
                                "launches": chunk_shape_launches[shape][kernel],
                                **chunk_rows[shape][kernel]})
        k["shapes"].append({"shape": list(ENTRY_SHAPE),
                            "path": "sharded serving entry",
                            "launches": sharded_serve_launches[kernel],
                            **entry_rows[ENTRY_SHAPE][kernel]})
    print(f"[time] chip_smoke.py took {time.perf_counter() - t_start:.1f} s "
          f"on {smi}")
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name, "count": count}}))


if __name__ == "__main__":
    main()
