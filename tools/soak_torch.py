#!/usr/bin/env python3
"""Long-drive soak of the PyTorch port on one CUDA card: a 600-frame,
5-lap plaza drive through ``run_with_loop_closure`` with checkpointing.

  python3 tools/soak_torch.py [--frames 600] [--laps 5] [--device cuda]
      [--out soak.json]

The settings are those of the JAX package's soak
(benchmarks/soak_long_run.py): 480 features in 12x4 bins, 512 slots, 32
RANSAC hypotheses, ``generate_plaza_sequence(600, seed=0, circuits=5)``,
a keyframe every 3 frames, min_gap 40, min_matches 40, min_inliers 20, a
store of 128 keyframes (spatial eviction), a checkpoint every 50 frames.
The draws are the port's own (``frame_generator``), as a user's run's.

Prints one JSON line with the soak's fields (solved share, loops per lap,
ATE of the open chain and the optimized trajectory, endpoint errors, host
RSS every 50 frames, evictions, frames/s) and the checks against the JAX
package's record (benchmarks/soak_r5.json, ``post_fix``): every frame
solved, loops per lap within 10 % of JAX's on the full laps after the
first, the optimized ATE below the open chain's and within max(1.5 J,
J + 0.02 m) of JAX's J, and host memory flat after frame 100 (under 64 MB
of growth).  Exits 1 when a check fails.  Frames/s is reported, not held.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# benchmarks/soak_r5.json, "post_fix": the JAX package's 600-frame run
JAX_SOAK = {"loops": 163, "loops_per_lap": {"0": 3, "1": 40, "2": 39,
                                            "3": 40, "4": 40, "5": 1},
            "ate_vo": 3.876, "ate_opt": 1.78, "endpoint_err_vo": 6.705,
            "endpoint_err_opt": 0.202, "solved_frac": 1.0}
RSS_FLAT_MB = 64.0


def vm_rss_mb():
    with open("/proc/self/status") as fh:
        for line in fh:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    return -1.0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=600)
    ap.add_argument("--laps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None,
                    help="also write the JSON line to this file")
    args = ap.parse_args()

    import torch

    from libviso_torch.config import (
        DetectorConfig,
        PipelineConfig,
        RansacConfig,
    )
    from libviso_torch.pipeline.loop import run_with_loop_closure
    from libviso_torch.synthetic_world import generate_plaza_sequence
    from libviso_torch.utils.checkpoint import CheckpointManager
    from libviso_torch.utils.metrics import ate_rmse

    cfg = PipelineConfig(
        detector=DetectorConfig(max_features=480, nbinx=12, nbiny=4,
                                num_slots=512),
        ransac=RansacConfig(num_hypotheses=32))
    t0 = time.perf_counter()
    seq = generate_plaza_sequence(num_frames=args.frames, seed=0,
                                  circuits=args.laps)
    t_render = time.perf_counter() - t0
    print(f"rendered {args.frames} frames ({args.laps} laps) in "
          f"{t_render:.1f} s, RSS {vm_rss_mb():.0f} MB", file=sys.stderr,
          flush=True)

    rss = []

    def frames():
        for t, fr in enumerate(seq.frames):
            if t % 50 == 0:
                rss.append((t, round(vm_rss_mb(), 1)))
                print(f"  frame {t:4d}  RSS {rss[-1][1]:7.1f} MB  "
                      f"t+{time.perf_counter() - t0:6.1f} s",
                      file=sys.stderr, flush=True)
            yield fr

    with tempfile.TemporaryDirectory() as ckdir:
        mgr = CheckpointManager(ckdir, every=50)
        if args.device.startswith("cuda"):
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_with_loop_closure(
            frames(), seq.P1, seq.P2, cfg, keyframe_every=3, min_gap=40,
            min_matches=40, min_inliers=20, max_keyframes=128, seed=0,
            checkpoint=mgr, device=args.device)
        dt = time.perf_counter() - t0
        n_ck = len(os.listdir(ckdir))

    gt = seq.gt_poses
    err_vo = np.linalg.norm(res.poses_vo[:, :3, 3] - gt[:, :3, 3], axis=1)
    err_opt = np.linalg.norm(res.poses[:, :3, 3] - gt[:, :3, 3], axis=1)
    lap_len = (args.frames - 1) // args.laps
    per_lap = {}
    for le in res.loops:
        key = str(le.frame_new // lap_len)
        per_lap[key] = per_lap.get(key, 0) + 1
    ate_vo = float(ate_rmse(res.poses_vo, gt))
    ate_opt = float(ate_rmse(res.poses, gt))
    rss_after_100 = [mb for t, mb in rss if t >= 100]
    out = {
        "device": (torch.cuda.get_device_name(0)
                   if args.device.startswith("cuda") else args.device),
        "frames": args.frames, "laps": args.laps,
        "fps": args.frames / dt, "render_s": t_render, "run_s": dt,
        "solved_frac": float(res.frame_ok[1:].mean()),
        "loops": len(res.loops),
        "loops_per_lap": dict(sorted(per_lap.items())),
        "candidates_checked": len(res.candidates),
        "ate_vo": ate_vo, "ate_opt": ate_opt,
        "endpoint_err_vo": float(err_vo[-1]),
        "endpoint_err_opt": float(err_opt[-1]),
        "graph_cost": list(res.graph_cost),
        "rss_mb": rss,
        "rss_growth_after_100_mb": (rss_after_100[-1] - rss_after_100[0]
                                    if rss_after_100 else None),
        "checkpoints_on_disk": n_ck,
        "keyframes_offered": res.keyframes_offered,
        "evictions": res.evictions, "store_skipped": res.store_skipped,
        "jax": JAX_SOAK,
    }
    j = JAX_SOAK["ate_opt"]
    full_laps = [str(k) for k in range(1, args.laps)]
    out["checks"] = {
        "all_solved": out["solved_frac"] == 1.0,
        "loops_per_lap_within_10pct": all(
            abs(per_lap.get(k, 0) - JAX_SOAK["loops_per_lap"][k])
            <= 0.1 * JAX_SOAK["loops_per_lap"][k] for k in full_laps)
        if args.frames == 600 and args.laps == 5 else None,
        "ate_opt_below_vo": ate_opt < ate_vo,
        "ate_opt_within_bound": ate_opt <= max(1.5 * j, j + 0.02),
        "rss_flat_after_100": (out["rss_growth_after_100_mb"] is not None
                               and out["rss_growth_after_100_mb"]
                               < RSS_FLAT_MB),
    }
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    if not all(v for v in out["checks"].values() if v is not None):
        sys.exit(1)


if __name__ == "__main__":
    main()
