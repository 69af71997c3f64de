#!/usr/bin/env python3
"""Smoke run of the PyTorch port (libviso_torch) on one CUDA card.

  python3 chip_smoke.py        (from the repository root; needs one card)

Phases, each of which exits non-zero on failure:
  1. device: a CUDA card is visible; its name and power limit are printed;
  2. build: the CUDA kernels are compiled from libviso_torch/csrc;
  3. kernel against plain: the L1 kernel equals its plain PyTorch version
     bitwise on integer-valued descriptors and within rtol 1e-5 on random
     floats, at the main path's shape and at a ragged one, and both are
     timed with CUDA events;
  4. main path: run_stereo_sequence on a KITTI-size synthetic sequence
     with metric l1 solves 19 of 20 frames through the kernel (one launch
     a frame) within the ATE bound of the JAX package's run;
  5. card against CPU: the first 4 frames give the same per-frame results
     on the card as through the port's plain versions on the CPU;
  6. entry point: `python -m libviso_torch.cli synth --metric l1` runs.

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import time

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
KITTI_SEQUENCE = dict(num_frames=20, num_points=900, seed=0, width=1241,
                      height=376, f=718.856, base=0.5371657, speed=0.8)
MAIN_SHAPE = (3, 1280, 128)   # a frame's three match problems
KEYS = ("ok", "num_lr", "num_circle", "num_inliers")


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
    return name, count


def build_phase():
    from libviso_torch import _build

    t0 = time.perf_counter()
    so = _build.build()
    print(f"[build] {os.path.relpath(so, ROOT)} in "
          f"{time.perf_counter() - t0:.2f} s")
    for line in so.with_suffix(".log").read_text().splitlines():
        if "Used" in line or "spill" in line:
            print(f"[build] ptxas: {line.strip()}")


def _time_ms(fn, reps=20):
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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

    a, b = make(MAIN_SHAPE, False), make(MAIN_SHAPE, False)
    kernel = lambda: cm.l1_distance_matrix(a, b)  # noqa: E731
    plain = lambda: cm.l1_distance_matrix_plain(a, b)  # noqa: E731
    for fn in (kernel, plain):   # warm-up
        fn()
    torch.cuda.synchronize()
    # in turns (plain, kernel, kernel, plain) inside one call
    p1, k1, k2, p2 = (_time_ms(fn) for fn in (plain, kernel, kernel, plain))
    ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    print(f"[kernel] {MAIN_SHAPE} x {MAIN_SHAPE}: kernel {ms:.4f} ms "
          f"({k1:.4f}, {k2:.4f}), plain {plain_ms:.4f} ms "
          f"({p1:.4f}, {p2:.4f}) per launch")
    return max_err, ms, plain_ms


def main_path_phase(seq):
    import torch

    from libviso_torch.config import PipelineConfig
    from libviso_torch.ops import cuda_matching as cm
    from libviso_torch.pipeline.stereo import run_stereo_sequence
    from libviso_torch.utils.metrics import ate_rmse

    fps = {}
    launches = None
    for metric in ("l1", "l2"):
        ends = []

        def on_frame(t, out):
            torch.cuda.synchronize()
            ends.append(time.perf_counter())

        cfg = PipelineConfig().with_metric(metric)
        if metric == "l1":
            cm.launches = 0
        res = run_stereo_sequence(seq.frames, seq.P1, seq.P2, cfg, seed=0,
                                  device="cuda", on_frame=on_frame)
        if metric == "l1":
            launches = cm.launches
        solved = int(res.frame_ok.sum())
        ate = ate_rmse(res.poses, seq.gt_poses)
        # frames 2..19: from the end of frame 1 to the end of frame 19
        fps[metric] = (len(ends) - 2) / (ends[-1] - ends[1])
        print(f"[main] metric {metric}: solved {solved}/{len(ends)}, "
              f"ATE {ate} m, {fps[metric]:.2f} frames/s over frames 2-19")
        if metric == "l1":
            bound = max(1.5 * JAX_ATE_M, JAX_ATE_M + 0.02)
            check(solved == 19, f"solved {solved} of 20 frames, not 19")
            check(launches == len(seq.frames),
                  f"kernel launched {launches} times for "
                  f"{len(seq.frames)} frames")
            check(ate <= bound, f"ATE {ate} m above the bound {bound} m "
                  f"(JAX {JAX_ATE_M} m)")
    return launches, fps


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


def main():
    name, count = device_phase()
    build_phase()
    max_err, ms, plain_ms = kernel_phase()

    from libviso_torch.synthetic import generate_sequence

    seq = generate_sequence(**KITTI_SEQUENCE)
    launches, _ = main_path_phase(seq)
    card_vs_cpu_phase(seq)
    entry_point_phase()

    print(json.dumps({"kernels": [{
        "name": "l1_distance_matrix", "route": "cuda",
        "source": "libviso_torch/csrc/l1_distance.cu",
        "replaces": "libviso_tpu/ops/pallas_matching.py:53",
        "launches": launches, "max_abs_err": max_err, "ms": ms,
        "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))


if __name__ == "__main__":
    main()
