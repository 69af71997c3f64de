#!/usr/bin/env python3
"""Where the PyTorch port's frame time goes, on one CUDA card.

  python3 tools/profile_torch_step.py [--repeats 4] [--out FILE.json]
  python3 tools/profile_torch_step.py --serve [--repeats 3] [--out ...]
  python3 tools/profile_torch_step.py --mono [--repeats 3] [--out ...]

Runs from the repository root, on the KITTI-size synthetic sequence of
chip_smoke.py (20 frames of 1241x376, default detector and RANSAC, seed 0),
and measures inside one process:

  1. frames/s over frames 2-19 for three variants, after a warm-up and in
     alternating order (A B C, C B A, ...): metric l1 through the CUDA
     kernel; metric l1 with the kernel's plain PyTorch version run on the
     card instead (an ablation that only this script makes, to show what
     the kernel is worth end to end); and metric l2;
  2. per-stage host times (upload + front-end, match, solve), with a sync
     after each stage, for l1 and l2;
  3. a torch.profiler trace of frames 10-14 of an l1 and an l2 run: the
     device's busy share, and per frame the kernel launches, host syncs,
     host-to-device copies and the largest device kernels.

With ``--serve`` it measures multi-stream serving instead, on 4 streams
of that generator (seeds 0-3, lengths 20, 20, 16, 12; metric l1):

  1. aggregate frames/s of run_multistream under each matcher backend
     (dense, fused, sweep), after a warm-up and in alternating order, over
     all frames and over timesteps 2-19;
  2. per-stage host times of the serving step (upload + front-end, match,
     correspondences, the solve: one call for all live streams, counted),
     a sync after each stage;
  3. a torch.profiler trace of timesteps 10-14 under each backend (its
     "per frame" counts are then per timestep).

With ``--mono`` it measures the monocular path at full width
(PipelineConfig.mono(): 1536 slots, 384-value descriptors, the 5-point
solver) on the left frames of that sequence, K = P1[:, :3]:

  1. frames/s of run_mono_sequence over frames 2-19 under metric l2 (dense)
     and metric l1 through each matcher backend (dense, fused, sweep),
     after a warm-up and in alternating order;
  2. per-stage host times of the mono step (upload + front-end, temporal
     match, first essential matrix, re-match, second essential matrix,
     pose recovery + refinement + scale), a sync after each stage;
  3. a torch.profiler trace of frames 10-14 under l2 dense and l1 fused.

Every trace is read by ``libviso_torch.utils.profiling.trace_events``,
which raises where the profiler lost a kernel record.  Everything is
printed; ``--out`` also writes it as JSON.
"""

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from libviso_torch.config import Calib, PipelineConfig  # noqa: E402
from libviso_torch.geometry.mvg import F_from_P_host  # noqa: E402
from libviso_torch.ops import cuda_matching, matching  # noqa: E402
from libviso_torch.pipeline import mono, multistream  # noqa: E402
from libviso_torch.pipeline.stereo import (  # noqa: E402
    build_frontend,
    build_prepare,
    build_solve,
    check_supported,
    empty_state,
    run_stereo_sequence,
)
from libviso_torch.solvers.ransac import (  # noqa: E402
    frame_generator,
    sample_gumbel,
)
from libviso_torch.synthetic import generate_sequence  # noqa: E402
from libviso_torch.utils.profiling import (  # noqa: E402
    device_counts,
    trace_events,
)

KITTI_SEQUENCE = dict(num_frames=20, num_points=900, seed=0, width=1241,
                      height=376, f=718.856, base=0.5371657, speed=0.8)
PROFILED = range(10, 15)   # frames inside the torch.profiler window
VARIANTS = ("l1", "l1-plain", "l2")
SERVE_LENGTHS = (20, 20, 16, 12)
MONO_VARIANTS = (("l2", "dense"), ("l1", "dense"), ("l1", "fused"),
                 ("l1", "sweep"))
MONO_STAGES = ("front_end", "match", "est1", "rematch", "est2",
               "pose_and_scale")
BACKENDS = ("dense", "fused", "sweep")


@contextlib.contextmanager
def plain_l1_on_device():
    """Route metric l1 through the plain version on any device (the
    ablation of variant 'l1-plain')."""
    kernel = matching.l1_distance_matrix
    matching.l1_distance_matrix = cuda_matching.l1_distance_matrix_plain
    try:
        yield
    finally:
        matching.l1_distance_matrix = kernel


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def frame_rate(seq, variant, device):
    """Frames/s over frames 2..T-1 and the per-frame times [ms]."""
    ends = []

    def on_frame(t, out):
        sync(device)
        ends.append(time.perf_counter())

    cfg = PipelineConfig().with_metric(variant[:2])
    ctx = plain_l1_on_device() if variant == "l1-plain" \
        else contextlib.nullcontext()
    with ctx:
        res = run_stereo_sequence(seq.frames, seq.P1, seq.P2, cfg, seed=0,
                                  device=device, on_frame=on_frame)
    frame_ms = [1e3 * (b - a) for a, b in zip(ends[1:], ends[2:])]
    return {"fps": (len(ends) - 2) / (ends[-1] - ends[1]),
            "median_frame_ms": statistics.median(frame_ms),
            "solved": int(res.frame_ok.sum())}


def stage_times(seq, metric, device):
    """Mean per-stage host times [ms] over frames 2..T-1, a sync after
    each stage (the step of run_stereo_sequence, cut at its stages)."""
    cfg = PipelineConfig().with_metric(metric)
    check_supported(cfg)
    calib = Calib.from_projections(seq.P1, seq.P2)
    F = torch.as_tensor(F_from_P_host(seq.P1, seq.P2), dtype=torch.float32,
                        device=device)
    frontend = build_frontend(cfg)
    prepare = build_prepare(calib, F, cfg)
    solve = build_solve(calib, cfg)
    shape = (cfg.ransac.num_hypotheses, cfg.detector.num_slots)
    state = empty_state(cfg, device)

    def clock():
        sync(device)
        return time.perf_counter()

    rows = []
    for t, (im1, im2) in enumerate(seq.frames):
        t0 = clock()
        im1 = torch.tensor(np.asarray(im1), device=device)
        im2 = torch.tensor(np.asarray(im2), device=device)
        gumbel = sample_gumbel(shape, frame_generator(0, t)).to(device)
        feats = frontend(im1, im2)
        t1 = clock()
        state, si, _ = prepare(feats, state)
        t2 = clock()
        solve(si, gumbel)
        t3 = clock()
        rows.append((t1 - t0, t2 - t1, t3 - t2, t3 - t0))
    mean = np.mean(np.asarray(rows[2:]), axis=0) * 1e3
    return dict(zip(("front_end_ms", "match_ms", "solve_ms", "frame_ms"),
                    (float(x) for x in mean)))


def _busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, -np.inf
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def profile_frames(seq, metric, device, run=None):
    """torch.profiler over frames PROFILED of one run: the device busy
    share and per-frame counts, read from the exported trace.  ``run``
    replaces the run: it takes the per-frame callback (t, outputs)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    window = {}

    def on_frame(t, out):
        if t == PROFILED.start - 1:
            sync(device)
            prof.start()
            window["t0"] = time.perf_counter()
        elif t == PROFILED.stop - 1:
            sync(device)
            window["t1"] = time.perf_counter()
            prof.stop()

    if run is None:
        run_stereo_sequence(seq.frames, seq.P1, seq.P2,
                            PipelineConfig().with_metric(metric), seed=0,
                            device=device, on_frame=on_frame)
    else:
        run(on_frame)
    events = trace_events(prof)
    counts = device_counts(events)
    n = len(PROFILED)
    wall_us = 1e6 * (window["t1"] - window["t0"])
    device_ev = [e for e in events
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    kernels = [e for e in device_ev if e["cat"] == "kernel"]
    by_kernel = {}
    for e in kernels:
        c, us = by_kernel.get(e["name"], (0, 0.0))
        by_kernel[e["name"]] = (c + 1, us + e["dur"])
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:6]
    return {
        "frames": [PROFILED.start, PROFILED.stop - 1],
        "wall_ms_per_frame": wall_us / 1e3 / n,
        "device_busy_share": _busy_us(
            (e["ts"], e["ts"] + e["dur"]) for e in device_ev) / wall_us,
        **{f"{k}_per_frame": v / n for k, v in counts.items()},
        "top_kernels_ms_per_frame": [
            {"name": name[:80], "launches": c / n, "ms": us / 1e3 / n}
            for name, (c, us) in top],
    }


def serve_sequences():
    return [generate_sequence(**{**KITTI_SEQUENCE, "seed": s,
                                 "num_frames": n})
            for s, n in enumerate(SERVE_LENGTHS)]


def serve_run(seqs, backend, device, on_step=None, on_stage=None):
    return multistream.run_multistream(
        [sq.frames for sq in seqs], [sq.P1 for sq in seqs],
        [sq.P2 for sq in seqs], PipelineConfig().with_metric("l1"),
        device=device, backend=backend, on_step=on_step, on_stage=on_stage)


def serve_rate(seqs, backend, device):
    """Aggregate frames/s of one serving run: over all frames, and over
    timesteps 2..T-1 (from the end of timestep 1 to the end of the last)."""
    ends = []

    def on_step(t, outs):
        sync(device)
        ends.append(time.perf_counter())

    sync(device)
    t0 = time.perf_counter()
    res = serve_run(seqs, backend, device, on_step)
    active = [sum(t < n for n in SERVE_LENGTHS) for t in range(len(ends))]
    step_ms = [1e3 * (b - a) for a, b in zip(ends[1:], ends[2:])]
    return {"fps": sum(SERVE_LENGTHS) / (ends[-1] - t0),
            "fps_steps_2_on": sum(active[2:]) / (ends[-1] - ends[1]),
            "median_step_ms": statistics.median(step_ms),
            "solved": [int(r.frame_ok.sum()) for r in res]}


def serve_stage_times(seqs, backend, device):
    """Mean per-stage host times [ms] of the serving step over timesteps
    2..T-1, a sync after each stage (the stages of build_multistream_step,
    read through its on_stage hook; "front_end" includes the draws and the
    upload before it), with the calls of the solve per timestep, counted,
    and the live streams each such call solves."""
    marks = []
    calls = []
    build_solve = multistream.build_solve

    def counting_build_solve(calib, cfg):
        solve = build_solve(calib, cfg)

        def counted(si, gumbel):
            calls.append(len(gumbel))   # the batch's rows: live streams
            return solve(si, gumbel)

        return counted

    def on_stage(stage):
        sync(device)
        marks.append(time.perf_counter())

    sync(device)
    marks.append(time.perf_counter())
    multistream.build_solve = counting_build_solve
    try:
        serve_run(seqs, backend, device, on_stage=on_stage)
    finally:
        multistream.build_solve = build_solve
    rows = np.diff(np.asarray(marks)).reshape(-1, 4)[2:] * 1e3
    mean = list(rows.mean(axis=0)) + [rows.sum(axis=1).mean()]
    steps = len(marks) // 4
    return {**dict(zip(("front_end_ms", "match_ms", "correspondences_ms",
                        "solves_ms", "step_ms"), (float(x) for x in mean))),
            "solve_calls_per_step": len(calls) / steps,
            "live_streams_per_solve": float(np.mean(calls[2:]))}


def serve_main(args, device, result):
    seqs = serve_sequences()
    for backend in BACKENDS:   # warm-up
        serve_rate(seqs, backend, device)
    runs = {b: [] for b in BACKENDS}
    for r in range(args.repeats):
        for backend in BACKENDS[::1 if r % 2 == 0 else -1]:
            row = serve_rate(seqs, backend, device)
            runs[backend].append(row)
            print(f"[serve] round {r} {backend}: {json.dumps(row)}")
    for backend, rows in runs.items():
        print(f"[serve] {backend}: median "
              f"{statistics.median(x['fps'] for x in rows)} aggregate "
              f"frames/s over {len(rows)} runs")
    result["serve_rate"] = runs
    result["serve_stages"], result["serve_profile"] = {}, {}
    for backend in BACKENDS:
        st = serve_stage_times(seqs, backend, device)
        result["serve_stages"][backend] = st
        print(f"[serve-stages] {backend}: {json.dumps(st)}")
        pr = profile_frames(None, "l1", device, run=lambda cb, b=backend:
                            serve_run(seqs, b, device, on_step=cb))
        result["serve_profile"][backend] = pr
        print(f"[serve-profile] {backend}: {json.dumps(pr)}")


def mono_run(seq, metric, backend, device, on_frame=None):
    return mono.run_mono_sequence(
        [f[0] for f in seq.frames], seq.P1[:, :3],
        PipelineConfig.mono().with_metric(metric), seed=0, device=device,
        backend=backend, on_frame=on_frame)


def mono_rate(seq, metric, backend, device):
    """Frames/s of one mono run over frames 2..T-1."""
    ends = []

    def on_frame(t, out):
        sync(device)
        ends.append(time.perf_counter())

    res = mono_run(seq, metric, backend, device, on_frame)
    frame_ms = [1e3 * (b - a) for a, b in zip(ends[1:], ends[2:])]
    return {"fps": (len(ends) - 2) / (ends[-1] - ends[1]),
            "median_frame_ms": statistics.median(frame_ms),
            "solved": int(res.frame_ok.sum())}


def mono_stage_times(seq, metric, backend, device):
    """Mean per-stage host times [ms] of the mono step over frames 2..T-1,
    a sync after each stage (read through build_mono_step's on_stage hook;
    "front_end" includes the draws and the upload before it)."""
    marks = []

    def on_stage(stage):
        sync(device)
        marks.append(time.perf_counter())

    cfg = PipelineConfig.mono().with_metric(metric)
    step = mono.build_mono_step(seq.P1[:, :3], cfg, backend=backend,
                                on_stage=on_stage)
    n = cfg.detector.num_slots
    h1, h2 = mono.mono_hypotheses(mono.MonoConfig())
    state = mono.empty_mono_state(cfg, device)
    for t, (im, _) in enumerate(seq.frames):
        sync(device)
        marks.append(time.perf_counter())
        g1, g2 = mono.mono_draws(0, t, (h1, n), (h2, n))
        state, _ = step(state, torch.tensor(np.asarray(im), device=device),
                        (g1.to(device), g2.to(device)))
    rows = np.diff(np.asarray(marks).reshape(-1, 7), axis=1)[2:] * 1e3
    mean = list(rows.mean(axis=0)) + [rows.sum(axis=1).mean()]
    return {f"{k}_ms": float(x)
            for k, x in zip(MONO_STAGES + ("frame",), mean)}


def mono_main(args, device, result):
    seq = generate_sequence(**KITTI_SEQUENCE)
    names = [f"{m} {b}" for m, b in MONO_VARIANTS]
    for metric, backend in MONO_VARIANTS:   # warm-up
        mono_rate(seq, metric, backend, device)
    runs = {k: [] for k in names}
    for r in range(args.repeats):
        for name, (metric, backend) in list(zip(
                names, MONO_VARIANTS))[::1 if r % 2 == 0 else -1]:
            row = mono_rate(seq, metric, backend, device)
            runs[name].append(row)
            print(f"[mono] round {r} {name}: {json.dumps(row)}")
    for name, rows in runs.items():
        print(f"[mono] {name}: median "
              f"{statistics.median(x['fps'] for x in rows)} frames/s over "
              f"{len(rows)} runs")
    result["mono_rate"] = runs
    result["mono_stages"], result["mono_profile"] = {}, {}
    for metric, backend in (("l2", "dense"), ("l1", "fused")):
        name = f"{metric} {backend}"
        st = mono_stage_times(seq, metric, backend, device)
        result["mono_stages"][name] = st
        print(f"[mono-stages] {name}: {json.dumps(st)}")
        pr = profile_frames(None, metric, device, run=lambda cb, m=metric,
                            b=backend: mono_run(seq, m, b, device, cb))
        result["mono_profile"][name] = pr
        print(f"[mono-profile] {name}: {json.dumps(pr)}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=4,
                    help="rounds of the frame-rate comparison")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--serve", action="store_true",
                    help="measure multi-stream serving instead")
    ap.add_argument("--mono", action="store_true",
                    help="measure the monocular path instead")
    ap.add_argument("--out", help="also write the results here as JSON")
    args = ap.parse_args()
    device = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    result = {"torch": torch.__version__, "cpu_count": os.cpu_count(),
              "loadavg_at_start": os.getloadavg()}
    if device.type == "cuda":
        result["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        print(result["card"])
    if args.serve:
        serve_main(args, device, result)
        return finish(args, result)
    if args.mono:
        mono_main(args, device, result)
        return finish(args, result)
    seq = generate_sequence(**KITTI_SEQUENCE)

    for variant in VARIANTS:   # warm-up: kernel build, allocator, caches
        frame_rate(seq, variant, device)
    runs = {v: [] for v in VARIANTS}
    for r in range(args.repeats):
        for variant in VARIANTS[::1 if r % 2 == 0 else -1]:
            before = cuda_matching.launches
            row = frame_rate(seq, variant, device)
            row["kernel_launches"] = cuda_matching.launches - before
            runs[variant].append(row)
            print(f"[fps] round {r} {variant}: {json.dumps(row)}")
    result["frame_rate"] = runs
    for variant, rows in runs.items():
        print(f"[fps] {variant}: median {statistics.median(x['fps'] for x in rows)}"
              f" frames/s over {len(rows)} runs")

    result["stages"] = {}
    result["profile"] = {}
    for metric in ("l1", "l2"):
        result["stages"][metric] = stage_times(seq, metric, device)
        print(f"[stages] {metric}: {json.dumps(result['stages'][metric])}")
        result["profile"][metric] = profile_frames(seq, metric, device)
        print(f"[profile] {metric}: {json.dumps(result['profile'][metric])}")
    finish(args, result)


def finish(args, result):
    result["loadavg_at_end"] = os.getloadavg()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)


if __name__ == "__main__":
    main()
