#!/usr/bin/env python3
"""Benchmark of the PyTorch port: stereo-VO frames/s on one CUDA card,
KITTI-sized workload.  The port's counterpart of ``bench.py``, with its
contract, modes and method.

  python3 bench_torch.py [--chunk=K] [--streams=S]
      [--metric=l1|l2|l2q8] [--backend=dense|fused|sweep]
      [--hyp=gn|procrustes] [--staged | --upload] [--window=N] [--reps=N]
      [--mono [--mono-8pt] [--mono-first-pass=8pt] [--mono-hyp=N]]
      [--profile] [--device=cuda]

Prints ONE JSON line on stdout, and nothing else there:
  {"metric": "stereo_vo_fps", "value": <frames/s>, "unit": "frames/s",
   "vs_baseline": <ratio>, "value_best_window": <frames/s>, "mode": ...}
The streaming and serving modes add ``value_best_window`` and ``mode``;
``--staged`` and ``--upload`` print the first four keys only; ``--mono``
prints ``mono_sfm_fps`` with the same keys as streaming.  The card's name
and power limit (as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` prints them) and the ``--profile`` report go to
stderr.

Workload: bench.py's synthetic KITTI-size sequence (1241x376, f =
718.856, base 0.5371657, 900 landmarks, 0.8 m a frame, seed 0), made by
``libviso_torch/synthetic.py``: n = max(window, min(reps, 60), 10, chunk)
frames for stereo, max(min(reps, 60), 10, chunk) for mono.  Full
detection (1280 slots), three 1280 x 1280 match problems and the RANSAC
+ Gauss-Newton solve a frame.

Modes (bench.py's, through the port's builders):
  default        chunked streaming, ``build_frame_chunk``, 4 frames a call
  --chunk=1      per-frame streaming, ``build_frame_step``
  --streams=S    serving: S streams a call (``build_multistream_step``, or
                 ``build_multistream_chunk`` for K = --chunk > 1 frames a
                 stream), stream s at a frame offset of 7 s, drawing as
                 its solo run with seed s
  --staged       the frame-batched odometry (``build_batched_odometry``)
                 on a window of --window frames staged once
  --upload       the same, the uint8 window uploaded again on every rep
  --mono         monocular SfM, ``build_mono_chunk`` with
                 ``PipelineConfig.mono()`` and the 5-point solver
                 (--mono-8pt: the 8-point; --mono-first-pass=8pt: the
                 8-point for the re-match gate's pass; --mono-hyp=N: N
                 hypotheses a pass)
  --profile      after the timed run, the per-kernel roofline report of
                 ``libviso_torch/utils/profiling.py`` (stderr)

Which CUDA kernels a mode reaches: ``--metric=l1`` with the ``dense``
route launches the L1 distance kernel (``csrc/l1_distance.cu``) once a
frame step, serving step or window call (twice a window call: its stereo
and its temporal problems), ``--metric=l1 --backend=fused`` the fused
gated matcher (``csrc/fused_two_min.cu``) and ``--metric=l1
--backend=sweep`` the order and sweep kernels (``csrc/sweep_order.cu``,
``csrc/fused_sweep.cu``).  The default metric l2 and ``l2q8`` run plain
PyTorch on every route they take (``fused`` and ``sweep`` need l1, and
the bench raises for them under another metric).  ``--mono`` keeps the
mono configuration's metric (l2), as bench.py does.

Method (bench.py's):
  - frames are uint8 tensors on the device, staged once before the clock;
  - every timed call's RANSAC draws are made before the clock and moved to
    the device: ``sample_gumbel(shape, frame_generator(seed, t))``, the
    draws of ``run_stereo_sequence`` (``mono_draws`` for mono; a window
    call's (T-1) rows from ``frame_generator(0, rep)``), at the indices
    bench.py folds into its key: 100 + w * reps + t for window w's t-th
    frame, grouped by call as bench.py groups them;
  - warm-up before the clock: three steps, or one chunk or window call;
    it builds the CUDA kernels, so the clock never counts a build;
  - five windows, each on the host clock and closed by
    ``torch.cuda.synchronize()``: ``value`` is the median window's
    frames/s and ``value_best_window`` the best; ``--staged`` and
    ``--upload`` time one run of ``reps`` calls.  ``vs_baseline`` is the
    rounded value over the baseline, rounded to 3 places.
A run without a card raises before it prints anything, and a kernel that
fails to build or launch fails the run: nothing falls back to the CPU or
to a kernel's plain version.  ``--device=cpu`` runs on the CPU when it
is asked for (the tests do), and then measures the CPU.

Baselines (measured on a CPU; bench.py's numbers):
  BASELINE_FPS = 5.29: the reference's C++ ``kitti`` binary on a
  KITTI-scale synthetic sequence, 0.189 s a frame
  (benchmarks/reference_baseline/README.md);
  MONO_BASELINE_FPS = 14.98: the reference's ``calib_sfm`` loop on the
  same frames, 0.0667 s a frame
  (benchmarks/reference_baseline/run_mono_baseline.py).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from libviso_torch.config import Calib, MonoConfig, PipelineConfig
from libviso_torch.geometry.mvg import F_from_P_host
from libviso_torch.pipeline.batched import build_batched_odometry
from libviso_torch.pipeline.mono import (
    build_mono_chunk,
    empty_mono_state,
    mono_draws,
    mono_hypotheses,
)
from libviso_torch.pipeline.multistream import (
    _default_draws,
    build_multistream_chunk,
    build_multistream_step,
    stack_states,
)
from libviso_torch.pipeline.stereo import (
    build_frame_chunk,
    build_frame_step,
    check_supported,
    empty_state,
    resolve_device,
)
from libviso_torch.solvers.ransac import frame_generator, sample_gumbel
from libviso_torch.synthetic import generate_sequence

BASELINE_FPS = 5.29        # measured: benchmarks/reference_baseline/README.md
MONO_BASELINE_FPS = 14.98  # measured: run_mono_baseline.py (calib_sfm)
WINDOWS = 5                # timed windows; value is the median
WARMUP_STEPS = 3           # per-frame and serving warm-up calls
# bench.py's KITTI-size synthetic sequence, less its length
SEQUENCE = dict(num_points=900, seed=0, width=1241, height=376, f=718.856,
                base=0.5371657, speed=0.8)
MONO_K = np.array([[718.856, 0.0, 620.5], [0.0, 718.856, 188.0],
                   [0.0, 0.0, 1.0]])


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="bench_torch.py", allow_abbrev=False,
        description="Frames/s of the PyTorch port on one CUDA card; one "
                    "JSON line on stdout.")
    ap.add_argument("--metric", default="l2", choices=("l1", "l2", "l2q8"))
    ap.add_argument("--backend", default="dense",
                    choices=("dense", "fused", "sweep"))
    ap.add_argument("--hyp", default=None, choices=("gn", "procrustes"))
    ap.add_argument("--window", type=int, default=8)
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--chunk", type=int, default=4)
    ap.add_argument("--streams", type=int, default=1)
    ap.add_argument("--staged", action="store_true")
    ap.add_argument("--upload", action="store_true")
    ap.add_argument("--mono", action="store_true")
    ap.add_argument("--mono-8pt", action="store_true")
    ap.add_argument("--mono-first-pass", default=None)
    ap.add_argument("--mono-hyp", type=int, default=0)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def kitti_sequence(num_frames: int):
    return generate_sequence(num_frames=num_frames, **SEQUENCE)


def stereo_config(metric: str = "l2", hyp=None) -> PipelineConfig:
    """The default pipeline under ``metric``; ``hyp`` replaces the RANSAC
    hypothesis estimator when given."""
    cfg = PipelineConfig().with_metric(metric)
    if hyp is not None:
        cfg = dataclasses.replace(cfg, ransac=dataclasses.replace(
            cfg.ransac, hypothesis_method=hyp))
    return cfg


def mono_config() -> PipelineConfig:
    return PipelineConfig.mono()


def frame_draws(cfg: PipelineConfig, seed: int = 0):
    """t -> frame t's RANSAC draw, as ``run_stereo_sequence`` makes it."""
    shape = (cfg.ransac.num_hypotheses, cfg.detector.num_slots)
    return lambda t: sample_gumbel(shape, frame_generator(seed, t))


def stage_frames(frames, device):
    """Stereo pairs as uint8 tensors on ``device`` (bench.py's
    ``jnp.asarray(l.astype(np.uint8))``)."""
    return [tuple(torch.tensor(np.asarray(im).astype(np.uint8),
                               device=device) for im in pair)
            for pair in frames]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed_windows(device, window):
    """Frames/s of each of the WINDOWS windows: ``window(w)`` queues window
    w's calls and returns its frame count; the host clock stops after a
    synchronize."""
    rates = []
    for w in range(WINDOWS):
        t0 = time.perf_counter()
        n = window(w)
        _sync(device)
        rates.append(n / (time.perf_counter() - t0))
    return rates


def _ignore(out):
    pass


def streaming_rates(seq, cfg, reps, chunk, backend="dense", device="cuda",
                    draws=None, on_output=None):
    """Frames/s of each window of streaming (bench.py:315-383): ``chunk``
    > 1 frames a call of ``build_frame_chunk``, window w's g-th call on
    frame group g and the draws of frames 100 + w reps + g chunk + i;
    ``chunk`` 1: ``reps`` calls of ``build_frame_step`` a window, frame t
    mod n with draw 100 + w reps + t.  ``draws(t)`` replaces the draw of
    index t (a test seam); ``on_output`` sees every call's output in
    order, warm-up first."""
    device = resolve_device(device)
    draws = draws or frame_draws(cfg)
    emit = on_output or _ignore
    calib = Calib.from_projections(seq.P1, seq.P2)
    F = torch.tensor(F_from_P_host(seq.P1, seq.P2), dtype=torch.float32,
                     device=device)
    frames = stage_frames(seq.frames, device)
    state = empty_state(cfg, device)
    if chunk > 1:
        step = build_frame_chunk(calib, F, cfg, chunk, backend=backend)
        n_groups = len(frames) // chunk
        per_window = max(1, reps // chunk)
        groups = [tuple(torch.stack([frames[g * chunk + i][c]
                                     for i in range(chunk)]) for c in (0, 1))
                  for g in range(n_groups)]

        def draw_stack(base):
            return torch.stack([draws(base + i)
                                for i in range(chunk)]).to(device)

        staged = [draw_stack(100 + w * reps + g * chunk)
                  for w in range(WINDOWS) for g in range(per_window)]
        state, out = step(state, *groups[0], draw_stack(0))
        emit(out)
        _sync(device)

        def window(w):
            nonlocal state
            for g in range(per_window):
                state, out = step(state, *groups[g % n_groups],
                                  staged[w * per_window + g])
                emit(out)
            return per_window * chunk
    else:
        step = build_frame_step(calib, F, cfg, backend=backend)
        staged = [draws(100 + w * reps + t).to(device)
                  for w in range(WINDOWS) for t in range(reps)]
        for t in range(WARMUP_STEPS):
            state, out = step(state, *frames[t], draws(t).to(device))
            emit(out)
        _sync(device)

        def window(w):
            nonlocal state
            for t in range(reps):
                state, out = step(state, *frames[t % len(frames)],
                                  staged[w * reps + t])
                emit(out)
            return reps

    return _timed_windows(device, window)


def serving_rates(seq, cfg, reps, chunk, streams, backend="dense",
                  device="cuda", draws=None, on_output=None):
    """Aggregate frames/s of each window of serving (bench.py:244-314):
    S = ``streams`` streams, K = max(1, ``chunk``) frames a stream a call
    (``build_multistream_step`` for K = 1, else
    ``build_multistream_chunk``).  Stream s reads frame (t + i + 7 s) mod n
    of the one sequence and draws as its solo run with seed s
    (``draws(s, t)``, the test seam); up to 16 image stacks are staged,
    call g of a window takes stack g mod 16 and the draws of index 100 +
    (w d + g) K + i, d = max(1, reps // K) calls a window.  ``on_output``
    sees every call's per-stream outputs."""
    device = resolve_device(device)
    S, K = streams, max(1, chunk)
    draws = draws or _default_draws(cfg, list(range(S)))
    emit = on_output or _ignore
    step = (build_multistream_chunk(cfg, K, backend=backend) if K > 1
            else build_multistream_step(cfg, backend=backend))
    calibs = [Calib.from_projections(seq.P1, seq.P2)] * S
    F = torch.tensor(np.tile(F_from_P_host(seq.P1, seq.P2)[None], (S, 1, 1)),
                     dtype=torch.float32, device=device)
    frames = stage_frames(seq.frames, device)
    n = len(frames)

    def images_at(t):   # (S, H, W) or (S, K, H, W) left and right stacks
        if K == 1:
            return tuple(torch.stack([frames[(t + 7 * s) % n][c]
                                      for s in range(S)]) for c in (0, 1))
        return tuple(torch.stack([torch.stack(
            [frames[(t + i + 7 * s) % n][c] for i in range(K)])
            for s in range(S)]) for c in (0, 1))

    def draws_at(t):    # S draws, or S lists of K
        if K == 1:
            return [draws(s, t).to(device) for s in range(S)]
        return [[draws(s, t + i).to(device) for i in range(K)]
                for s in range(S)]

    stacks = [images_at(t * K) for t in range(min(n, 16))]
    per_window = max(1, reps // K)
    staged = [draws_at(100 + (w * per_window + g) * K)
              for w in range(WINDOWS) for g in range(per_window)]
    states = stack_states([empty_state(cfg, device) for _ in range(S)])
    for t in range(WARMUP_STEPS):
        states, outs = step(calibs, F, states, *stacks[t % len(stacks)],
                            draws_at(t * K))
        emit(outs)
    _sync(device)

    def window(w):
        nonlocal states
        for g in range(per_window):
            states, outs = step(calibs, F, states, *stacks[g % len(stacks)],
                                staged[w * per_window + g])
            emit(outs)
        return per_window * S * K

    return _timed_windows(device, window)


def window_rate(seq, cfg, reps, window, backend="dense", device="cuda",
                upload=False, draws=None, on_output=None):
    """Frames/s of ``reps`` calls of the frame-batched odometry on the
    first T = min(window, n) frames (bench.py:384-423), timed as one run
    after one warm-up call.  Rep r draws its T-1 transitions from
    ``frame_generator(0, r)`` (``draws(r)``, the test seam; the warm-up
    call takes rep 0's).  ``upload`` makes a new device copy of the uint8
    window from the host on every rep."""
    device = resolve_device(device)
    T = min(window, len(seq.frames))
    shape = (T - 1, cfg.ransac.num_hypotheses, cfg.detector.num_slots)
    draws = draws or (lambda r: sample_gumbel(shape, frame_generator(0, r)))
    emit = on_output or _ignore
    fn = build_batched_odometry(
        Calib.from_projections(seq.P1, seq.P2),
        torch.tensor(F_from_P_host(seq.P1, seq.P2), dtype=torch.float32,
                     device=device), cfg, backend=backend)
    host = [np.stack([np.asarray(f[c]) for f in seq.frames[:T]]).astype(
        np.uint8) for c in (0, 1)]
    left, right = (torch.tensor(x, device=device) for x in host)
    staged = [draws(r).to(device) for r in range(reps)]
    emit(fn(left, right, staged[0]))
    _sync(device)
    t0 = time.perf_counter()
    for r in range(reps):
        if upload:
            left, right = (torch.tensor(x, device=device) for x in host)
        emit(fn(left, right, staged[r]))
    _sync(device)
    return reps * T / (time.perf_counter() - t0)


def mono_rates(frames, K, cfg, mono, reps, chunk, backend="dense",
               device="cuda", draws=None, on_output=None):
    """Frames/s of each window of mono streaming (bench.py:104-169):
    ``chunk`` frames a call of ``build_mono_chunk``, window w's g-th call
    on frame group g with the draws of frames 100 + w reps + g chunk + i
    (``mono_draws(0, t, ...)``; ``draws(t)`` the test seam)."""
    device = resolve_device(device)
    h1, h2 = mono_hypotheses(mono)
    n = cfg.detector.num_slots
    draws = draws or (lambda t: mono_draws(0, t, (h1, n), (h2, n)))
    emit = on_output or _ignore
    step = build_mono_chunk(K, cfg, chunk, mono=mono, backend=backend)
    ims = [torch.tensor(np.asarray(im).astype(np.uint8), device=device)
           for im in frames]
    n_groups = len(ims) // chunk
    per_window = max(1, reps // chunk)
    stacks = [torch.stack(ims[g * chunk:(g + 1) * chunk])
              for g in range(n_groups)]

    def draw_group(base):
        return [tuple(x.to(device) for x in draws(base + i))
                for i in range(chunk)]

    staged = [draw_group(100 + w * reps + g * chunk)
              for w in range(WINDOWS) for g in range(per_window)]
    state = empty_mono_state(cfg, device)
    state, out = step(state, stacks[0], draw_group(0))
    emit(out)
    _sync(device)

    def window(w):
        nonlocal state
        for g in range(per_window):
            state, out = step(state, stacks[g % n_groups],
                              staged[w * per_window + g])
            emit(out)
        return per_window * chunk

    return _timed_windows(device, window)


def result_line(metric, fps, baseline, best=None, mode=None) -> dict:
    """bench.py's JSON line: ``best`` and ``mode`` add
    ``value_best_window`` and ``mode``."""
    value = round(fps, 3)
    line = {"metric": metric, "value": value, "unit": "frames/s",
            "vs_baseline": round(value / baseline, 3)}
    if mode is not None:
        line["value_best_window"] = round(best, 3)
        line["mode"] = mode
    return line


def mono_mode(method, chunk, first_pass=None, hyp=0) -> str:
    return (f"mono_{method}_chunk{chunk}"
            + (f"_fp{first_pass}" if first_pass else "")
            + (f"_h{hyp}" if hyp else ""))


def stereo_mode(chunk, streams) -> str:
    if streams > 1:
        return f"serving_streams{streams}_chunk{chunk}"
    return f"streaming_chunk{chunk}" if chunk > 1 else "streaming_per_frame"


def run_mono(args, device) -> dict:
    method = "8pt" if args.mono_8pt else "5pt"
    mono = MonoConfig(method=method,
                      **({"first_pass": args.mono_first_pass}
                         if args.mono_first_pass else {}),
                      **({"num_hypotheses": args.mono_hyp}
                         if args.mono_hyp else {}))
    cfg = mono_config()
    n_frames = max(min(args.reps, 60), 10, args.chunk)
    seq = kitti_sequence(n_frames)
    rates = mono_rates([f[0] for f in seq.frames], MONO_K, cfg, mono,
                       args.reps, args.chunk, backend=args.backend,
                       device=device)
    return result_line("mono_sfm_fps", statistics.median(rates),
                       MONO_BASELINE_FPS, max(rates),
                       mono_mode(method, args.chunk, args.mono_first_pass,
                                 args.mono_hyp))


def run_stereo(args, device) -> dict:
    cfg = stereo_config(args.metric, args.hyp)
    check_supported(cfg, args.backend)
    n_frames = max(args.window, min(args.reps, 60), 10, args.chunk)
    seq = kitti_sequence(n_frames)
    if not (args.staged or args.upload):
        if args.streams > 1:
            rates = serving_rates(seq, cfg, args.reps, args.chunk,
                                  args.streams, backend=args.backend,
                                  device=device)
        else:
            rates = streaming_rates(seq, cfg, args.reps, args.chunk,
                                    backend=args.backend, device=device)
        line = result_line("stereo_vo_fps", statistics.median(rates),
                           BASELINE_FPS, max(rates),
                           stereo_mode(args.chunk, args.streams))
    else:
        line = result_line("stereo_vo_fps", window_rate(
            seq, cfg, args.reps, args.window, backend=args.backend,
            device=device, upload=not args.staged), BASELINE_FPS)
    if args.profile:
        profile_report(cfg, args.metric, args.reps, device)
    return line


def profile_report(cfg, metric, reps, device):
    """bench.py's ``--profile``: the device's peaks, then the matcher, the
    RANSAC + GN solve and the frame step (``utils/profiling.py``), each a
    line on stderr."""
    from libviso_torch.utils.profiling import (
        device_peaks,
        profile_frame_step,
        profile_matcher,
        profile_solver,
    )

    peak_f, peak_b = device_peaks(device)
    print(f"device: {device_name(device)} "
          f"peak={peak_f and peak_f / 1e12} TFLOP/s "
          f"bw={peak_b and peak_b / 1e9} GB/s", file=sys.stderr)
    n = cfg.detector.num_slots
    d = cfg.detector.descriptor_dim_padded
    for st in (
        profile_matcher(n, n, d, metric=metric, backend="kernel",
                        reps=min(reps, 8), device=device),
        profile_solver(cfg.ransac.num_hypotheses, cfg.ransac.gn_iters, n,
                       reps=min(reps, 8), device=device),
        profile_frame_step(cfg, reps=5, device=device),
    ):
        print(st.pretty(), file=sys.stderr)


def device_name(device) -> str:
    """The card's name and power limit as nvidia-smi prints them (the
    first card's, as the smoke reads it); the device's name where there
    is no nvidia-smi, and "cpu" for the CPU."""
    if device.type != "cuda":
        return "cpu"
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        smi = []
    return smi[0] if smi else (f"{torch.cuda.get_device_name(device)}, "
                               "power limit not read")


def main(argv=None) -> dict:
    """Run the mode ``argv`` asks for; print its JSON line on stdout and
    return it."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    print(f"device: {device_name(device)}", file=sys.stderr)
    line = run_mono(args, device) if args.mono else run_stereo(args, device)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
