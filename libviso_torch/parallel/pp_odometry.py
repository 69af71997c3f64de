"""Staged (pipeline-parallel) stereo odometry (port of
``libviso_tpu/parallel/pp_odometry.py``).

The per-frame step splits at the ``SolveInput`` seam into two stages:

  stage 0 (prepare): detection, descriptors, the three match problems,
      triangulation and the circle filter of frame t; it owns the
      previous frame's FrameState;
  stage 1 (solve): the RANSAC + Gauss-Newton pose of frame t-1.

Stage 0 runs on the ``pipe`` entry 0's device, stage 1 on entry 1's; the
SolveInput (a few tens of KB) moves between them with
``.to(device, non_blocking=True)``.  Where both entries are one card, each
stage gets its own CUDA stream and the SolveInput is handed across with an
event and ``record_stream``: the overlap the JAX package gets from two
chips, tried on one.  Ops are the serial step's, on the same inputs, so
both drivers equal ``pipeline/stereo.py::run_stereo_sequence`` bit for bit
on the same per-frame draws (frame t draws from ``frame_generator(seed,
t)``, or ``draws(t)``).

Two drivers: ``run_pipelined_odometry`` (T + 1 ticks over a recorded
sequence; tick k prepares frame k and solves frame k-1, tick 0 solves the
all-invalid bubble and drops it) and ``StreamPipeline`` (live frames,
pushed one at a time).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import numpy as np
import torch

from libviso_torch.config import Calib, PipelineConfig
from libviso_torch.geometry.mvg import F_from_P_host
from libviso_torch.geometry.se3 import chain_motions, pose_vector_to_matrix
from libviso_torch.parallel.mesh import default_devices
from libviso_torch.pipeline.stereo import (
    FrameOutput,
    SolveInput,
    build_frontend,
    build_prepare,
    build_solve,
    check_supported,
    empty_state,
    zero_solve_input,
)
from libviso_torch.solvers.ransac import frame_generator, sample_gumbel

NUM_STAGES = 2


def _reject_keep_on_failure(cfg: PipelineConfig):
    if cfg.keep_features_on_failure:
        # prepare(k+1) runs before or beside solve(k) across the stage
        # seam, so the hold decision (which needs solve(k)'s ok) cannot
        # exist here
        raise ValueError(
            "keep_features_on_failure is a streaming-step feature; the "
            "prepare|solve pipeline stages cannot condition frame k+1's "
            "match target on frame k's solve outcome")


def _default_draws(cfg: PipelineConfig, seed: int):
    shape = (cfg.ransac.num_hypotheses, cfg.detector.num_slots)
    return lambda t: sample_gumbel(shape, frame_generator(seed, t))


class _Stages:
    """The two stages on their devices and, on a card, their own CUDA
    streams."""

    def __init__(self, calib: Calib, F_host, cfg: PipelineConfig, devices,
                 backend: str):
        check_supported(cfg, backend)
        _reject_keep_on_failure(cfg)
        self.cfg, self.backend = cfg, backend
        self.d_prep, self.d_solve = (torch.device(d) for d in devices)
        self.calib = calib
        self.F = torch.as_tensor(F_host, dtype=torch.float32,
                                 device=self.d_prep)
        self.frontend = build_frontend(cfg)
        self.solve_fn = build_solve(calib, cfg)
        self.prepares = {}   # one prepare per image width
        cuda = self.d_prep.type == "cuda" and self.d_solve.type == "cuda"
        self.streams = ((torch.cuda.Stream(self.d_prep),
                         torch.cuda.Stream(self.d_solve)) if cuda
                        else None)

    def _on(self, i):
        """The stage's stream context (a no-op on the CPU)."""
        if self.streams is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.streams[i])

    def _upload(self, x, device, stage):
        """x on ``device`` for stage ``stage``: a host array or tensor
        through pinned memory on the stage's stream; a card tensor in the
        order of the stream that made it."""
        x = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
        if device.type != "cuda":
            return x.to(device)
        if x.device.type == "cpu":
            with self._on(stage):
                return x.pin_memory().to(device, non_blocking=True)
        x = x.to(device)   # a copy between cards follows both streams
        if self.streams is not None:
            # the stage's stream waits for the maker's, and the maker's
            # allocator keeps the memory until the stage has read it
            self.streams[stage].wait_stream(torch.cuda.current_stream(device))
            x.record_stream(self.streams[stage])
        return x

    def empty_state(self):
        return empty_state(self.cfg, self.d_prep)

    def bubble(self):
        return zero_solve_input(self.cfg, self.d_solve)

    def prepare(self, state, im1, im2):
        """Stage 0 on frame (im1, im2): (new_state, SolveInput on the solve
        device, handed across)."""
        im1 = self._upload(im1, self.d_prep, 0)
        im2 = self._upload(im2, self.d_prep, 0)
        with self._on(0):
            width = im1.shape[-1]
            if width not in self.prepares:
                self.prepares[width] = build_prepare(
                    self.calib, self.F, self.cfg, backend=self.backend,
                    image_width=width)
            new_state, si, _ = self.prepares[width](
                self.frontend(im1, im2), state)
        if self.streams is None:
            return new_state, SolveInput(*(x.to(self.d_solve) for x in si))
        ready = torch.cuda.Event()
        ready.record(self.streams[0])
        self.streams[1].wait_event(ready)
        with self._on(1):
            moved = SolveInput(*(x.to(self.d_solve, non_blocking=True)
                                 for x in si))
        for x in moved:
            # the solve stream reads it: keep its memory from the prepare
            # stream's reuse until that read is done
            x.record_stream(self.streams[1])
        return new_state, moved

    def solve(self, si, gumbel):
        """Stage 1: the FrameOutput of ``si``, readable on the current
        stream."""
        gumbel = self._upload(gumbel, self.d_solve, 1)
        with self._on(1):
            out = self.solve_fn(si, gumbel)
        if self.streams is not None:
            current = torch.cuda.current_stream(self.d_solve)
            current.wait_stream(self.streams[1])
            for x in out:
                x.record_stream(current)
        return out


def build_pipelined_program(calib: Calib, F, cfg: PipelineConfig, mesh,
                            backend: str = "dense"):
    """program(ims1 (T, H, W), ims2, draws) -> FrameOutput stacked over
    the T frames, over the mesh's 2-entry ``pipe`` axis.  ``F`` is the
    (3, 3) fundamental matrix (host values); ``draws(t)`` frame t's
    (num_hypotheses, num_slots) Gumbel scores.  Row t is frame t's
    result; row 0 is the first frame, never ok in a sequence's result.
    """
    if mesh.shape.get("pipe") != NUM_STAGES:
        raise ValueError(
            f"pipe axis must have {NUM_STAGES} devices (got "
            f"{mesh.shape.get('pipe')}): the VO step splits into prepare "
            "and solve stages")
    stages = _Stages(calib, np.asarray(F), cfg, mesh.axis_devices("pipe"),
                     backend)

    def program(ims1, ims2, draws):
        T = len(ims1)
        state = stages.empty_state()
        pending = stages.bubble()
        outs = []
        for k in range(T + 1):
            # solve frame k-1 first, so that it overlaps frame k's prepare;
            # tick 0 solves the bubble, whose output is dropped
            out = stages.solve(pending, draws(max(k - 1, 0)))
            if k:
                outs.append(out)
            if k < T:
                state, pending = stages.prepare(state, ims1[k], ims2[k])
        return FrameOutput(*(torch.stack(xs) for xs in zip(*outs)))

    return program


def _assemble(outs):
    motions = outs.tr.cpu().numpy()
    ok = outs.ok.cpu().numpy().copy()
    if len(ok):
        ok[0] = False   # the reference skips the first frame
    poses = chain_motions(pose_vector_to_matrix(torch.from_numpy(motions)),
                          torch.from_numpy(ok)).numpy()
    return poses, motions, ok


def run_pipelined_odometry(mesh, P1, P2, frames_left, frames_right,
                           cfg: PipelineConfig = PipelineConfig(),
                           seed: int = 0, backend: str = "dense",
                           draws: Optional[Callable[[int], torch.Tensor]]
                           = None):
    """Staged odometry over a ('pipe',) mesh of 2 entries.

    Args:
      mesh: ``parallel/mesh.py::make_pipe_mesh``'s mesh.
      P1, P2: 3x4 rectified projections.
      frames_left/right: (T, H, W) image stacks.
      draws: optional t -> frame t's Gumbel scores (a test seam); by
        default ``frame_generator(seed, t)``, as ``run_stereo_sequence``.

    Returns (poses (T, 4, 4), motions (T, 6), ok (T,)) as numpy arrays,
    equal to ``run_stereo_sequence``'s on the same inputs.
    """
    calib = Calib.from_projections(P1, P2)
    program = build_pipelined_program(calib, F_from_P_host(P1, P2), cfg,
                                      mesh, backend=backend)
    return _assemble(program(frames_left, frames_right,
                             draws or _default_draws(cfg, seed)))


class StreamPipeline:
    """Live-stream staged odometry: frames are pushed one at a time (they
    need not exist in advance, the case chunked odometry cannot serve).
    ``push(im1, im2)`` queues frame t-1's solve and then frame t's
    prepare, so the two overlap; outputs come back one frame late and
    equal the serial run's.

    Usage::

        sp = StreamPipeline(P1, P2, cfg, devices=["cuda:0", "cuda:1"])
        for im1, im2 in camera:
            out = sp.push(im1, im2)    # FrameOutput of the PREVIOUS frame
        out_last = sp.flush()

    ``devices`` defaults to the first two cards and raises below two
    entries; one card may be named twice.
    """

    def __init__(self, P1, P2, cfg: PipelineConfig = PipelineConfig(),
                 devices=None, seed: int = 0, backend: str = "dense",
                 draws: Optional[Callable[[int], torch.Tensor]] = None):
        if devices is None:
            devices = default_devices()[:2]
        if len(devices) < 2:
            raise ValueError("StreamPipeline needs 2 devices (a device "
                             "may be named twice)")
        self._stages = _Stages(Calib.from_projections(P1, P2),
                               F_from_P_host(P1, P2), cfg, devices[:2],
                               backend)
        self._draws = draws or _default_draws(cfg, seed)
        self._state = self._stages.empty_state()
        self._pending = None   # SolveInput of the last prepared frame
        self._t = 0

    def push(self, im1, im2):
        """Feed frame t; returns frame t-1's FrameOutput (None at t=0)."""
        out = self.flush()
        self._state, self._pending = self._stages.prepare(self._state, im1,
                                                          im2)
        self._t += 1
        return out

    def flush(self):
        """Solve the frame in flight (None if there is none)."""
        if self._pending is None:
            return None
        out = self._stages.solve(self._pending, self._draws(self._t - 1))
        self._pending = None
        return out
