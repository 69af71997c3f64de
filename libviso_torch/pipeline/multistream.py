"""Multi-stream stereo odometry: S independent sequences per step (port of
``libviso_tpu/pipeline/multistream.py``).

Where the JAX package vmaps the whole frame step over S streams, the port
writes the stream axis out: one front-end call on the (2, S, H, W) image
stack, one matcher call on the 3 S match problems with per-stream F (on
the card one kernel launch for all streams, whichever matcher backend),
triangulation and the circle filter over (S, N) tensors, and one RANSAC +
Gauss-Newton solve for all live streams (``solvers/ransac.py`` takes the
stream axis as a leading batch axis), all with per-stream calibration.

Semantics: stream s consumes the images, calibration and RANSAC draws of
its solo ``run_stereo_sequence`` (frame t draws from
``frame_generator(seed_s, t)``), and every batched stage computes each
stream's values with the per-element arithmetic of the solo step, so the
discrete per-frame stats equal the solo run's (tests/test_torch_
multistream.py; motions within 5e-6, poses within 5e-5, as the JAX
package's contract).  A stream that has run out of frames idles on its
last frame; it is left out of the solve and has no output.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from libviso_torch.config import Calib, PipelineConfig
from libviso_torch.geometry.mvg import F_from_P_host
from libviso_torch.ops.matching import match_frame_triple
from libviso_torch.pipeline.stereo import (
    FrameOutput,
    FrameState,
    History,
    SequenceResult,
    SolveInput,
    build_frontend,
    build_solve,
    check_supported,
    empty_state,
    gather_correspondences,
    hold_state_on_failure,
    match_layout,
    rebuild_state,
    resolve_device,
    sequence_result,
    state_from_leaves,
    state_leaves,
    state_to_leaves,
)
from libviso_torch.solvers.ransac import frame_generator, sample_gumbel


def stack_states(states) -> FrameState:
    """Stack per-stream FrameStates along a new leading axis."""
    return rebuild_state(states[0], (torch.stack(xs) for xs in zip(
        *(list(state_leaves(s)) for s in states))))


def stream_calib(calibs: Sequence[Calib], device) -> Calib:
    """The streams' calibrations as one Calib of (S,) float32 tensors, one
    value per stream (the layout of ``config.Calib``)."""
    def row(name):
        return torch.tensor([getattr(c, name) for c in calibs],
                            dtype=torch.float32, device=device)

    return Calib(f=row("f"), cu=row("cu"), cv=row("cv"), base=row("base"))


def build_multistream_step(cfg: PipelineConfig, backend: str = "dense",
                           on_stage: Optional[Callable[[str], None]] = None):
    """Build the S-stream frame step.

    ``on_stage``, if given, is called with the name of each stage as it
    ends: "front_end", "match", "correspondences", "solves" (the stage
    profile of ``tools/profile_torch_step.py --serve``).

    Returns:
      step(calibs, F, states, im1s, im2s, gumbels) -> (new_states, outs)
      where calibs is the list of S Calibs, F (S, 3, 3), states an
      S-stacked FrameState, im1s/im2s (S, H, W) and gumbels a list of S
      (num_hypotheses, num_slots) draws, None for a stream that idles
      this step.  All live streams are one batched solve; ``outs`` is
      the list of S FrameOutputs, each a row of that solve's output
      (None where the stream idled).
    """
    check_supported(cfg, backend)
    frontend = build_frontend(cfg)
    mark = on_stage or (lambda stage: None)

    def step(calibs, F, states, im1s, im2s, gumbels):
        S = len(gumbels)
        device = im1s.device
        feats = frontend(im1s, im2s)        # (2, S, H, W): one call
        mark("front_end")
        matches = match_frame_triple(        # 3 S problems: one call
            feats.kp1, feats.d1, feats.kp2, feats.d2, states.kp1,
            states.d1, states.kp2, states.d2, cfg.stereo_match,
            cfg.temporal_match, F, backend=backend,
            layout=match_layout(cfg, im1s.shape[-1]),
            image_width=im1s.shape[-1])
        mark("match")
        calib = stream_calib(calibs, device)
        new_states, si, _ = gather_correspondences(calib, feats, states,
                                                   *matches)
        mark("correspondences")
        live = [s for s, g in enumerate(gumbels) if g is not None]
        outs: list = [None] * S
        ok = torch.ones(S, dtype=torch.bool, device=device)
        if live:
            if len(live) < S:                # the solve's rows: live only
                rows = torch.tensor(live, device=device)
                si = SolveInput(*(x[rows] for x in si))
                calib = Calib(calib.f[rows], calib.cu[rows], calib.cv[rows],
                              calib.base[rows])
            out = build_solve(calib, cfg)(   # all live streams: one call
                si, torch.stack([gumbels[s] for s in live]))
            for i, s in enumerate(live):
                outs[s] = FrameOutput(*(x[i] for x in out))
            ok = out.ok if len(live) == S else ok.index_put((rows,), out.ok)
        if cfg.keep_features_on_failure:
            # an idle stream counts as solved: it has no next frame
            new_states = hold_state_on_failure(
                states, new_states, ok, states.kp1.valid.any(-1),
                cfg.max_keep_age)
        mark("solves")
        return new_states, outs

    return step


def build_multistream_chunk(cfg: PipelineConfig, chunk: int,
                            backend: str = "dense"):
    """S streams x K frames a call: the S-stream step over a stack of K
    timesteps, in order, with the states threaded through (the
    composition of ``pipeline/stereo.py::build_frame_chunk``).  The
    outputs equal K separate S-stream steps exactly.

    Returns:
      step(calibs, F, states, lefts, rights, gumbels) -> (new_states, outs)
      with lefts/rights (S, K, H, W), ``gumbels[s][k]`` stream s's draws
      for its k-th frame of the chunk (None where it idles) and
      ``outs[s][k]`` its FrameOutput (None where it idled).
    """
    step = build_multistream_step(cfg, backend)

    def chunk_step(calibs, F, states, lefts, rights, gumbels):
        if lefts.shape[1] != chunk or any(len(g) != chunk for g in gumbels):
            raise ValueError(f"chunk_step built for {chunk} frames")
        outs = [[] for _ in gumbels]
        for k in range(chunk):
            states, step_outs = step(calibs, F, states, lefts[:, k],
                                     rights[:, k], [g[k] for g in gumbels])
            for s, out in enumerate(step_outs):
                outs[s].append(out)
        return states, outs

    return chunk_step


def jit_multistream_sharded(mesh, cfg: PipelineConfig, chunk: int = 1,
                            backend: str = "dense", axis: str = "data"):
    """The S-stream step (``chunk`` > 1: the chunked step) with the stream
    axis split over the mesh's ``axis`` entries.  The name is the JAX
    package's; nothing is jitted: each entry advances its S/k streams with
    ``build_multistream_step`` (or ``build_multistream_chunk``) on its own
    device, and the new states and outputs are put back together in
    stream order, the states on the first entry's device.  Streams are
    independent, so nothing crosses a shard but the inputs and the results,
    and the batch-invariant solve (``solvers/gauss_newton.py``) makes
    each stream's result equal the unsharded step's bit for bit.

    Returns step(calibs, F, states, im1s, im2s, gumbels) with the
    signature of the unsharded step; S must be a multiple of the axis
    size.
    """
    devices = mesh.axis_devices(axis)
    k = len(devices)
    inner = (build_multistream_chunk(cfg, chunk, backend) if chunk > 1
             else build_multistream_step(cfg, backend))

    def step(calibs, F, states, im1s, im2s, gumbels):
        S = len(gumbels)
        if S % k:
            raise ValueError(f"{S} streams do not split over the {k} "
                             f"entries of mesh axis {axis!r}")
        n = S // k
        new_states, outs = [], []
        for i, dev in enumerate(devices):
            rows = slice(i * n, (i + 1) * n)

            def to(x):
                return None if x is None else x.to(dev)

            st, out = inner(
                calibs[rows], F[rows].to(dev),
                rebuild_state(states, (x[rows].to(dev)
                                       for x in state_leaves(states))),
                im1s[rows].to(dev), im2s[rows].to(dev),
                [[to(x) for x in g] if chunk > 1 else to(g)
                 for g in gumbels[rows]])
            new_states.append(st)
            outs.extend(out)
        home = devices[0]
        return rebuild_state(states, (
            torch.cat([x.to(home) for x in xs]) for xs in zip(
                *(list(state_leaves(st)) for st in new_states)))), outs

    return step


def _default_draws(cfg: PipelineConfig, seeds):
    shape = (cfg.ransac.num_hypotheses, cfg.detector.num_slots)
    return lambda s, t: sample_gumbel(shape, frame_generator(seeds[s], t))


def _upload(images, device):
    return torch.tensor(np.stack([np.asarray(x) for x in images]),
                        device=device)


class StreamPool:
    """Serving lifecycle driver: S fixed slots, each holding an independent
    sequence, advanced in lockstep by one step per timestep, with slot
    replacement: a finished slot is re-seeded with a new sequence (new
    calibration, seed and fresh state).

    Usage:
        pool = StreamPool(cfg, slots=4, device="cuda")
        pool.attach(0, frames_a, P1a, P2a, seed=7)
        pool.attach(1, frames_b, P1b, P2b, seed=9)
        while pool.active():
            pool.step()                       # one step, all slots
            for s in pool.finished():
                res = pool.detach(s)          # SequenceResult
                pool.attach(s, next_seq, ...) # immediate reuse

    Per-slot results keep the multistream contract (discrete stats equal
    to the solo run).  Empty slots idle on zero frames and finished ones on
    their last frame; neither is solved, and their outputs are dropped.
    """

    def __init__(self, cfg: PipelineConfig, slots: int, device="cuda",
                 backend: str = "dense",
                 draws: Optional[Callable[[int, int], torch.Tensor]] = None):
        self.cfg = cfg
        self.S = slots
        self.device = resolve_device(device)
        self._step = build_multistream_step(cfg, backend)
        self._states = stack_states(
            [empty_state(cfg, self.device) for _ in range(slots)])
        self._calibs = [Calib(0.0, 0.0, 0.0, 0.0)] * slots
        self._Fs = torch.zeros((slots, 3, 3), dtype=torch.float32,
                               device=self.device)
        self._seeds = [0] * slots
        self._draws = draws or _default_draws(cfg, self._seeds)
        self._frames = [None] * slots     # list of (imL, imR) or None
        self._cursor = [0] * slots        # next local frame index
        self._outs = [[] for _ in range(slots)]
        self._shape = None                # (H, W) pinned by the first attach

    def attach(self, slot: int, frames, P1, P2, seed: int = 0):
        """Seed ``slot`` with a new sequence: its state is reset to empty by
        a row write into the stacked state, in place."""
        frames = list(frames)
        if not frames:
            raise ValueError("attach needs at least one frame")
        shape = np.asarray(frames[0][0]).shape
        if self._shape is None:
            self._shape = shape
        elif shape != self._shape:
            raise ValueError(
                f"slot {slot}: frame shape {shape} != pool shape "
                f"{self._shape} (a pool serves one image shape; open a "
                "second pool for a second shape)")
        for row, empty in zip(
                state_leaves(self._states),
                state_leaves(empty_state(self.cfg, self.device))):
            row[slot] = empty                       # in place
        self._calibs[slot] = Calib.from_projections(P1, P2)
        self._Fs[slot] = torch.as_tensor(F_from_P_host(P1, P2),
                                         dtype=torch.float32)
        self._seeds[slot] = seed
        self._frames[slot] = frames
        self._cursor[slot] = 0
        self._outs[slot] = []

    def active(self):
        """Slots that still have frames to consume."""
        return [s for s in range(self.S)
                if self._frames[s] is not None
                and self._cursor[s] < len(self._frames[s])]

    def finished(self):
        """Attached slots whose sequence is fully consumed."""
        return [s for s in range(self.S)
                if self._frames[s] is not None
                and self._cursor[s] >= len(self._frames[s])]

    def step(self):
        """One lockstep step advancing every active slot by one frame."""
        if self._shape is None:
            raise RuntimeError("step() before any attach()")
        zeros = np.zeros(self._shape, np.uint8)
        lefts, rights, gumbels, live = [], [], [], []
        for s in range(self.S):
            fr = self._frames[s]
            if fr is None:
                lefts.append(zeros)
                rights.append(zeros)
                gumbels.append(None)
                continue
            t = min(self._cursor[s], len(fr) - 1)
            lefts.append(fr[t][0])
            rights.append(fr[t][1])
            if self._cursor[s] < len(fr):
                # draws by local frame index: a replacement stream draws
                # what its solo run draws
                gumbels.append(self._draws(s, t).to(self.device))
                live.append(s)
                self._cursor[s] += 1
            else:
                gumbels.append(None)
        self._states, outs = self._step(
            self._calibs, self._Fs, self._states,
            _upload(lefts, self.device), _upload(rights, self.device),
            gumbels)
        for s in live:
            self._outs[s].append(outs[s])

    def detach(self, slot: int) -> SequenceResult:
        """Finalize ``slot``: its SequenceResult; the slot is free for a new
        attach."""
        if self._frames[slot] is None:
            raise ValueError(f"slot {slot} is not attached")
        res = sequence_result(self._outs[slot])
        self._frames[slot] = None
        self._outs[slot] = []
        return res


def run_multistream(sequences: Sequence, P1s, P2s,
                    cfg: PipelineConfig = PipelineConfig(),
                    seeds: Sequence[int] | None = None, device="cuda",
                    backend: str = "dense", checkpoint=None,
                    draws: Optional[Callable[[int, int], torch.Tensor]] = None,
                    on_step=None, on_stage=None,
                    fingerprint_scope: str = "") -> List[SequenceResult]:
    """Drive S sequences in lockstep through the S-stream step.

    Args:
      sequences: per-stream frame lists ``[(imL, imR), ...]`` of one
        shared (H, W).  Streams may differ in length; a short stream idles
        on its last frame.
      P1s, P2s: per-stream 3x4 projection matrices.
      seeds: per-stream seeds (default 0..S-1): stream s draws frame t from
        ``frame_generator(seeds[s], t)``, as its solo run does.
      device: torch device; "cuda" without a card raises.
      backend: the matcher route, "dense", "fused" or "sweep".
      checkpoint: optional ``utils.checkpoint.CheckpointManager``, the
        resume discipline of ``run_stereo_sequence`` with the state of all
        S streams and every stream's motions, ok flags and stats in one
        snapshot; ``every`` counts lockstep timesteps.  Draws depend on
        (seed, t) only, so a resumed serving run is bit-exact.
      draws: optional callable (s, t) -> stream s's Gumbel draws for frame
        t (a test seam, the counterpart of ``run_stereo_sequence``'s).
      on_step: optional callback(t, outs) after each timestep.
      on_stage: optional callback(stage) at the end of each stage of the
        step (``build_multistream_step``).
      fingerprint_scope: names the input slice; the stream count and the
        seeds join it, so that a resume with another stream set is refused
        rather than misaligned.  Lengths stay out of it: resuming with the
        full frame lists after a cut run is the normal case.

    Returns:
      One SequenceResult per stream, of that stream's own length.
    """
    S = len(sequences)
    if len(P1s) != S or len(P2s) != S:
        raise ValueError(f"{S} sequences need {S} P1s and P2s")
    if S == 0:
        return []
    seeds = list(range(S)) if seeds is None else list(seeds)
    device = resolve_device(device)
    draws = draws or _default_draws(cfg, seeds)
    step = build_multistream_step(cfg, backend, on_stage)
    calibs = [Calib.from_projections(P1s[s], P2s[s]) for s in range(S)]
    F = torch.as_tensor(np.stack([F_from_P_host(P1s[s], P2s[s])
                                  for s in range(S)]),
                        dtype=torch.float32, device=device)
    lengths = [len(fr) for fr in sequences]
    T = max(lengths)
    states = stack_states([empty_state(cfg, device) for _ in range(S)])
    hists = [History() for _ in range(S)]
    t0 = 0
    fingerprint = None
    if checkpoint is not None:
        from libviso_torch.utils.checkpoint import (
            Checkpoint,
            config_fingerprint,
        )

        fingerprint = config_fingerprint(
            cfg, int(seeds[0]), backend,
            scope=(f"multistream:S={S}:seeds={list(map(int, seeds))}:"
                   f"{fingerprint_scope}"))
        ck = checkpoint.latest()
        if ck is not None:
            if ck.fingerprint != fingerprint:
                raise ValueError(
                    "checkpoint fingerprint mismatch: written with a "
                    f"different stream set / cfg ({ck.fingerprint} != "
                    f"{fingerprint})")
            states = state_from_leaves(ck.state_leaves, device)
            t0 = ck.next_frame
            for s in range(S):
                n = min(t0, lengths[s])
                hists[s] = History(ck.motions[:n, s], ck.oks[:n, s],
                                    [ck.stats[t][s] for t in range(n)])

    pending = [[] for _ in range(S)]   # per stream: (t, FrameOutput)

    def snapshot(next_frame):
        """All streams in one checkpoint: (next_frame, S, ...) arrays, rows
        past a stream's end zero (None among the stats)."""
        motions = np.zeros((next_frame, S, 6), np.float32)
        oks = np.zeros((next_frame, S), bool)
        stats = [[None] * S for _ in range(next_frame)]
        for s in range(S):
            hists[s].flush(pending[s])
            n = len(hists[s].motions)
            motions[:n, s] = hists[s].motions_array()
            oks[:n, s] = hists[s].oks
            for t in range(n):
                stats[t][s] = hists[s].stats[t]
        checkpoint.save(Checkpoint(
            next_frame=next_frame, motions=motions, oks=oks,
            state_leaves=state_to_leaves(states), stats=stats,
            fingerprint=fingerprint))

    for t in range(t0, T):
        frames = [sequences[s][min(t, lengths[s] - 1)] for s in range(S)]
        gumbels = [draws(s, t).to(device) if t < lengths[s] else None
                   for s in range(S)]
        states, step_outs = step(calibs, F, states,
                                 _upload([f[0] for f in frames], device),
                                 _upload([f[1] for f in frames], device),
                                 gumbels)
        for s in range(S):
            if t < lengths[s]:
                pending[s].append((t, step_outs[s]))
        if on_step is not None:
            on_step(t, step_outs)
        if checkpoint is not None and (t + 1) % checkpoint.every == 0:
            snapshot(t + 1)   # the only read-back inside the loop
    results = []
    for s in range(S):
        hists[s].flush(pending[s])
        results.append(hists[s].result(processed=max(0, lengths[s] - t0)))
    return results
