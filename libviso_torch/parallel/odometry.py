"""Sequence-sharded stereo odometry (port of
``libviso_tpu/parallel/odometry.py``).

The only sequential dependency of stereo VO is the previous frame's
features, a 1-frame halo.  So the sequence splits into chunks that overlap
by one frame, each chunk runs the frame-batched odometry
(``pipeline/batched.py``) on its ``data`` entry's device, and the chunks'
motions are gathered to the first device and chained into one
trajectory.  Where the JAX package compiles this into one program over
the mesh, the port launches each chunk's work on its device from one host
loop; on several cards the launches overlap, on one card (a mesh naming
it more than once) the chunks run in turn.

Draws: chunk c's (L - 1, H, N) RANSAC draws come from
``frame_generator(seed, c)``; ``draws(c, n)`` replaces them (a test seam,
through which the JAX package's chunk draws are injected,
``tools/threefry.py::chunk_gumbel``).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from libviso_torch.config import Calib, PipelineConfig
from libviso_torch.geometry.mvg import F_from_P_host
from libviso_torch.geometry.se3 import chain_motions, pose_vector_to_matrix
from libviso_torch.parallel.distributed import (
    all_gather_host,
    process_count,
    process_index,
)
from libviso_torch.solvers.ransac import frame_generator, sample_gumbel


def _pad_chunk(frames, lo, L):
    """``frames[lo: lo + L]`` padded to exactly L frames by repeating the
    last one (a chunk starting at or past the final frame repeats the
    final frame; such chunks have n_valid 0 and are masked out when
    stitching)."""
    frames = np.asarray(frames)
    lo = min(max(lo, 0), max(frames.shape[0] - 1, 0))
    chunk = frames[lo: lo + L]
    pad = L - chunk.shape[0]
    if pad > 0:
        chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, 0)])
    return chunk


def chunk_frames_with_halo(frames_left, frames_right, n_chunks):
    """Split (T, H, W) image stacks into overlapping chunks.

    Chunk b covers global frames [b (L-1), b (L-1) + L - 1] with
    L = ceil((T - 1) / n_chunks) + 1: consecutive chunks share one frame,
    so every frame transition lies inside exactly one chunk.  The tail is
    padded by repeating the last frame.

    Returns (left (B, L, H, W), right (B, L, H, W), n_valid_motions (B,)).
    """
    frames_left = np.asarray(frames_left)
    frames_right = np.asarray(frames_right)
    steps = frames_left.shape[0] - 1
    per = -(-steps // n_chunks)   # ceil
    L = per + 1
    lefts, rights, nvalid = [], [], []
    for b in range(n_chunks):
        s = b * per
        lefts.append(_pad_chunk(frames_left, s, L))
        rights.append(_pad_chunk(frames_right, s, L))
        nvalid.append(max(0, min(steps - s, per)))
    return (np.stack(lefts), np.stack(rights),
            np.asarray(nvalid, np.int32))


def host_chunk_assignment(total_frames: int, n_chunks: int,
                          process_index: int, process_count: int):
    """Chunk-aligned frame plan of one process in a multi-process run.

    The sequence splits into ``n_chunks`` chunks as in
    ``chunk_frames_with_halo``; process p owns a contiguous block of
    ``n_chunks / process_count`` chunks and loads only the frames they
    cover.  Returns a dict: frame_start / frame_stop (the [start, stop)
    global frames to load), chunk_starts (global start frame of each owned
    chunk), L (frames a chunk) and n_valid (valid motions of each owned
    chunk).
    """
    if n_chunks % process_count != 0:
        raise ValueError(f"n_chunks={n_chunks} not divisible by "
                         f"process_count={process_count}")
    steps = total_frames - 1
    per = -(-steps // n_chunks)   # ceil
    L = per + 1
    cpp = n_chunks // process_count
    first = process_index * cpp
    chunk_starts = [(first + b) * per for b in range(cpp)]
    frame_start = min(chunk_starts[0], max(total_frames - 1, 0))
    frame_stop = min(chunk_starts[-1] + L, total_frames)
    n_valid = [max(0, min(steps - s, per)) for s in chunk_starts]
    return {
        "frame_start": frame_start,
        "frame_stop": frame_stop,
        "chunk_starts": chunk_starts,
        "L": L,
        "n_valid": np.asarray(n_valid, np.int32),
    }


def build_chunk_odometry(calib: Calib, F, cfg: PipelineConfig,
                         backend: str = "dense"):
    """chunk_fn(ims1 (L, H, W), ims2 (L, H, W), gumbels (L-1, H, N)) ->
    (motions (L, 6), ok (L,)), where row t is the motion from frame t-1 to
    t (row 0, the chunk's halo frame, is invalid).  ``F`` is the (3, 3)
    fundamental matrix on the images' device.  It is the frame-batched
    odometry (``pipeline/batched.py``): a chunk's detection, matching and
    solves are batched calls."""
    from libviso_torch.pipeline.batched import build_batched_odometry

    batched = build_batched_odometry(calib, F, cfg, backend=backend)

    def chunk_fn(ims1, ims2, gumbels):
        out = batched(ims1, ims2, gumbels)
        return out.motions, out.ok

    return chunk_fn


def stitch_chunk_motions(trs, oks, n_valid):
    """Chain chunked motions into one trajectory.

    Args:
      trs: (B, L, 6) per-chunk motions (row 0, the halo, ignored).
      oks: (B, L) solver success flags.
      n_valid: (B,) real (non-padding) motion count per chunk.

    Returns ((1 + B (L-1), 4, 4) poses, keep mask): frame 0's identity
    and every chunk's motions chained, the padded rows marked False in
    ``keep``; ``poses[keep]`` is the T = 1 + sum(n_valid) frames'.
    """
    B, L = trs.shape[:2]
    local = torch.arange(1, L, device=trs.device)
    real = local[None, :] <= n_valid.to(trs.device)[:, None]
    motions = trs[:, 1:].reshape(B * (L - 1), 6)
    valid = (oks[:, 1:] & real).reshape(-1)
    poses_all = chain_motions(pose_vector_to_matrix(motions), valid)
    eye = torch.eye(4, dtype=poses_all.dtype, device=trs.device)[None]
    keep = torch.cat([torch.ones(1, dtype=torch.bool, device=trs.device),
                      real.reshape(-1)])
    return torch.cat([eye, poses_all]), keep


def _chunk_draws(cfg: PipelineConfig, seed: int, draws):
    if draws is not None:
        return draws
    shape = (cfg.ransac.num_hypotheses, cfg.detector.num_slots)
    return lambda c, n: sample_gumbel((n, *shape), frame_generator(seed, c))


def _run_chunks(devices, chunk_ids, P1, P2, lefts, rights, cfg, draws,
                backend):
    """Each chunk on its device: (motions, ok) per chunk, left on that
    device (so chunks on several cards overlap)."""
    calib = Calib.from_projections(P1, P2)
    F_host = F_from_P_host(P1, P2)
    fns = {}   # one chunk program per device
    outs = []
    for c, dev, im1, im2 in zip(chunk_ids, devices, lefts, rights):
        if dev not in fns:
            F = torch.as_tensor(F_host, dtype=torch.float32, device=dev)
            fns[dev] = build_chunk_odometry(calib, F, cfg, backend=backend)
        L = im1.shape[0]
        outs.append(fns[dev](torch.as_tensor(im1, device=dev),
                             torch.as_tensor(im2, device=dev),
                             draws(c, L - 1).to(dev)))
    return outs


def _result(poses_full, keep):
    keep = keep.cpu().numpy()
    return poses_full.cpu().numpy()[keep], keep


def run_sharded_odometry(mesh, P1, P2, frames_left, frames_right,
                         cfg: PipelineConfig = PipelineConfig(),
                         seed: int = 0, backend: str = "dense",
                         draws: Optional[Callable[[int, int],
                                                  torch.Tensor]] = None):
    """Sharded odometry: chunk, run chunk c on the mesh's ``data`` entry
    c, gather the chunks' motions to the first entry, stitch.

    Args:
      mesh: a mesh with a ``data`` axis (``parallel/mesh.py``).
      P1, P2: 3x4 projections.
      frames_left/right: (T, H, W) image stacks (host).
      backend: the matcher route, "dense", "fused" or "sweep".
      draws: optional (c, n) -> (n, H, N) Gumbel scores of chunk c.

    Returns (poses (T, 4, 4), keep mask) as numpy arrays.
    """
    devices = mesh.axis_devices("data")
    ims1, ims2, n_valid = chunk_frames_with_halo(frames_left, frames_right,
                                                 len(devices))
    outs = _run_chunks(devices, range(len(devices)), P1, P2, ims1, ims2,
                       cfg, _chunk_draws(cfg, seed, draws), backend)
    home = devices[0]
    trs = torch.stack([tr.to(home) for tr, _ in outs])
    oks = torch.stack([ok.to(home) for _, ok in outs])
    return _result(*stitch_chunk_motions(
        trs, oks, torch.as_tensor(n_valid, device=home)))


def run_sharded_odometry_multihost(mesh, P1, P2, local_left, local_right,
                                   total_frames: int,
                                   cfg: PipelineConfig = PipelineConfig(),
                                   seed: int = 0, backend: str = "dense",
                                   draws: Optional[Callable[[int, int],
                                                            torch.Tensor]]
                                   = None):
    """Multi-process sharded odometry.

    Every process calls this with only its own frame span, the one
    ``host_chunk_assignment`` gives it (which it checks), and runs its
    chunks on its block of the mesh's ``data`` entries.  The chunks'
    motions, ok flags and valid counts are exchanged with ``all_gather``
    (``parallel/distributed.py``), and every process stitches the same
    trajectory on its first entry's device.  One process is
    ``run_sharded_odometry``.

    Args:
      local_left/right: (frame_stop - frame_start, H, W) this process's
        span.
      total_frames: the global sequence length (the same on every
        process).

    Returns (poses (T, 4, 4), keep mask), the same on every process.
    """
    devices = mesh.axis_devices("data")
    n_chunks = len(devices)
    pid, nproc = process_index(), process_count()
    plan = host_chunk_assignment(total_frames, n_chunks, pid, nproc)
    local_left = np.asarray(local_left)
    local_right = np.asarray(local_right)
    expect = plan["frame_stop"] - plan["frame_start"]
    if local_left.shape[0] != expect:
        raise ValueError(
            f"process {pid} must pass frames [{plan['frame_start']}, "
            f"{plan['frame_stop']}) = {expect} frames, got "
            f"{local_left.shape[0]}")
    L = plan["L"]
    lo = [s - plan["frame_start"] for s in plan["chunk_starts"]]
    cpp = n_chunks // nproc
    ids = range(pid * cpp, (pid + 1) * cpp)
    outs = _run_chunks([devices[c] for c in ids], ids, P1, P2,
                       [_pad_chunk(local_left, s, L) for s in lo],
                       [_pad_chunk(local_right, s, L) for s in lo],
                       cfg, _chunk_draws(cfg, seed, draws), backend)
    # the exchange: host copies over the process group (a few KB)
    trs = all_gather_host(torch.stack([tr.cpu() for tr, _ in outs]))
    oks = all_gather_host(torch.stack([ok.cpu() for _, ok in outs]))
    n_valid = all_gather_host(torch.as_tensor(plan["n_valid"]))
    home = devices[0]
    return _result(*stitch_chunk_motions(
        trs.reshape(n_chunks, L, 6).to(home),
        oks.reshape(n_chunks, L).to(home), n_valid.reshape(-1).to(home)))
