"""Multi-process launch and per-process data placement (port of
``libviso_tpu/parallel/distributed.py``).

Launch contract, the JAX package's (each process):

    VISO_COORDINATOR=host0:9876 VISO_NUM_PROCESSES=2 VISO_PROCESS_ID=k \\
        python -m libviso_torch.cli kitti ...

``initialize_from_env()`` (``cli kitti`` calls it first) joins the
process group with ``torch.distributed.init_process_group`` over TCP.  The
backend is gloo, and what crosses it are host copies of the exchanged
results: a sharded odometry run exchanges its chunks' motions (B, L, 6),
ok flags and valid counts, a few KB a run, so a host round trip costs
nothing that matters, while NCCL refuses two ranks on one GPU, which is
all a one-card machine has.  The compute stays on each process's card.
At exit each process leaves the group through a barrier, as
``jax.distributed`` does: a process that exits with its gloo group still
alive can abort in the group's threads, and the barrier keeps the
rendezvous store of process 0 up until every process is done with it.

Two per-process data plans: frame-level (``host_frame_range``, the
remainder spread over the leading processes, a 1-frame halo, assembled
with ``global_frame_array``) and the chunked odometry program's
(``parallel/odometry.py::host_chunk_assignment``, chunk-aligned; the
program validates against it).
"""

from __future__ import annotations

import atexit
import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

_ENV_COORD = "VISO_COORDINATOR"
_ENV_NPROC = "VISO_NUM_PROCESSES"
_ENV_PID = "VISO_PROCESS_ID"


def initialize_from_env() -> bool:
    """Join the process group the VISO_* variables describe.

    Returns True if multi-process init ran (or had run), False for the
    single-process no-op (unset or VISO_NUM_PROCESSES=1).  Safe to call
    twice.
    """
    nproc = os.environ.get(_ENV_NPROC)
    if nproc is None or int(nproc) <= 1:
        return False
    if dist.is_initialized():
        return True
    coordinator = os.environ.get(_ENV_COORD)
    if not coordinator or _ENV_PID not in os.environ:
        raise ValueError(f"{_ENV_NPROC}={nproc} needs {_ENV_COORD} "
                         f"(host:port) and {_ENV_PID}")
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=int(nproc),
                            rank=int(os.environ[_ENV_PID]))
    atexit.register(_shutdown)
    return True


def _shutdown():
    """Leave the process group: a barrier, then its destruction."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def all_gather_host(x: torch.Tensor) -> torch.Tensor:
    """Every process's ``x`` (one shape on all), stacked in process order
    on the CPU: (process_count, *x.shape).  One process returns x[None]."""
    x = x.detach().cpu()
    if process_count() == 1:
        return x[None]
    out = [torch.empty_like(x) for _ in range(process_count())]
    dist.all_gather(out, x.contiguous())
    return torch.stack(out)


def host_frame_range(num_frames: int, num_hosts: Optional[int] = None,
                     host_id: Optional[int] = None,
                     halo: int = 1) -> Tuple[int, int]:
    """[start, stop) frame range this process must load, halo included.

    The T-1 motions (frame t paired with t-1) split into ``num_hosts``
    runs whose lengths differ by at most one (the remainder goes to the
    leading processes); process h also loads ``halo`` frames before its
    first motion for the previous-frame dependency.
    """
    if num_hosts is None:
        num_hosts = process_count()
    if host_id is None:
        host_id = process_index()
    if not 0 <= host_id < num_hosts:
        raise ValueError(f"host_id {host_id} out of range [0, {num_hosts})")
    motions = max(num_frames - 1, 0)
    base, rem = divmod(motions, num_hosts)
    start_motion = host_id * base + min(host_id, rem)
    stop_motion = start_motion + base + (1 if host_id < rem else 0)
    start = max(start_motion + 1 - halo, 0)
    stop = min(stop_motion + 1, num_frames)
    return start, stop


class FrameShard(NamedTuple):
    """This process's frames of a globally split frame array."""

    frames: torch.Tensor    # this process's frames, on its device
    offset: int             # global index of frames[0]
    global_shape: tuple     # shape of the whole (never assembled) array


def global_frame_array(mesh, local_frames, axis: str = "data") -> FrameShard:
    """This process's frames (in ``host_frame_range`` order) on its first
    ``axis`` device, with their global offset and the global shape: the
    processes' frame counts are exchanged, the frames are not, so nothing
    is gathered to one host."""
    local = torch.as_tensor(np.asarray(local_frames))
    entries = mesh.axis_devices(axis)
    per = max(1, len(entries) // process_count())
    device = entries[min(process_index() * per, len(entries) - 1)]
    counts = all_gather_host(torch.tensor([local.shape[0]]))[:, 0].tolist()
    offset = int(sum(counts[:process_index()]))
    return FrameShard(frames=local.to(device), offset=offset,
                      global_shape=(int(sum(counts)), *local.shape[1:]))


def describe() -> dict:
    """Process and device facts for logs and metrics headers."""
    cuda = torch.cuda.is_available()
    local = torch.cuda.device_count() if cuda else 1
    return {
        "process_index": process_index(),
        "process_count": process_count(),
        "global_devices": local * process_count(),
        "local_devices": local,
        "device_kind": torch.cuda.get_device_name(0) if cuda else "cpu",
    }
