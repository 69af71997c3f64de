"""Sequence checkpoint / resume (the port's own copy of
``libviso_tpu/utils/checkpoint.py``: pure numpy).

The stereo host loops periodically snapshot their full loop state: the
per-frame motion/validity history, the carried FrameState's tensors
(previous-frame keypoints, descriptors, 3D points), the per-frame stats and
a config fingerprint, so that a resume with different settings fails loudly
instead of silently diverging.

Format: one .npz per checkpoint (atomic rename), ``ckpt_<frame>.npz`` in
the checkpoint directory; ``latest()`` picks the highest frame.  The state
is the list of numpy arrays that ``pipeline/stereo.py::state_to_leaves``
makes, in the field order of ``FrameState``.

Resume is exact inside the port: frame t's RANSAC draws depend on
(seed, t) only (``solvers/ransac.py::frame_generator``), so a resumed run
gives the motions of an uninterrupted one bit for bit
(tests/test_torch_checkpoint.py).  The files are not interchangeable with
the JAX package's: the fingerprint hashes the port's config ``repr`` and
its backend names, and the two packages draw different random numbers.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
from typing import List, Optional

import numpy as np


def config_fingerprint(cfg, seed: int, backend: str,
                       scope: str = "") -> str:
    """Stable hash of everything that must match for a resume to be valid.

    ``scope`` identifies the input slice (e.g. the KITTI begin/end frame
    range): resuming with a shifted range would silently stitch motions
    across misaligned frames, so it must invalidate the checkpoint.
    """
    text = f"{cfg!r}|seed={seed}|backend={backend}|scope={scope}"
    return hashlib.sha256(text.encode()).hexdigest()[:16]


@dataclasses.dataclass
class Checkpoint:
    next_frame: int            # first frame index NOT yet processed
    motions: np.ndarray        # (next_frame, 6)
    oks: np.ndarray            # (next_frame,) bool
    state_leaves: List[np.ndarray]  # flattened FrameState pytree
    stats: list                # per-frame dicts
    fingerprint: str


class CheckpointManager:
    """Own a checkpoint directory; save every `every` frames, resume latest."""

    _PAT = re.compile(r"^ckpt_(\d+)\.npz$")

    def __init__(self, directory: str, every: int = 100, keep: int = 2):
        self.directory = directory
        self.every = max(1, int(every))
        self.keep = max(1, int(keep))
        os.makedirs(directory, exist_ok=True)

    def _path(self, frame: int) -> str:
        return os.path.join(self.directory, f"ckpt_{frame:08d}.npz")

    def _frames_on_disk(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            m = self._PAT.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def save(self, ckpt: Checkpoint) -> str:
        path = self._path(ckpt.next_frame)
        tmp = path + ".tmp.npz"
        payload = {
            "next_frame": np.int64(ckpt.next_frame),
            "motions": np.asarray(ckpt.motions, np.float64),
            "oks": np.asarray(ckpt.oks, bool),
            "stats_json": np.frombuffer(
                json.dumps(ckpt.stats).encode(), dtype=np.uint8),
            "fingerprint": np.frombuffer(
                ckpt.fingerprint.encode(), dtype=np.uint8),
            "n_leaves": np.int64(len(ckpt.state_leaves)),
        }
        for i, leaf in enumerate(ckpt.state_leaves):
            payload[f"leaf_{i}"] = np.asarray(leaf)
        np.savez(tmp, **payload)
        os.replace(tmp, path)
        # prune old checkpoints beyond `keep`
        for f in self._frames_on_disk()[: -self.keep]:
            try:
                os.remove(self._path(f))
            except OSError:
                pass
        return path

    def latest(self) -> Optional[Checkpoint]:
        frames = self._frames_on_disk()
        if not frames:
            return None
        return self.load(self._path(frames[-1]))

    @staticmethod
    def load(path: str) -> Checkpoint:
        with np.load(path) as z:
            n = int(z["n_leaves"])
            return Checkpoint(
                next_frame=int(z["next_frame"]),
                motions=z["motions"],
                oks=z["oks"],
                state_leaves=[z[f"leaf_{i}"] for i in range(n)],
                stats=json.loads(bytes(z["stats_json"]).decode()),
                fingerprint=bytes(z["fingerprint"]).decode(),
            )
