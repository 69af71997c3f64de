"""KITTI odometry dataset I/O (port of ``libviso_tpu/io/kitti.py``).

Calibration parsing, devkit pose files and lazy stereo and mono image
streams.  PNG and JPEG frames decode ahead of the consumer on the native
runtime's C++ threads (``libviso_torch.native``), outside the
interpreter lock; where this host cannot build that runtime, PIL
(imported on first use) decodes on a read-ahead thread, with the same
frames and the same order.  Either way host I/O overlaps device compute.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np


def load_calib(path: str):
    """Parse a KITTI ``calib.txt`` into (P1, P2) float64 3x4 matrices: the
    first two ``P<n>:`` rows (P0 left gray, P1 right gray)."""
    mats = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts or not parts[0].startswith("P"):
                continue
            vals = [float(v) for v in parts[1:13]]
            mats.append(np.array(vals, dtype=np.float64).reshape(3, 4))
            if len(mats) == 2:
                break
    if len(mats) < 2:
        raise ValueError(f"calib file {path!r} has fewer than two P rows")
    return mats[0], mats[1]


def save_poses_kitti(path: str, poses):
    """Write poses in KITTI devkit format: the 12 row-major values of the
    top 3x4 block per line."""
    poses = np.asarray(poses)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for T in poses:
            f.write(" ".join(f"{v:.6e}" for v in T[:3, :4].reshape(-1)))
            f.write("\n")


def load_poses_kitti(path: str) -> np.ndarray:
    """Read a KITTI-format pose file into (T, 4, 4)."""
    rows = np.loadtxt(path).reshape(-1, 3, 4)
    T = np.tile(np.eye(4), (len(rows), 1, 1))
    T[:, :3, :4] = rows
    return T


def kitti_sequence_paths(kitti_home: str, seq: str):
    """Directory layout of the KITTI odometry set."""
    base = os.path.join(kitti_home, "sequences", seq)
    return {
        "calib": os.path.join(base, "calib.txt"),
        "image_0": os.path.join(base, "image_0"),
        "image_1": os.path.join(base, "image_1"),
    }


def _native():
    """The native decode runtime, or None where this host cannot build
    it (``native.unavailable_reason()``); a failed build raises."""
    from libviso_torch import native

    return native if native.available() else None


_NATIVE_EXTS = (".png", ".jpg", ".jpeg")


def _read_gray(path: str) -> np.ndarray:
    if path.lower().endswith(_NATIVE_EXTS):
        nat = _native()
        if nat is not None:
            return nat.decode_image_gray(path)
    from PIL import Image

    with Image.open(path) as im:
        # uint8: the device casts, f32 would quadruple the transfer
        return np.asarray(im.convert("L"), dtype=np.uint8)


class StereoImageStream:
    """Lazy stereo pair stream with background read-ahead.

    Two printf-style masks formatted with a frame index; iteration ends at
    ``end`` (inclusive) or at the first missing file.  Decode errors reach
    the consumer.
    """

    def __init__(self, mask_left: str, mask_right: str, begin: int = 0,
                 end: Optional[int] = None, prefetch: int = 4):
        self.mask_left = mask_left
        self.mask_right = mask_right
        self.begin = begin
        self.end = end
        self.prefetch = prefetch

    def skipped(self, n: int) -> "StereoImageStream":
        """A copy whose iteration starts ``n`` frames later, without
        decoding the skipped frames (checkpoint resume)."""
        return StereoImageStream(self.mask_left, self.mask_right,
                                 begin=self.begin + n, end=self.end,
                                 prefetch=self.prefetch)

    def _paths(self):
        i = self.begin
        while self.end is None or i <= self.end:
            left, right = self.mask_left % i, self.mask_right % i
            if not (os.path.exists(left) and os.path.exists(right)):
                return
            yield left, right
            i += 1

    def _frames(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        for left, right in self._paths():
            yield _read_gray(left), _read_gray(right)

    def __iter__(self):
        nat = _native() if self.prefetch > 0 else None
        if nat is not None:
            flat = [p for pair in self._paths() for p in pair]
            if all(p.lower().endswith(_NATIVE_EXTS) for p in flat):
                # one stream over the interleaved left/right list; zip of
                # one iterator with itself pairs consecutive frames
                frames = _native_stream(nat, flat, 2 * self.prefetch)
                return zip(frames, frames)
        return _read_ahead(self._frames(), self.prefetch)


class MonoImageStream:
    """Single-camera image stream: a printf-style mask formatted with the
    frame index, frames from ``begin`` until ``end`` (inclusive) or the
    first missing file, decoded on a read-ahead thread."""

    def __init__(self, mask: str, begin: int = 0,
                 end: Optional[int] = None, prefetch: int = 4):
        self.mask = mask
        self.begin = begin
        self.end = end
        self.prefetch = prefetch

    def skipped(self, n: int) -> "MonoImageStream":
        """A copy whose iteration starts ``n`` frames later, without
        decoding the skipped frames."""
        return MonoImageStream(self.mask, begin=self.begin + n,
                               end=self.end, prefetch=self.prefetch)

    def _paths(self):
        i = self.begin
        while self.end is None or i <= self.end:
            p = self.mask % i
            if not os.path.exists(p):
                return
            yield p
            i += 1

    def __iter__(self) -> Iterator[np.ndarray]:
        nat = _native() if self.prefetch > 0 else None
        if nat is not None:
            paths = list(self._paths())
            if all(p.lower().endswith(_NATIVE_EXTS) for p in paths):
                return _native_stream(nat, paths, self.prefetch)
        return _read_ahead((_read_gray(p) for p in self._paths()),
                           self.prefetch)


def _native_stream(nat, paths, depth: int):
    """The frames of ``paths`` in order, decoded up to ``depth`` ahead on
    the native runtime's threads; a decode error reaches the consumer."""
    with nat.NativeImageStream(paths, threads=min(4, os.cpu_count() or 1),
                               depth=depth) as stream:
        for _ in paths:
            yield stream.next()


def _read_ahead(items, prefetch: int):
    """Iterate ``items`` with up to ``prefetch`` of them made ahead on a
    thread (none: in the caller's thread); a failure reaches the
    consumer."""
    if prefetch <= 0:
        yield from items
        return
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    done = object()
    failure = []

    def worker():
        try:
            for item in items:
                q.put(item)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            failure.append(e)
        finally:
            q.put(done)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is done:
            t.join()
            if failure:
                raise failure[0]
            return
        yield item
