"""ctypes binding to the repository's native image runtime
(``native/viso_native.cpp``; port of ``libviso_tpu/native``).

A libpng/libjpeg grayscale decoder and a threaded, in-order prefetch
executor: decode runs on C++ threads outside the interpreter, so it does
not compete for the interpreter lock with the thread that issues the
device's work.  The library is compiled on first use (``build.py``).

``available()`` is False where this host cannot build it (no ``g++``, no
``png.h``; ``unavailable_reason()`` says which), and the streams of
``io/kitti.py`` then decode with PIL, which covers every capability more
slowly.  A build that fails for any other reason raises.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Optional, Tuple

import numpy as np

from libviso_torch.native import build as _build

VN_OK = 0
VN_EOS = 1
ABI_VERSION = 2

_ERRORS = {
    -1: "cannot open file",
    -2: "unsupported image format (not PNG/JPEG)",
    -3: "image decode error",
    -4: "output buffer too small",
    -5: "bad stream handle",
}

_lib = None
_failure = None   # the first load's exception, raised again on each call
_lock = threading.Lock()

_u8p = ctypes.POINTER(ctypes.c_uint8)
_intp = ctypes.POINTER(ctypes.c_int)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.vn_version.restype = ctypes.c_int
    lib.vn_version.argtypes = []
    if lib.vn_version() != ABI_VERSION:
        raise RuntimeError(f"native runtime ABI {lib.vn_version()}, "
                           f"expected {ABI_VERSION}")
    decode = ([ctypes.c_char_p, _u8p, ctypes.c_int64, _intp, _intp],
              ctypes.c_int)
    signatures = {
        "vn_decode_png_gray": decode,
        "vn_decode_image_gray": decode,
        "vn_png_dims": ([ctypes.c_char_p, _intp, _intp], ctypes.c_int),
        "vn_stream_open": ([ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                            ctypes.c_int, ctypes.c_int], ctypes.c_void_p),
        "vn_stream_next": ([ctypes.c_void_p, _u8p, ctypes.c_int64, _intp,
                            _intp], ctypes.c_int),
        "vn_stream_close": ([ctypes.c_void_p], None),
    }
    for name, (argtypes, restype) in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


def _load() -> ctypes.CDLL:
    """The bound library, built on first use.  Raises ``Unavailable``
    where this host cannot build it, another error where the build or
    the load failed."""
    global _lib, _failure
    with _lock:
        if _lib is None and _failure is None:
            try:
                _lib = _bind(ctypes.CDLL(str(_build.build())))
            except (RuntimeError, OSError) as e:
                _failure = e
        if _failure is not None:
            raise _failure
        return _lib


def available() -> bool:
    """True when the runtime is built and loaded; False where this host
    cannot build it.  A build that fails for another reason raises."""
    return unavailable_reason() is None


def unavailable_reason() -> Optional[str]:
    """Why the runtime cannot be built here, or None when it is
    available."""
    try:
        _load()
    except _build.Unavailable as e:
        return str(e)
    return None


def _check(rc: int, what: str):
    if rc != VN_OK:
        raise IOError(f"{what}: {_ERRORS.get(rc, rc)}")


def png_dims(path: str) -> Tuple[int, int]:
    """(height, width) from the PNG header, no pixel decode."""
    h, w = ctypes.c_int(), ctypes.c_int()
    _check(_load().vn_png_dims(path.encode(), ctypes.byref(h),
                               ctypes.byref(w)), path)
    return h.value, w.value


def decode_png_gray(path: str) -> np.ndarray:
    """Decode a PNG to a (H, W) uint8 grayscale array: gray as stored,
    colour to luma, alpha dropped, 16-bit to its high byte."""
    lib = _load()
    hh, ww = png_dims(path)
    out = np.empty((hh, ww), dtype=np.uint8)
    h, w = ctypes.c_int(), ctypes.c_int()
    _check(lib.vn_decode_png_gray(path.encode(), out.ctypes.data_as(_u8p),
                                  out.size, ctypes.byref(h),
                                  ctypes.byref(w)), path)
    return out


def decode_image_gray(path: str,
                      max_hw: Tuple[int, int] = (4096, 8192)) -> np.ndarray:
    """Decode a PNG or JPEG (told apart by their first bytes) to (H, W)
    uint8 grayscale.

    A PNG is decoded at its exact size (dims read from its header, no
    size cap); a JPEG into a staging buffer of ``max_hw`` (libjpeg gives
    the dims only mid-decode)."""
    lib = _load()
    try:
        with open(path, "rb") as f:
            magic = f.read(2)
    except OSError:
        raise IOError(f"{path}: {_ERRORS[-1]}") from None
    if magic == b"\x89P":
        return decode_png_gray(path)
    cap = max_hw[0] * max_hw[1]
    buf = np.empty(cap, dtype=np.uint8)
    h, w = ctypes.c_int(), ctypes.c_int()
    _check(lib.vn_decode_image_gray(path.encode(), buf.ctypes.data_as(_u8p),
                                    cap, ctypes.byref(h), ctypes.byref(w)),
           path)
    return buf[: h.value * w.value].reshape(h.value, w.value).copy()


class NativeImageStream:
    """In-order prefetching frame stream over a list of PNG/JPEG paths,
    decoded by a pool of C++ threads.

    Frames k+1 .. k+depth decode while the consumer works on frame k;
    iteration yields (H, W) uint8 arrays in exactly path-list order.  A
    frame that fails to decode raises on its own ``next()``; the frames
    after it still arrive.  Use it as a context manager, or ``close()``.
    """

    def __init__(self, paths: List[str], threads: int = 4, depth: int = 8,
                 max_hw: Tuple[int, int] = (4096, 8192)):
        self._lib = _load()
        self._n = len(paths)
        # the C++ side keeps its own copies of the paths
        arr = (ctypes.c_char_p * self._n)(*[p.encode() for p in paths])
        self._handle = self._lib.vn_stream_open(arr, self._n, threads, depth)
        if self._n and not self._handle:
            raise RuntimeError("vn_stream_open failed")
        self._cap = max_hw[0] * max_hw[1]
        self._buf = np.empty(self._cap, dtype=np.uint8)

    def next(self) -> Optional[np.ndarray]:
        """The next frame, or None at the end of the stream."""
        if not self._handle:
            return None
        h, w = ctypes.c_int(), ctypes.c_int()
        rc = self._lib.vn_stream_next(
            self._handle, self._buf.ctypes.data_as(_u8p), self._cap,
            ctypes.byref(h), ctypes.byref(w))
        if rc == VN_EOS:
            return None
        _check(rc, "stream decode")
        return self._buf[: h.value * w.value].reshape(
            h.value, w.value).copy()

    def __iter__(self):
        while True:
            frame = self.next()
            if frame is None:
                return
            yield frame

    def close(self):
        """Stop the decode threads and free the stream (idempotent)."""
        if getattr(self, "_handle", None):
            self._lib.vn_stream_close(self._handle)
            self._handle = None

    def __del__(self):
        self.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
