"""Build the native image runtime (``native/viso_native.cpp``) on demand.

One ``g++`` call compiles the repository's C++ runtime into a shared
library under ``build/native/`` at the repository root, named by a hash
of the source and the flags, so an edited source is rebuilt and a stale
library is never loaded.  Nothing is written next to the package.

A host with libpng but no libjpeg keeps the runtime: the build is retried
with ``-DVN_NO_JPEG`` (JPEGs then report "unsupported image format").
A missing ``g++``, a missing ``png.h`` or a missing source makes the
runtime unavailable (``Unavailable``, with the reason); any other build
failure is an error.

  python -m libviso_torch.native.build      (prints the library's path)
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SRC = ROOT / "native" / "viso_native.cpp"
BUILD_DIR = ROOT / "build" / "native"
FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread")
WITH_JPEG = ((), ("-lpng", "-ljpeg", "-lz"))
WITHOUT_JPEG = (("-DVN_NO_JPEG",), ("-lpng", "-lz"))


class Unavailable(RuntimeError):
    """The runtime cannot be built on this host; the message says why."""


def library_path() -> Path:
    """Where the library for the current source lives once built."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"viso_native-{h.hexdigest()[:16]}.so"


def compile_library(out, jpeg: bool = True) -> subprocess.CompletedProcess:
    """One ``g++`` run of the source into ``out``, with the JPEG decoder
    or without it (``-DVN_NO_JPEG``)."""
    defines, libs = WITH_JPEG if jpeg else WITHOUT_JPEG
    return subprocess.run(
        ["g++", *FLAGS, *defines, str(SRC), *libs, "-o", str(out)],
        capture_output=True, text=True, timeout=300)


def build() -> Path:
    """The library for the current source, compiled unless it exists."""
    if not SRC.exists():
        raise Unavailable(f"{SRC} not found")
    so = library_path()
    if so.exists():
        return so
    if shutil.which("g++") is None:
        raise Unavailable("g++ not found on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    errors = []
    # a file of its own per process: concurrent first builds (test
    # workers) must not write into one file
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = os.path.join(tmp, so.name)
        for jpeg in (True, False):
            proc = compile_library(out, jpeg=jpeg)
            if proc.returncode == 0:
                os.replace(out, so)  # atomic: a loader sees all or nothing
                return so
            errors.append(proc.stderr)
    if any("png.h" in e and "No such file" in e for e in errors):
        raise Unavailable("png.h not found (libpng's headers are missing)")
    raise RuntimeError("g++ failed to build the native runtime:\n"
                       + "\n".join(errors))


if __name__ == "__main__":
    try:
        print(build())
    except Unavailable as e:
        print(f"native runtime unavailable: {e}", file=sys.stderr)
        sys.exit(1)
