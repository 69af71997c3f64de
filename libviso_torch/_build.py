"""Build the port's CUDA kernels from ``csrc/`` and load them with ctypes.

``nvcc`` compiles every ``csrc/*.cu`` into one shared library with a plain
C interface (no PyTorch headers, so the build takes seconds) under
``build/kernels/`` at the repository root: one ``nvcc -c`` per source, all
started together, then one link.  The library's name carries a
hash of the sources (``*.cu`` and the ``*.cuh`` headers they share) and
flags: an edited kernel is rebuilt, and a stale
library is never loaded.  ptxas' report of registers, shared memory and
spills is kept beside the library (``.log``).  Building needs the CUDA
toolkit; there is no fallback when it is missing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lib = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA toolkit "
            "is needed to build libviso_torch's kernels")
    return path


def library_path() -> Path:
    """Where the library for the current sources lives once built."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libviso_torch_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/*.cu`` unless the library for these sources exists."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = os.path.join(tmp, src.stem + ".o")
            procs.append((obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        logs = []
        for _, proc in procs:
            logs.append(proc.communicate()[1])
        failed = [(p.args, log) for (_, p), log in zip(procs, logs)
                  if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{' '.join(args)}\n{log}" for args, log in failed))
        lib = os.path.join(tmp, so.name)
        proc = subprocess.run([nvcc, "-shared", "-o", lib,
                               *(obj for obj, _ in procs)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed with exit code "
                               f"{proc.returncode}:\n{proc.stderr}")
        so.with_suffix(".log").write_text("".join(logs) + proc.stderr)
        os.replace(lib, so)  # atomic: a concurrent loader sees all or nothing
    return so


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build()))
    return _lib
