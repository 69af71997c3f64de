"""All-pairs L1 descriptor distance: the CUDA kernel and its plain version.

``l1_distance_matrix`` replaces the Pallas kernel
``libviso_tpu/ops/pallas_matching.py::l1_distance_matrix``.  The kernel
(``csrc/l1_distance.cu``) takes a leading problem axis, so a frame's three
match problems, (3, N, D) x (3, N, D) -> (3, N, N), are one launch.

The device decides the route: a CUDA tensor launches the kernel or raises
(missing ``nvcc``, failed build, refused launch); a CPU tensor takes
``l1_distance_matrix_plain``, which the tests also use as the reference.
``launches`` counts kernel launches so a run can show that the main path
went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from libviso_torch import _build

launches = 0  # kernel launches; callers may reset it to 0 before a run

_INT_MAX = 2**31 - 1
_fn = None


def l1_distance_matrix_plain(d1, d2, row_chunk: int = 16):
    """Row-chunked broadcast L1: (..., N1, D) x (..., N2, D) -> (..., N1, N2).

    The port of ``_l1_desc_dist_xla`` (ops/matching.py): chunks of
    ``row_chunk`` query rows keep the (chunk, N2, D) broadcast small (16
    rows measured fastest on a CPU core at N2 = 1280, D = 128).
    """
    blocks = [
        (d1[..., i:i + row_chunk, None, :] - d2[..., None, :, :])
        .abs().sum(-1)
        for i in range(0, d1.shape[-2], row_chunk)
    ]
    if not blocks:
        return d1.new_zeros(d1.shape[:-1] + d2.shape[-2:-1])
    return torch.cat(blocks, dim=-2)


def _launcher():
    global _fn
    if _fn is None:
        fn = _build.load().l1_distance_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _launch(d1, d2):
    global launches
    if d1.dtype != torch.float32 or d2.dtype != torch.float32:
        raise TypeError(f"l1 kernel takes float32, got {d1.dtype}, "
                        f"{d2.dtype}")
    if not (d1.is_contiguous() and d2.is_contiguous()):
        raise ValueError("l1 kernel takes contiguous descriptors")
    if d1.dim() != 3 or d2.dim() != 3:
        raise ValueError(f"l1 kernel takes (B, N, D) stacks, got "
                         f"{tuple(d1.shape)}, {tuple(d2.shape)}")
    B, N1, D = d1.shape
    if d2.shape[0] != B or d2.shape[2] != D:
        raise ValueError(f"mismatched descriptor stacks {tuple(d1.shape)} "
                         f"and {tuple(d2.shape)}")
    N2 = d2.shape[1]
    if D % 4:
        raise ValueError(f"l1 kernel needs D % 4 == 0, got D={D}")
    if max(B, N1, N2, D) > _INT_MAX or B > 65535:
        raise ValueError(f"l1 kernel sizes out of range: {(B, N1, N2, D)}")
    if d1.data_ptr() % 16 or d2.data_ptr() % 16:
        raise ValueError("l1 kernel needs 16-byte aligned descriptors")
    out = torch.empty((B, N1, N2), dtype=torch.float32, device=d1.device)
    if out.numel() == 0:
        return out
    fn = _launcher()
    with torch.cuda.device(d1.device):
        stream = torch.cuda.current_stream(d1.device).cuda_stream
        rc = fn(d1.data_ptr(), d2.data_ptr(), out.data_ptr(),
                B, N1, N2, D, stream)
    if rc != 0:
        raise RuntimeError(f"l1 kernel launch failed: cudaError_t {rc}")
    launches += 1
    return out


def l1_distance_matrix(d1, d2):
    """All-pairs L1 distance: (N1, D) x (N2, D) -> (N1, N2), or with a
    leading problem axis (B, N1, D) x (B, N2, D) -> (B, N1, N2).

    CPU tensors take the plain version; CUDA tensors the kernel, which
    raises on what it does not take (non-f32, non-contiguous, D not a
    multiple of 4, misaligned).  N1 and N2 may be any size.
    """
    if d1.device != d2.device:
        raise ValueError(f"descriptors on {d1.device} and {d2.device}")
    if d1.device.type == "cpu":
        return l1_distance_matrix_plain(d1, d2)
    if d1.device.type != "cuda":
        raise ValueError(f"no L1 kernel for device {d1.device}")
    if d1.dim() == 2 and d2.dim() == 2:
        return _launch(d1[None], d2[None])[0]
    return _launch(d1, d2)
