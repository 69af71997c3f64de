"""Fused gated matching: the two CUDA kernels and their plain versions.

For each query row of B match problems, the gated (best, second, argmin)
of the L1 descriptor distance over all target slots, with no (B, N1, N2)
array stored.  The gate of a pair is the position radius (L1, strict <),
both slots valid, and, per problem, the Sampson gate under that problem's
F.  A tie goes to the lowest target column; a row with no candidate gives
(inf, inf, -1).  The ratio test and final validity stay with the caller
(``ops/matching.py``).

``fused_gated_two_min`` replaces the Pallas kernel
``libviso_tpu/ops/pallas_fused_match.py::fused_gated_two_min``, and
``fused_sweep_two_min`` its ``fused_sweep_two_min``: the same result on
x-sorted slots, skipping the target tiles whose bounding box (of valid
slots) lies a radius or more from the query block's.
``sorted_fused_two_min`` sorts both sides by x (a stable sort: invalid
queries go to +1e6, invalid targets to -1e6), runs the sweep and maps the
result back, so among equal distances the lowest *sorted* position wins.
The kernels are ``csrc/fused_two_min.cu`` and ``csrc/fused_sweep.cu``.

The device decides the route, as in ``ops/cuda_matching.py``: a CUDA
tensor launches the kernel or raises, a CPU tensor takes the plain
version.  The plain versions follow the Pallas gate expression by
expression (``_tile_pass``), not ``geometry/mvg.py::sampson_distance``,
whose matmul form rounds differently; so kernel and plain version take
every gate decision alike, and on integer descriptors agree bitwise.
``launches`` counts kernel launches by kernel name.
"""

from __future__ import annotations

import ctypes

import torch

from libviso_torch import _build
from libviso_torch.ops.cuda_matching import l1_distance_matrix_plain

# kernel launches by kernel; callers may reset the counts to 0 before a run
launches = {"fused_gated_two_min": 0, "fused_sweep_two_min": 0}

BIG = 3.0e38      # "no candidate" sentinel of the Pallas kernels
_TINY = 1e-30     # Sampson denominator floor
_fns = {}


def sampson_gate(q_xy, t_xy, F, sampson_thresh):
    """(B, N1, N2) bool: Sampson distance <= thresh with den > 1e-30, in
    the expression order of ``_tile_pass``.  F is (B, 3, 3)."""
    qx, qy = q_xy[..., :, None, 0], q_xy[..., :, None, 1]    # (B, N1, 1)
    tx, ty = t_xy[..., None, :, 0], t_xy[..., None, :, 1]    # (B, 1, N2)
    f = F.reshape(F.shape[0], 1, 1, 9)
    f00, f01, f02, f10, f11, f12, f20, f21, f22 = f.unbind(-1)
    a1 = f00 * qx + f01 * qy + f02
    a2 = f10 * qx + f11 * qy + f12
    a3 = f20 * qx + f21 * qy + f22
    b1 = f00 * tx + f10 * ty + f20
    b2 = f01 * tx + f11 * ty + f21
    t = tx * a1 + ty * a2 + a3
    num = t * t
    den = a1 * a1 + a2 * a2 + b1 * b1 + b2 * b2
    s = num / torch.clamp(den, min=_TINY)
    return (s <= sampson_thresh) & (den > _TINY)


def gate(q_xy, q_valid, t_xy, t_valid, F, use_epi, sampson_thresh, radius):
    """(B, N1, N2) bool: the kernels' gate of every pair."""
    pos = ((q_xy[..., :, None, 0] - t_xy[..., None, :, 0]).abs()
           + (q_xy[..., :, None, 1] - t_xy[..., None, :, 1]).abs())
    ok = (pos < radius) & q_valid[..., :, None] & t_valid[..., None, :]
    epi_ok = sampson_gate(q_xy, t_xy, F, sampson_thresh)
    return ok & (epi_ok | ~use_epi[:, None, None])


def fused_gated_two_min_plain(q_xy, q_valid, q_d, t_xy, t_valid, t_d, F,
                              use_epi, sampson_thresh=1.0, radius=80.0):
    """The plain version of both kernels: (B, ...) problems ->
    (best, second (B, N1) float32, idx (B, N1) int32)."""
    ok = gate(q_xy, q_valid, t_xy, t_valid, F, use_epi, sampson_thresh,
              radius)
    B, N1 = q_valid.shape
    if t_d.shape[1] == 0:
        inf = q_d.new_full((B, N1), float("inf"))
        return inf, inf.clone(), torch.full_like(inf, -1, dtype=torch.int32)
    dd = torch.where(ok, l1_distance_matrix_plain(q_d, t_d),
                     q_d.new_tensor(BIG))
    idx = torch.argmin(dd, dim=-1, keepdim=True)        # first minimum
    best = torch.gather(dd, -1, idx)[..., 0]
    second = dd.scatter(-1, idx, BIG).amin(-1)
    none = best >= BIG
    inf = q_d.new_tensor(float("inf"))
    return (torch.where(none, inf, best),
            torch.where(second >= BIG, inf, second),
            torch.where(none, -1, idx[..., 0]).to(torch.int32))


# the sweep's plain version: the box test skips only tiles without a
# candidate, so on the same (sorted) slots it computes the same result
fused_sweep_two_min_plain = fused_gated_two_min_plain


def _library():
    if not _fns:
        lib = _build.load()
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        gated = lib.fused_gated_two_min_launch
        gated.argtypes = [ptr] * 11 + [i32] * 4 + [f32, f32, ptr]
        gated.restype = i32
        sweep = lib.fused_sweep_two_min_launch
        sweep.argtypes = [ptr] * 13 + [i32] * 4 + [f32, f32, ptr]
        sweep.restype = i32
        rows, cols = ctypes.c_int(), ctypes.c_int()
        lib.fused_sweep_tiling(ctypes.byref(rows), ctypes.byref(cols))
        _fns.update(gated=gated, sweep=sweep, tiling=(rows.value, cols.value))
    return _fns


def tiling():
    """(query rows per block, target slots per tile) of the sweep kernel,
    the runs its boxes cover."""
    return _library()["tiling"]


def _check(q_xy, q_valid, q_d, t_xy, t_valid, t_d, F, use_epi):
    """Raise on what the kernels do not take; returns (B, N1, N2, D)."""
    floats = {"q_xy": q_xy, "q_d": q_d, "t_xy": t_xy, "t_d": t_d, "F": F}
    bools = {"q_valid": q_valid, "t_valid": t_valid, "use_epi": use_epi}
    for name, x in {**floats, **bools}.items():
        if x.device != q_d.device:
            raise ValueError(f"{name} on {x.device}, descriptors on "
                             f"{q_d.device}")
        if not x.is_contiguous():
            raise ValueError(f"fused kernels take contiguous tensors; "
                             f"{name} is not")
    for name, x in floats.items():
        if x.dtype != torch.float32:
            raise TypeError(f"fused kernels take float32 {name}, got "
                            f"{x.dtype}")
    for name, x in bools.items():
        if x.dtype != torch.bool:
            raise TypeError(f"fused kernels take bool {name}, got {x.dtype}")
    if q_d.dim() != 3 or t_d.dim() != 3:
        raise ValueError(f"fused kernels take (B, N, D) descriptors, got "
                         f"{tuple(q_d.shape)}, {tuple(t_d.shape)}")
    B, N1, D = q_d.shape
    N2 = t_d.shape[1]
    expect = {"q_xy": (B, N1, 2), "q_valid": (B, N1), "t_xy": (B, N2, 2),
              "t_valid": (B, N2), "t_d": (B, N2, D), "F": (B, 3, 3),
              "use_epi": (B,)}
    for name, shape in expect.items():
        got = tuple({**floats, **bools}[name].shape)
        if got != shape:
            raise ValueError(f"{name} has shape {got}, expected {shape}")
    if D % 4:
        raise ValueError(f"fused kernels need D % 4 == 0, got D={D}")
    if B > 65535 or max(N1, N2) * max(D, 2) >= 2**31:
        raise ValueError(f"fused kernel sizes out of range: {(B, N1, N2, D)}")
    if q_d.data_ptr() % 16 or t_d.data_ptr() % 16:
        raise ValueError("fused kernels need 16-byte aligned descriptors")
    return B, N1, N2, D


def _outputs(B, N1, device):
    return (torch.empty((B, N1), dtype=torch.float32, device=device),
            torch.empty((B, N1), dtype=torch.float32, device=device),
            torch.empty((B, N1), dtype=torch.int32, device=device))


def _run(name, args, sizes, radius, sampson_thresh, device):
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = _library()[name](*(x.data_ptr() if isinstance(x, torch.Tensor)
                                else x for x in args),
                              *sizes, radius, sampson_thresh, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {rc}")


def _device_route(q_d):
    if q_d.device.type == "cpu":
        return False
    if q_d.device.type != "cuda":
        raise ValueError(f"no fused matcher kernel for device {q_d.device}")
    return True


def fused_gated_two_min(q_xy, q_valid, q_d, t_xy, t_valid, t_d, F, use_epi,
                        sampson_thresh=1.0, radius=80.0):
    """Gated row-wise (best, second, argmin) of B L1 match problems.

    q_xy (B, N1, 2) float32, q_valid (B, N1) bool, q_d (B, N1, D)
    float32, the same for the targets, F (B, 3, 3) float32 and use_epi
    (B,) bool.  Returns best, second (B, N1) float32 and idx (B, N1)
    int32.  CPU tensors take the plain version; CUDA tensors the kernel,
    which raises on what it does not take.
    """
    if not _device_route(q_d):
        return fused_gated_two_min_plain(q_xy, q_valid, q_d, t_xy, t_valid,
                                         t_d, F, use_epi, sampson_thresh,
                                         radius)
    B, N1, N2, D = _check(q_xy, q_valid, q_d, t_xy, t_valid, t_d, F,
                          use_epi)
    best, second, idx = _outputs(B, N1, q_d.device)
    if best.numel() == 0:
        return best, second, idx
    _run("gated", (q_xy, q_valid, q_d, t_xy, t_valid, t_d, F, use_epi, best,
                   second, idx), (B, N1, N2, D), radius, sampson_thresh,
         q_d.device)
    launches["fused_gated_two_min"] += 1
    return best, second, idx


def sweep_boxes(xy, valid, block):
    """(B, 4, ceil(N / block)): rows [x_min, x_max, y_min, y_max] of the
    valid slots of each run of ``block`` slots; a run without a valid slot
    gets the empty box [inf, -inf, inf, -inf], which every test skips.

    The Pallas wrapper boxes invalid slots too, at x = +-1e6, so the block
    where sorted valid slots meet invalid ones spans the whole range and is
    never skipped; the gate rejects a pair with an invalid slot anyway, so
    leaving them out skips more and stays exact.
    """
    B, N = valid.shape
    inf = torch.tensor(float("inf"), dtype=xy.dtype, device=xy.device)
    lo = torch.where(valid[..., None], xy, inf)
    hi = torch.where(valid[..., None], xy, -inf)
    n = -(-N // block)
    pad = n * block - N
    if pad:
        lo = torch.cat([lo, inf.expand(B, pad, 2)], dim=1)
        hi = torch.cat([hi, (-inf).expand(B, pad, 2)], dim=1)
    lo = lo.reshape(B, n, block, 2).amin(2)
    hi = hi.reshape(B, n, block, 2).amax(2)
    return torch.stack([lo[..., 0], hi[..., 0], lo[..., 1], hi[..., 1]],
                       dim=1).contiguous()


def sweep_live_tiles(qbox, tbox, radius):
    """(B,) int: the (query block, target tile) pairs the sweep computes,
    by the kernel's box test."""
    dx = torch.maximum(tbox[:, None, 0] - qbox[:, 1, :, None],
                       qbox[:, 0, :, None] - tbox[:, None, 1])
    dy = torch.maximum(tbox[:, None, 2] - qbox[:, 3, :, None],
                       qbox[:, 2, :, None] - tbox[:, None, 3])
    live = dx.clamp(min=0.0) + dy.clamp(min=0.0) < radius
    return live.sum((1, 2))


def fused_sweep_two_min(q_xy, q_valid, q_d, t_xy, t_valid, t_d, F, use_epi,
                        sampson_thresh=1.0, radius=80.0):
    """``fused_gated_two_min`` on slots sorted by x, by the sweep kernel.

    The arguments are those of ``fused_gated_two_min``.  On the card the
    boxes of the kernel's query blocks and target tiles (``sweep_boxes``)
    are computed here, as the Pallas wrapper computes them in XLA.
    """
    if not _device_route(q_d):
        return fused_sweep_two_min_plain(q_xy, q_valid, q_d, t_xy, t_valid,
                                         t_d, F, use_epi, sampson_thresh,
                                         radius)
    B, N1, N2, D = _check(q_xy, q_valid, q_d, t_xy, t_valid, t_d, F,
                          use_epi)
    best, second, idx = _outputs(B, N1, q_d.device)
    if best.numel() == 0:
        return best, second, idx
    rows, cols = tiling()
    qbox = sweep_boxes(q_xy, q_valid, rows)
    tbox = sweep_boxes(t_xy, t_valid, cols)
    _run("sweep", (q_xy, q_valid, q_d, t_xy, t_valid, t_d, F, use_epi, qbox,
                   tbox, best, second, idx), (B, N1, N2, D),
         radius, sampson_thresh, q_d.device)
    launches["fused_sweep_two_min"] += 1
    return best, second, idx


def sort_slots(q_xy, q_valid, q_d, t_xy, t_valid, t_d):
    """Both sides of each problem in stable x order, invalid queries keyed
    at +1e6 and invalid targets at -1e6: (the six tensors sorted, qperm,
    tperm), the permutations (B, N) int64."""
    def order(xy, valid, invalid_x):
        return torch.argsort(torch.where(valid, xy[..., 0], invalid_x),
                             dim=-1, stable=True)

    def take(x, perm):
        ix = perm if x.dim() == 2 else perm[..., None]
        return torch.take_along_dim(x, ix, dim=1)

    qperm = order(q_xy, q_valid, 1e6)
    tperm = order(t_xy, t_valid, -1e6)
    return ([take(x, qperm) for x in (q_xy, q_valid, q_d)]
            + [take(x, tperm) for x in (t_xy, t_valid, t_d)], qperm, tperm)


def sorted_fused_two_min(q_xy, q_valid, q_d, t_xy, t_valid, t_d, F, use_epi,
                         sampson_thresh=1.0, radius=80.0, sweep=None):
    """``fused_gated_two_min`` semantics through the sweep kernel: both
    sides sorted by x, the result mapped back to the original slots (idx
    into the original target slots).  Among equal distances the lowest
    x-sorted target wins.  ``sweep`` replaces the sweep call (the plain
    version on the card, for comparison)."""
    sweep = sweep or fused_sweep_two_min
    srt, qperm, tperm = sort_slots(q_xy, q_valid, q_d, t_xy, t_valid, t_d)
    best_s, second_s, idx_s = sweep(*srt, F, use_epi, sampson_thresh,
                                    radius)

    def unsort(x):
        return torch.empty_like(x).scatter_(1, qperm, x)

    idx_s = unsort(idx_s)
    idx = torch.where(idx_s >= 0,
                      torch.gather(tperm, 1, idx_s.clamp(min=0).long()), -1)
    return unsort(best_s), unsort(second_s), idx.to(torch.int32)
