"""Fused gated matching: the three CUDA kernels and their plain versions.

For each query row of B match problems, the gated (best, second, argmin)
of the L1 descriptor distance over all target slots, with no (B, N1, N2)
array stored.  The gate of a pair is the position radius (L1, strict <),
both slots valid, and, per problem, the Sampson gate under that problem's
F.  A tie goes to the lowest target column; a row with no candidate gives
(inf, inf, -1).  The ratio test and final validity stay with the caller
(``ops/matching.py``).

``fused_gated_two_min`` replaces the Pallas kernel
``libviso_tpu/ops/pallas_fused_match.py::fused_gated_two_min``, and
``sorted_fused_two_min`` its ``sorted_fused_two_min``: the same result with
both sides sorted by x (a stable sort: invalid queries keyed at +1e6,
invalid targets at -1e6), skipping the runs of sorted targets whose
bounding box (of valid slots) lies a radius or more from the query
block's, so among equal distances the lowest *sorted* target wins.  On
the card that route is two launches: the order kernel
(``csrc/sweep_order.cu``: the permutations and the boxes) and the sweep
kernel (``csrc/fused_sweep.cu``), which reads the slots through the
permutations and writes the result at the original slots.
``fused_sweep_two_min`` takes slots already sorted.  The gated kernel is
``csrc/fused_two_min.cu``.

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
launches = {"fused_gated_two_min": 0, "sweep_order": 0,
            "fused_sweep_two_min": 0}

BIG = 3.0e38      # "no candidate" sentinel of the Pallas kernels
_TINY = 1e-30     # Sampson denominator floor
# the runs the order's boxes cover (sorted query rows, target slots) and
# the target columns per window of the sweep kernel's work
# (csrc/fused_sweep.cu: kQueryBox, kBox, kCols); its query blocks are one
# or two query boxes (``sweep_plan``)
SWEEP_TILING = (32, 16)
SWEEP_WINDOW = 128
# the most slots a side one CTA of the order kernel sorts
# (csrc/sweep_order.cu); above it the order takes three launches and a
# scratch buffer of keys
MAX_SWEEP_SLOTS = 8192
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


# the sweep's plain version: the box test skips only target runs without
# a candidate, so on the same (sorted) slots it computes the same result
fused_sweep_two_min_plain = fused_gated_two_min_plain


def _library():
    if not _fns:
        lib = _build.load()
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        gated = lib.fused_gated_two_min_launch
        gated.argtypes = [ptr] * 11 + [i32] * 4 + [f32, f32, ptr]
        gated.restype = i32
        order = lib.sweep_order_launch
        order.argtypes = [ptr] * 9 + [i32] * 6 + [ptr]
        order.restype = i32
        sweep = lib.fused_sweep_two_min_launch
        sweep.argtypes = [ptr] * 15 + [i32] * 4 + [f32, f32, ptr]
        sweep.restype = i32
        tiling = [ctypes.c_int() for _ in range(3)]
        lib.fused_sweep_tiling(*map(ctypes.byref, tiling))
        built = (tuple(x.value for x in tiling), lib.sweep_order_max_slots())
        want = ((*SWEEP_TILING, SWEEP_WINDOW), MAX_SWEEP_SLOTS)
        if built != want:
            raise RuntimeError(f"the kernels were built for sweep tiling and "
                               f"slot limit {built}, this module expects "
                               f"{want}")
        plan = lib.fused_sweep_plan
        plan.argtypes = [i32, i32, ptr, ptr]
        plan.restype = i32
        _fns.update(gated=gated, order=order, sweep=sweep, plan=plan)
    return _fns


def _check_tensors(device, floats, bools):
    for name, x in {**floats, **bools}.items():
        if x.device != device:
            raise ValueError(f"{name} on {x.device}, expected {device}")
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


def _check_shapes(tensors, expect):
    for name, shape in expect.items():
        got = tuple(tensors[name].shape)
        if got != shape:
            raise ValueError(f"{name} has shape {got}, expected {shape}")


def _check(q_xy, q_valid, q_d, t_xy, t_valid, t_d, F, use_epi):
    """Raise on what the kernels do not take; returns (B, N1, N2, D)."""
    floats = {"q_xy": q_xy, "q_d": q_d, "t_xy": t_xy, "t_d": t_d, "F": F}
    bools = {"q_valid": q_valid, "t_valid": t_valid, "use_epi": use_epi}
    _check_tensors(q_d.device, floats, bools)
    if q_d.dim() != 3 or t_d.dim() != 3:
        raise ValueError(f"fused kernels take (B, N, D) descriptors, got "
                         f"{tuple(q_d.shape)}, {tuple(t_d.shape)}")
    B, N1, D = q_d.shape
    N2 = t_d.shape[1]
    _check_shapes({**floats, **bools}, {
        "q_xy": (B, N1, 2), "q_valid": (B, N1), "t_xy": (B, N2, 2),
        "t_valid": (B, N2), "t_d": (B, N2, D), "F": (B, 3, 3),
        "use_epi": (B,)})
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


def _run(name, args, device):
    """Launch kernel `name` on the current stream of `device`: tensors are
    passed as pointers, the stream last; raise on a refused launch."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = _library()[name](*(x.data_ptr() if isinstance(x, torch.Tensor)
                                else x for x in args), stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {rc}")


def _device_route(x):
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no fused matcher kernel for device {x.device}")
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
                   second, idx, B, N1, N2, D, radius, sampson_thresh),
         q_d.device)
    launches["fused_gated_two_min"] += 1
    return best, second, idx


def _take(x, perm):
    """x (B, N, ...) in the order perm (B, N)."""
    perm = perm.long()
    return torch.take_along_dim(x, perm if x.dim() == 2 else perm[..., None],
                                dim=1)


def _boxes(xy, valid, block):
    """(B, 4, ceil(N / block)): rows [x_min, x_max, y_min, y_max] of the
    valid slots of each run of ``block`` slots, NaN coordinates left out;
    a run without a valid slot gets the empty box [inf, -inf, inf, -inf],
    which every test skips.

    The Pallas wrapper boxes invalid slots too, at x = +-1e6, so the block
    where sorted valid slots meet invalid ones spans the whole range and is
    never skipped; the gate rejects a pair with an invalid slot anyway, so
    leaving them out skips more and stays exact.
    """
    B, N = valid.shape
    inf = torch.tensor(float("inf"), dtype=xy.dtype, device=xy.device)
    keep = valid[..., None] & ~torch.isnan(xy)
    lo = torch.where(keep, xy, inf)
    hi = torch.where(keep, xy, -inf)
    n = -(-N // block)
    pad = n * block - N
    if pad:
        lo = torch.cat([lo, inf.expand(B, pad, 2)], dim=1)
        hi = torch.cat([hi, (-inf).expand(B, pad, 2)], dim=1)
    lo = lo.reshape(B, n, block, 2).amin(2)
    hi = hi.reshape(B, n, block, 2).amax(2)
    return torch.stack([lo[..., 0], hi[..., 0], lo[..., 1], hi[..., 1]],
                       dim=1).contiguous()


def sweep_order_plain(q_xy, q_valid, t_xy, t_valid, sort=True,
                      tiling=SWEEP_TILING):
    """The plain version of the order kernel (see ``sweep_order``), on
    the device of the inputs: stable ``torch.argsort`` of the keys (x,
    +1e6 for an invalid query, -1e6 for an invalid target; ties in slot
    order), then the boxes of the sorted runs at ``tiling``, the (rows,
    box) they cover."""

    def order(xy, valid, invalid_x):
        if not sort:
            n = valid.shape[-1]
            return torch.arange(n, device=valid.device).expand(valid.shape)
        return torch.argsort(torch.where(valid, xy[..., 0], invalid_x),
                             dim=-1, stable=True)

    qperm = order(q_xy, q_valid, 1e6)
    tperm = order(t_xy, t_valid, -1e6)
    rows, box = tiling
    return (qperm.to(torch.int32).contiguous(),
            tperm.to(torch.int32).contiguous(),
            _boxes(_take(q_xy, qperm), _take(q_valid, qperm), rows),
            _boxes(_take(t_xy, tperm), _take(t_valid, tperm), box))


def _order_launch(q_xy, q_valid, t_xy, t_valid, sort, B, N1, N2):
    rows, box = SWEEP_TILING
    dev = q_valid.device
    out = (torch.empty((B, N1), dtype=torch.int32, device=dev),
           torch.empty((B, N2), dtype=torch.int32, device=dev),
           torch.empty((B, 4, -(-N1 // rows)), dtype=torch.float32,
                       device=dev),
           torch.empty((B, 4, -(-N2 // box)), dtype=torch.float32,
                       device=dev))
    scratch = None
    if max(N1, N2) > MAX_SWEEP_SLOTS:
        scratch = torch.empty((B, 2, max(N1, N2)), dtype=torch.int64,
                              device=dev)
    _run("order", (q_xy, q_valid, t_xy, t_valid, *out, scratch, B, N1, N2,
                   rows, box, int(sort)), dev)
    launches["sweep_order"] += 1
    return out


def sweep_order(q_xy, q_valid, t_xy, t_valid, sort=True):
    """Both sides of B problems in stable x order, and the boxes the sweep
    kernel tests: (qperm (B, N1), tperm (B, N2) int32, sorted position ->
    slot; qbox (B, 4, ceil(N1 / rows)), tbox (B, 4, ceil(N2 / box))
    float32, rows [x_min, x_max, y_min, y_max] of the valid slots of the
    sorted query blocks and target runs at ``SWEEP_TILING``).  The keys
    are x, or +1e6 for an invalid query and -1e6 for an invalid target;
    ties keep slot order.  With
    ``sort`` False the permutations are the identity (slots already in
    order).  Any slot count: up to ``MAX_SWEEP_SLOTS`` a side one CTA of
    the order kernel sorts a side, above it each CTA a chunk and two more
    launches merge them and box.  CPU tensors take the plain version, CUDA
    tensors the order kernel."""
    if not _device_route(q_valid):
        return sweep_order_plain(q_xy, q_valid, t_xy, t_valid, sort)
    _check_tensors(q_valid.device, {"q_xy": q_xy, "t_xy": t_xy},
                   {"q_valid": q_valid, "t_valid": t_valid})
    B, N1 = q_valid.shape
    N2 = t_valid.shape[-1]
    _check_shapes({"q_xy": q_xy, "t_xy": t_xy, "t_valid": t_valid},
                  {"q_xy": (B, N1, 2), "t_xy": (B, N2, 2),
                   "t_valid": (B, N2)})
    if B > 65535:
        raise ValueError(f"the order kernel takes at most 65535 problems, "
                         f"got {B}")
    return _order_launch(q_xy, q_valid, t_xy, t_valid, sort, B, N1, N2)


def sweep_live(qbox, tbox, radius):
    """(B, n query blocks, n target runs) bool: the kernel's box test, an
    L1 gap between the boxes below the radius."""
    dx = torch.maximum(tbox[:, None, 0] - qbox[:, 1, :, None],
                       qbox[:, 0, :, None] - tbox[:, None, 1])
    dy = torch.maximum(tbox[:, None, 2] - qbox[:, 3, :, None],
                       qbox[:, 2, :, None] - tbox[:, None, 3])
    return dx.clamp(min=0.0) + dy.clamp(min=0.0) < radius


def sweep_plan(B, N1):
    """(query rows per block, CTAs per cluster) of a sweep kernel launch on
    B problems of N1 queries on the current CUDA device."""
    rows, split = ctypes.c_int(), ctypes.c_int()
    rc = _library()["plan"](B, N1, ctypes.byref(rows), ctypes.byref(split))
    if rc != 0:
        raise RuntimeError(f"fused_sweep_plan failed: cudaError_t {rc}")
    return rows.value, split.value


def sweep_columns(qbox, tbox, radius, N2, rows=SWEEP_TILING[0]):
    """(c0, c1), each (B, n query blocks) int64: the sorted target columns
    [c0, c1) the sweep kernel computes for each block of ``rows`` sorted
    queries (the union of its query boxes), from the first live run of
    target slots to the end of the last (c1 = c0 when none is live); it
    computes them in windows of ``SWEEP_WINDOW`` from c0."""
    box = SWEEP_TILING[1]
    k = rows // SWEEP_TILING[0]          # query boxes a block
    n = qbox.shape[-1]
    if k > 1:
        pad = -n % k
        inf = qbox.new_tensor(float("inf"))
        edge = torch.stack([inf, -inf, inf, -inf])[None, :, None]
        qbox = torch.cat([qbox, edge.expand(qbox.shape[0], 4, pad)], -1)
        qbox = qbox.reshape(qbox.shape[0], 4, -1, k)
        qbox = torch.stack([qbox[:, 0].amin(-1), qbox[:, 1].amax(-1),
                            qbox[:, 2].amin(-1), qbox[:, 3].amax(-1)], 1)
    live = sweep_live(qbox, tbox, radius)
    at = torch.arange(live.shape[-1], device=live.device)
    lo = torch.where(live, at, live.shape[-1]).amin(-1)
    hi = torch.where(live, at, -1).amax(-1)
    c0 = lo * box
    return c0, torch.where(hi < 0, c0, ((hi + 1) * box).clamp(max=N2))


def _through_order(sweep, q_xy, q_valid, q_d, t_xy, t_valid, t_d, F,
                   use_epi, qperm, tperm, sampson_thresh, radius):
    """``sweep`` on both sides gathered into the order (qperm, tperm), its
    result mapped back to the original slots (idx to a target slot)."""
    qperm, tperm = qperm.long(), tperm.long()
    srt = ([_take(x, qperm) for x in (q_xy, q_valid, q_d)]
           + [_take(x, tperm) for x in (t_xy, t_valid, t_d)])
    best_s, second_s, idx_s = sweep(*srt, F, use_epi, sampson_thresh,
                                    radius)

    def unsort(x):
        return torch.empty_like(x).scatter_(1, qperm, x)

    idx_s = unsort(idx_s)
    idx = torch.where(idx_s >= 0,
                      torch.gather(tperm, 1, idx_s.clamp(min=0).long()), -1)
    return unsort(best_s), unsort(second_s), idx.to(torch.int32)


def _sweep_launch(q_xy, q_valid, q_d, t_xy, t_valid, t_d, F, use_epi,
                  order, sampson_thresh, radius, B, N1, N2, D):
    best, second, idx = _outputs(B, N1, q_d.device)
    _run("sweep", (q_xy, q_valid, q_d, t_xy, t_valid, t_d, F, use_epi,
                   *order, best, second, idx, B, N1, N2, D, radius,
                   sampson_thresh), q_d.device)
    launches["fused_sweep_two_min"] += 1
    return best, second, idx


def swept_two_min(q_xy, q_valid, q_d, t_xy, t_valid, t_d, F, use_epi,
                  order, sampson_thresh=1.0, radius=80.0):
    """``fused_gated_two_min`` with both sides read in ``order``, the
    result of ``sweep_order``: best, second and idx at the original query
    slots, idx an original target slot, and among equal distances the
    lowest target in the order wins.  CPU tensors take the plain version
    (gather, ``fused_sweep_two_min_plain``, map back); CUDA tensors the
    sweep kernel alone."""
    qperm, tperm, qbox, tbox = order
    if not _device_route(q_d):
        return _through_order(fused_sweep_two_min_plain, q_xy, q_valid, q_d,
                              t_xy, t_valid, t_d, F, use_epi, qperm, tperm,
                              sampson_thresh, radius)
    B, N1, N2, D = _check(q_xy, q_valid, q_d, t_xy, t_valid, t_d, F,
                          use_epi)
    rows, box = SWEEP_TILING
    for name, x, shape, dtype in (
            ("qperm", qperm, (B, N1), torch.int32),
            ("tperm", tperm, (B, N2), torch.int32),
            ("qbox", qbox, (B, 4, -(-N1 // rows)), torch.float32),
            ("tbox", tbox, (B, 4, -(-N2 // box)), torch.float32)):
        if (x.device != q_d.device or x.dtype != dtype
                or tuple(x.shape) != shape or not x.is_contiguous()):
            raise ValueError(f"{name}: expected a contiguous {dtype} tensor "
                             f"{shape} on {q_d.device}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    if B * N1 == 0:
        return _outputs(B, N1, q_d.device)
    return _sweep_launch(q_xy, q_valid, q_d, t_xy, t_valid, t_d, F, use_epi,
                         order, sampson_thresh, radius, B, N1, N2, D)


def _sweep_route(q_xy, q_valid, q_d, t_xy, t_valid, t_d, F, use_epi,
                 sampson_thresh, radius, sort):
    """The order kernel, then the sweep kernel: two launches (four above
    ``MAX_SWEEP_SLOTS`` slots a side, where the order takes three)."""
    B, N1, N2, D = _check(q_xy, q_valid, q_d, t_xy, t_valid, t_d, F,
                          use_epi)
    if B * N1 == 0:
        return _outputs(B, N1, q_d.device)
    order = _order_launch(q_xy, q_valid, t_xy, t_valid, sort, B, N1, N2)
    return _sweep_launch(q_xy, q_valid, q_d, t_xy, t_valid, t_d, F, use_epi,
                         order, sampson_thresh, radius, B, N1, N2, D)


def fused_sweep_two_min(q_xy, q_valid, q_d, t_xy, t_valid, t_d, F, use_epi,
                        sampson_thresh=1.0, radius=80.0):
    """``fused_gated_two_min`` on slots sorted by x, by the sweep kernel.

    The arguments are those of ``fused_gated_two_min``.  On the card the
    order kernel boxes the slots as given (no sort), then the sweep kernel
    runs: two launches, one of each.
    """
    if not _device_route(q_d):
        return fused_sweep_two_min_plain(q_xy, q_valid, q_d, t_xy, t_valid,
                                         t_d, F, use_epi, sampson_thresh,
                                         radius)
    return _sweep_route(q_xy, q_valid, q_d, t_xy, t_valid, t_d, F, use_epi,
                        sampson_thresh, radius, sort=False)


def sorted_fused_two_min(q_xy, q_valid, q_d, t_xy, t_valid, t_d, F, use_epi,
                         sampson_thresh=1.0, radius=80.0, sweep=None):
    """``fused_gated_two_min`` semantics through the sweep: both sides
    sorted by x (``sweep_order``), the result at the original slots (idx
    into the original target slots).  Among equal distances the lowest
    x-sorted target wins.  On CUDA tensors: the order kernel and the sweep
    kernel.  ``sweep`` replaces the sweep (the plain version on the card,
    for comparison): the sides are then sorted by ``torch.argsort``,
    gathered, swept and mapped back.  Any slot count."""
    if sweep is None:
        if _device_route(q_d):
            return _sweep_route(q_xy, q_valid, q_d, t_xy, t_valid, t_d, F,
                                use_epi, sampson_thresh, radius, sort=True)
        sweep = fused_sweep_two_min_plain
    qperm, tperm, _, _ = sweep_order_plain(q_xy, q_valid, t_xy, t_valid)
    return _through_order(sweep, q_xy, q_valid, q_d, t_xy, t_valid, t_d, F,
                          use_epi, qperm, tperm, sampson_thresh, radius)
