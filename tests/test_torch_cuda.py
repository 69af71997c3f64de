"""Card-only tests of libviso_torch: the CUDA kernels (L1 distance, fused
gated matcher, and the sweep's order and sweep kernels) against their
plain versions, and the pipeline and multi-stream serving on the card
against the CPU and the solo runs, and the mono path on the card: the
5-point solver's batch invariance and the three matcher routes on the same
draws; loop closure on the card: the three routes give one
``LoopEngine.offer`` result, and a loop-mode resume is bit-exact;
windowed bundle adjustment on the card: the BA equals its CPU run and makes
no host sync, the inverted match map keeps the last writer, the three
routes give one windowed run, and a windowed resume is bit-exact; the
parallel layer and the matcher variants on the card: the tensor-parallel
matcher equals the local one at (1280, 1280, 128) with k launches a
problem, the 'l2q8' cross term equals the CPU's and the int64 product,
the banded matcher equals the dense one on a KITTI-size frame up to
distance ties, the landmark-sharded BA makes no host sync, and
StreamPipeline on two CUDA streams equals the serial run; the profiling
layer on the card: its peak row, its device clock, and profile_matcher
through the L1 kernel; and bench_torch.py's default mode on the card.

Every test is marked ``cuda`` and skips without a card.  The file imports
no JAX, so it runs on a machine that has none; the suite's conftest.py
does import JAX, hence on the card's machine:

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

Tolerances: the kernels equal their plain versions bitwise on
integer-valued descriptors (every sum is an integer below 2^24, exact in
float32 in any order; the fused kernels' gates are the plain version's
expressions, rounded alike) and within rtol 1e-5 on random floats (sums in
another order); card and CPU pipelines agree on every discrete per-frame
output and within atol 1e-4 on the motions.  The problem count 46 is a
16-frame window's (16 stereo and 30 temporal problems,
``pipeline/batched.py``), the largest the port's paths stack.
"""

import dataclasses
import json
import math

import numpy as np
import pytest
import torch

from libviso_torch.config import Calib, PipelineConfig
from libviso_torch.geometry.mvg import F_from_P_host
from libviso_torch.ops import cuda_matching as cm
from libviso_torch.ops import fused_matching as fm
from libviso_torch.pipeline.batched import build_batched_odometry
from libviso_torch.pipeline.multistream import run_multistream
from libviso_torch.pipeline.stereo import run_stereo_sequence
from libviso_torch.solvers.ransac import frame_generator, sample_gumbel
from libviso_torch.synthetic import generate_sequence, kitti_projections

pytestmark = pytest.mark.cuda


def require_cuda():
    """Skip where torch sees no card (decided in the test body, so every
    xdist worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _pair(shape1, shape2, integer, seed=0):
    rng = np.random.default_rng(seed)
    if integer:
        a = rng.integers(-1020, 1021, size=shape1)
        b = rng.integers(-1020, 1021, size=shape2)
    else:
        a = rng.normal(size=shape1) * 100
        b = rng.normal(size=shape2) * 100
    return (torch.tensor(a, dtype=torch.float32, device="cuda"),
            torch.tensor(b, dtype=torch.float32, device="cuda"))


@pytest.mark.parametrize("shapes,integer", [
    (((3, 1280, 128), (3, 1280, 128)), True),
    (((3, 1280, 128), (3, 1280, 128)), False),
    (((12, 1280, 128), (12, 1280, 128)), True),
    (((46, 1280, 128), (46, 1280, 128)), True),   # a 16-frame window's
    (((1, 1280, 128), (1, 1280, 128)), True),
    (((2, 1000, 128), (2, 777, 128)), True),
    (((2, 1000, 128), (2, 777, 128)), False),
    (((3, 1280, 124), (3, 1280, 124)), True),
    (((1, 5, 4), (1, 3, 4)), True),
    (((1, 1536, 384), (1, 1536, 384)), True),     # a mono match problem
    (((1, 1536, 384), (1, 1536, 384)), False),
    (((128, 256, 128), (128, 256, 128)), True),   # the loop store
    (((20, 256, 128), (20, 256, 128)), True),     # the mono loop's store
])
def test_kernel_matches_plain(shapes, integer):
    require_cuda()
    a, b = _pair(*shapes, integer)
    before = cm.launches
    out = cm.l1_distance_matrix(a, b)
    torch.cuda.synchronize()
    assert cm.launches == before + 1
    ref = cm.l1_distance_matrix_plain(a, b)
    if integer:
        assert torch.equal(out, ref)
    else:
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=0.0)


def test_kernel_matches_plain_on_zero_targets():
    """Invalid slots carry zero descriptors: an all-invalid target side."""
    require_cuda()
    a, b = _pair((3, 1280, 128), (3, 1280, 128), True)
    b.zero_()
    assert torch.equal(cm.l1_distance_matrix(a, b),
                       cm.l1_distance_matrix_plain(a, b))


def test_kernel_takes_unbatched_descriptors():
    require_cuda()
    a, b = _pair((300, 128), (200, 128), True)
    assert torch.equal(cm.l1_distance_matrix(a, b),
                       cm.l1_distance_matrix_plain(a, b))


def test_kernel_rejects_what_it_does_not_take():
    require_cuda()
    a, b = _pair((1, 64, 128), (1, 64, 128), True)
    with pytest.raises(TypeError):
        cm.l1_distance_matrix(a.double(), b.double())
    with pytest.raises(ValueError, match="contiguous"):
        cm.l1_distance_matrix(a.transpose(1, 2), b.transpose(1, 2))
    with pytest.raises(ValueError, match="D % 4"):
        cm.l1_distance_matrix(a[..., :126].contiguous(),
                              b[..., :126].contiguous())


def test_card_run_matches_cpu_run():
    require_cuda()
    seq = generate_sequence(num_frames=4, num_points=500, seed=3, width=416,
                            height=160)
    cfg = PipelineConfig().with_metric("l1")
    cpu = run_stereo_sequence(seq.frames, seq.P1, seq.P2, cfg, device="cpu")
    before = cm.launches
    gpu = run_stereo_sequence(seq.frames, seq.P1, seq.P2, cfg,
                              device="cuda")
    assert cm.launches == before + len(seq.frames)
    keys = ("ok", "num_lr", "num_circle", "num_inliers")
    for a, b in zip(gpu.stats, cpu.stats):
        assert {k: a[k] for k in keys} == {k: b[k] for k in keys}
    assert gpu.frame_ok[1:].all()
    np.testing.assert_allclose(gpu.motions, cpu.motions, atol=1e-4)


def _match_problem(B, N1, N2, D, seed=0, device="cuda"):
    """B match problems of a rectified KITTI-size pair: queries at integer
    pixel positions of a 1241 x 376 image, each target a query moved by an
    integer disparity of 0-60 px and a row jitter of -1, 0 or 1 px (so the
    Sampson gate, at most 0.5 here, admits it), descriptors in {0, ..., 3}
    (exact distance ties occur), F of KITTI's P0/P1, and the Sampson gate
    on every other problem from the second."""
    rng = np.random.default_rng(seed)
    q_xy = np.round(rng.uniform(0, [1240, 375], (B, N1, 2)))
    src = np.stack([rng.choice(N1, N2, replace=N2 > N1) for _ in range(B)])
    shift = np.stack([-rng.integers(0, 61, (B, N2)),
                      rng.integers(-1, 2, (B, N2))], -1)
    t_xy = np.clip(np.take_along_axis(q_xy, src[..., None], 1) + shift, 0,
                   [1240, 375])
    F = np.tile(F_from_P_host(*kitti_projections()), (B, 1, 1))
    dev = lambda x: torch.tensor(x, device=device)  # noqa: E731
    return [dev(q_xy.astype(np.float32)), dev(rng.random((B, N1)) > 0.1),
            dev(rng.integers(0, 4, (B, N1, D)).astype(np.float32)),
            dev(t_xy.astype(np.float32)), dev(rng.random((B, N2)) > 0.1),
            dev(rng.integers(0, 4, (B, N2, D)).astype(np.float32)),
            dev(F.astype(np.float32)), dev(np.arange(B) % 2 == 1)]


FUSED = [("fused_gated_two_min", fm.fused_gated_two_min, None),
         ("fused_sweep_two_min", fm.sorted_fused_two_min,
          fm.fused_sweep_two_min_plain)]


@pytest.mark.parametrize("kernel", FUSED, ids=lambda k: k[0])
@pytest.mark.parametrize("shape", [(3, 1280, 1280, 128),
                                   (12, 1280, 1280, 128),
                                   (46, 1280, 1280, 128),
                                   (1, 1280, 1280, 128),
                                   (2, 1000, 777, 128), (3, 1280, 1280, 124),
                                   (1, 5, 3, 4),
                                   (1, 1536, 1536, 384),   # mono's
                                   (2, 1536, 1536, 384),
                                   (128, 256, 256, 128),   # the loop store
                                   (20, 256, 256, 128),    # the mono loop's
                                   (1, 256, 256, 128)])    # a guided match
def test_fused_kernels_match_plain_bitwise(kernel, shape):
    require_cuda()
    name, fn, plain_sweep = kernel
    args = _match_problem(*shape)
    before = fm.launches[name]
    got = fn(*args, 1.0, 80.0)
    torch.cuda.synchronize()
    assert fm.launches[name] == before + 1
    if plain_sweep is None:
        want = fm.fused_gated_two_min_plain(*args, 1.0, 80.0)
    else:
        want = fm.sorted_fused_two_min(*args, 1.0, 80.0, sweep=plain_sweep)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    if shape[1] >= 1000:        # a real workload, not empty rows
        assert torch.isfinite(got[0]).float().mean() > 0.5
        if shape[0] > 1:        # the Sampson problems too
            assert torch.isfinite(got[0][args[7]]).float().mean() > 0.5


@pytest.mark.parametrize("kernel", FUSED, ids=lambda k: k[0])
def test_fused_kernels_on_all_invalid_targets(kernel):
    require_cuda()
    name, fn, _ = kernel
    args = _match_problem(3, 1280, 1280, 128)
    args[4] = torch.zeros_like(args[4])
    best, second, idx = fn(*args, 1.0, 80.0)
    assert torch.isinf(best).all() and torch.isinf(second).all()
    assert (idx == -1).all()
    want = fm.fused_gated_two_min_plain(*args, 1.0, 80.0)
    for x, y in zip((best, second, idx), want):
        assert torch.equal(x, y)


def test_fused_gated_tie_across_target_splits_goes_to_lowest_column():
    """Targets 640-1279 repeat targets 0-639 (descriptors and positions),
    so every row's best distance is tied between a column of the first
    half and one of the second, which lie in different CTAs of a cluster
    whatever its size: the merge must keep the lower column."""
    require_cuda()
    args = _match_problem(3, 1280, 1280, 128)
    for k in (3, 4, 5):
        args[k][:, 640:] = args[k][:, :640]
    got = fm.fused_gated_two_min(*args, 1.0, 80.0)
    want = fm.fused_gated_two_min_plain(*args, 1.0, 80.0)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    has = got[2] >= 0
    assert has.float().mean() > 0.5
    assert (got[2][has] < 640).all()
    assert torch.equal(got[0][has], got[1][has])   # the tie itself


def test_fused_gated_raises_on_a_refused_launch():
    """D = 2048 asks for 256 KB of resident query descriptors, more shared
    memory than a CTA may have: the launch is refused and the wrapper
    raises with its cudaError_t."""
    require_cuda()
    args = _match_problem(1, 64, 64, 2048)
    before = fm.launches["fused_gated_two_min"]
    with pytest.raises(RuntimeError, match="cudaError_t"):
        fm.fused_gated_two_min(*args, 1.0, 80.0)
    assert fm.launches["fused_gated_two_min"] == before


@pytest.mark.parametrize("shape", [(3, 1280, 1280, 128),
                                   (12, 1280, 1280, 128),
                                   (46, 1280, 1280, 128),
                                   (1, 1280, 1280, 128),
                                   (2, 1000, 777, 128), (3, 1280, 1280, 124),
                                   (1, 5, 3, 4)])
def test_sweep_order_matches_plain_bitwise(shape):
    """The order kernel's permutations and boxes equal its plain version's
    (argsort, gathers, amin / amax), sorted and unsorted, with both sides
    valid and with an all-invalid side."""
    require_cuda()
    q_xy, q_valid, _, t_xy, t_valid = _match_problem(*shape)[:5]
    for qv, tv in ((q_valid, t_valid), (torch.zeros_like(q_valid), t_valid),
                   (q_valid, torch.zeros_like(t_valid))):
        for sort in (True, False):
            before = fm.launches["sweep_order"]
            got = fm.sweep_order(q_xy, qv, t_xy, tv, sort)
            torch.cuda.synchronize()
            assert fm.launches["sweep_order"] == before + 1
            want = fm.sweep_order_plain(q_xy, qv, t_xy, tv, sort)
            for x, y in zip(got, want):
                assert x.dtype == y.dtype and torch.equal(x, y)


def test_sweep_tie_across_target_splits_goes_to_lowest_sorted_column():
    """Targets 640-1279 repeat targets 0-639 (descriptors and validity) 40
    px further left, so each sorts before the slot it repeats, tens of
    sorted columns away: a row near both ties between two columns that
    often lie in different windows and different CTAs of a cluster.  The
    lower sorted column must win, which is the higher target slot; a merge
    by slot would pick the other."""
    require_cuda()
    args = _match_problem(3, 1280, 1280, 128)
    for k in (3, 4, 5):
        args[k][:, 640:] = args[k][:, :640]
    args[3][:, 640:, 0] -= 40
    got = fm.sorted_fused_two_min(*args, 1.0, 80.0)
    want = fm.sorted_fused_two_min(*args, 1.0, 80.0,
                                   sweep=fm.fused_sweep_two_min_plain)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    has = got[2] >= 0
    assert has.float().mean() > 0.5
    tie = has & (got[0] == got[1])
    assert tie.float().mean() > 0.2
    assert (got[2][tie] >= 640).float().mean() > 0.5


def test_sweep_route_is_two_device_launches():
    """One sorted_fused_two_min call on CUDA tensors runs exactly two
    device activities, the order kernel and the sweep kernel, by
    torch.profiler through the checked reader (``profiling.traced``, a
    warm-up call and a traced one); the counts of both wrappers rise by
    one a call."""
    require_cuda()
    from libviso_torch.utils import profiling

    args = _match_problem(3, 1280, 1280, 128)
    before = dict(fm.launches)
    names = profiling.device_activities(profiling.traced(
        lambda: fm.sorted_fused_two_min(*args, 1.0, 80.0)))
    assert len(names) == 2, names
    assert any("sweep_order" in n for n in names)
    assert any("fused_sweep" in n for n in names)
    assert fm.launches["sweep_order"] == before["sweep_order"] + 2
    assert fm.launches["fused_sweep_two_min"] == \
        before["fused_sweep_two_min"] + 2


def test_sweep_raises_on_a_refused_launch():
    """D = 2048 asks the sweep kernel for 512 KB of resident query
    descriptors: the launch is refused and the wrapper raises with its
    cudaError_t."""
    require_cuda()
    args = _match_problem(1, 64, 64, 2048)
    before = fm.launches["fused_sweep_two_min"]
    with pytest.raises(RuntimeError, match="cudaError_t"):
        fm.sorted_fused_two_min(*args, 1.0, 80.0)
    assert fm.launches["fused_sweep_two_min"] == before


@pytest.mark.parametrize("n1,n2,sort", [
    (fm.MAX_SWEEP_SLOTS + 1, 64, True), (9000, 9000, True),
    (20000, 3000, True), (20000, 17000, False)])
def test_order_kernel_above_one_cta(n1, n2, sort):
    """Above MAX_SWEEP_SLOTS slots a side the order kernel sorts chunks in
    CTAs and merges them (three launches, one count): bitwise its plain
    version, with many equal x, invalid slots and NaN coordinates."""
    require_cuda()
    g = torch.Generator(device="cuda").manual_seed(n1 + n2)

    def side(n):
        xy = torch.randint(0, 64, (2, n, 2), generator=g,
                           device="cuda").float()
        xy[:, ::97] = float("nan")
        valid = torch.rand((2, n), generator=g, device="cuda") > 0.2
        return xy, valid

    sides = (*side(n1), *side(n2))
    before = fm.launches["sweep_order"]
    got = fm.sweep_order(*sides, sort=sort)
    assert fm.launches["sweep_order"] == before + 1
    want = fm.sweep_order_plain(*sides, sort=sort)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


@pytest.mark.parametrize("shape", [(1, 9000, 9000, 128),
                                   (2, 1280, 8300, 128)])
def test_sweep_route_above_the_order_kernel_limit(shape):
    """Above MAX_SWEEP_SLOTS slots a side the route is the same two
    kernels, the order kernel merging sorted chunks: bitwise its plain
    version."""
    require_cuda()
    args = _match_problem(*shape)
    before = dict(fm.launches)
    got = fm.sorted_fused_two_min(*args, 1.0, 80.0)
    torch.cuda.synchronize()
    assert fm.launches["fused_sweep_two_min"] == \
        before["fused_sweep_two_min"] + 1
    assert fm.launches["sweep_order"] == before["sweep_order"] + 1
    want = fm.sorted_fused_two_min(*args, 1.0, 80.0,
                                   sweep=fm.fused_sweep_two_min_plain)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert torch.isfinite(got[0]).float().mean() > 0.5


def test_fused_kernels_reject_what_they_do_not_take():
    require_cuda()
    args = _match_problem(1, 64, 64, 128)
    for fn in (fm.fused_gated_two_min, fm.fused_sweep_two_min):
        bad = list(args)
        bad[2] = bad[2].double()
        with pytest.raises(TypeError):
            fn(*bad)
        bad = list(args)
        bad[2] = bad[2].transpose(1, 2).contiguous().transpose(1, 2)
        with pytest.raises(ValueError, match="contiguous"):
            fn(*bad)
        bad = list(args)
        buf = torch.empty(64 * 128 + 1, device="cuda")
        bad[5] = buf[1:].view(1, 64, 128).copy_(args[5])
        with pytest.raises(ValueError, match="aligned"):
            fn(*bad)
        bad = list(args)
        bad[7] = bad[7].float()
        with pytest.raises(TypeError):
            fn(*bad)


@pytest.mark.parametrize("backend,kernel", [
    ("dense", "l1_distance_matrix"), ("fused", "fused_gated_two_min"),
    ("sweep", "fused_sweep_two_min")])
def test_run_multistream_launches_once_per_timestep(backend, kernel):
    require_cuda()
    seqs = [generate_sequence(num_frames=n, num_points=500, seed=s,
                              width=416, height=160)
            for s, n in enumerate((3, 2))]
    cfg = PipelineConfig().with_metric("l1")
    solos = [run_stereo_sequence(sq.frames, sq.P1, sq.P2, cfg, seed=s,
                                 device="cuda", backend=backend)
             for s, sq in enumerate(seqs)]

    def count():
        return {"l1_distance_matrix": cm.launches, **fm.launches}[kernel]

    before = count()
    multi = run_multistream([sq.frames for sq in seqs],
                            [sq.P1 for sq in seqs], [sq.P2 for sq in seqs],
                            cfg, device="cuda", backend=backend)
    assert count() == before + 3
    keys = ("frame", "ok", "num_kp1", "num_lr", "num_circle", "num_inliers")
    for got, solo in zip(multi, solos):
        assert [{k: x[k] for k in keys} for x in got.stats] == \
            [{k: x[k] for k in keys} for x in solo.stats]
        np.testing.assert_allclose(got.motions, solo.motions, atol=5e-6)


@pytest.mark.parametrize("backend,kernel", [
    ("dense", "l1_distance_matrix"), ("fused", "fused_gated_two_min"),
    ("sweep", "fused_sweep_two_min")])
def test_batched_window_launches_twice_and_equals_streaming(backend, kernel):
    """A 16-frame window is two matcher calls (16 stereo and 30 temporal
    problems, 46 in all), so two launches of the backend's kernel, and on
    the same draws frames 1..15 have the streaming run's discrete stats."""
    require_cuda()
    T = 16
    seq = generate_sequence(num_frames=T, num_points=500, seed=2, width=416,
                            height=160)
    cfg = PipelineConfig().with_metric("l1")
    shape = (cfg.ransac.num_hypotheses, cfg.detector.num_slots)
    draws = torch.stack([sample_gumbel(shape, frame_generator(0, t))
                         for t in range(1, T)])
    ims = [torch.tensor(np.stack([np.asarray(f[v]) for f in seq.frames]),
                        device="cuda") for v in (0, 1)]
    fn = build_batched_odometry(
        Calib.from_projections(seq.P1, seq.P2),
        torch.as_tensor(F_from_P_host(seq.P1, seq.P2), dtype=torch.float32,
                        device="cuda"), cfg, backend=backend)

    def count():
        return {"l1_distance_matrix": cm.launches, **fm.launches}[kernel]

    before = count()
    out = fn(*ims, draws.cuda())
    torch.cuda.synchronize()
    assert count() == before + 2
    stream = run_stereo_sequence(seq.frames, seq.P1, seq.P2, cfg, seed=0,
                                 device="cuda", backend=backend)
    for t in range(1, T):
        st = stream.stats[t]
        assert (bool(out.ok[t]), int(out.num_circle[t]),
                int(out.num_inliers[t]), int(out.num_lr[t])) == \
            (st["ok"], st["num_circle"], st["num_inliers"], st["num_lr"]), t
    np.testing.assert_allclose(out.motions.cpu().numpy()[1:],
                               stream.motions[1:], atol=1e-4)


def test_chunked_and_resumed_runs_equal_the_plain_run_on_the_card(tmp_path):
    require_cuda()
    from libviso_torch.utils.checkpoint import CheckpointManager

    seq = generate_sequence(num_frames=7, num_points=500, seed=2, width=416,
                            height=160)
    cfg = PipelineConfig().with_metric("l1")
    run = lambda frames, **kw: run_stereo_sequence(  # noqa: E731
        frames, seq.P1, seq.P2, cfg, seed=0, device="cuda",
        backend="sweep", **kw)
    want = run(seq.frames)
    mgr = CheckpointManager(str(tmp_path), every=3)
    run(seq.frames[:4], chunk=3, checkpoint=mgr)
    for got in (run(seq.frames, chunk=3),
                run(seq.frames, chunk=3, checkpoint=mgr)):
        assert got.stats == want.stats
        np.testing.assert_array_equal(got.motions, want.motions)
        np.testing.assert_array_equal(got.poses, want.poses)


def _mono_cfg():
    """tests/test_mono.py's mono_config(), in the port's classes, under
    metric l1."""
    from libviso_torch.config import DetectorConfig, MatchConfig

    return PipelineConfig(
        detector=DetectorConfig(max_features=480, nbinx=8, nbiny=4,
                                num_slots=512, descriptor_radius=5),
        temporal_match=MatchConfig(radius=60.0, use_ratio=True, ratio=0.9),
    ).with_metric("l1")


def test_five_point_batch_invariant_on_card():
    """A sample's candidates alone equal its row of a 64-sample batch bit
    for bit (the SVD, the 10x10 solve and the 3x3 polish solves run a lone
    sample as a batch of two; small products and sums are tree sums)."""
    require_cuda()
    from libviso_torch.geometry.five_point import five_point_E

    rng = np.random.default_rng(0)
    x1 = torch.tensor(rng.uniform(-0.5, 0.5, (64, 5, 2)), dtype=torch.float32,
                      device="cuda")
    x2 = x1 + torch.tensor(rng.normal(size=(64, 5, 2)) * 0.02,
                           dtype=torch.float32, device="cuda")
    E, v = five_point_E(x1, x2)
    assert bool(v.any())
    for h in (0, 31, 63):
        Eh, vh = five_point_E(x1[h:h + 1], x2[h:h + 1])
        assert torch.equal(Eh[0], E[h]) and torch.equal(vh[0], v[h]), h
    E32, v32 = five_point_E(x1[:32], x2[:32])
    assert torch.equal(E32, E[:32]) and torch.equal(v32, v[:32])


def test_mono_backends_agree_and_launch_twice_a_frame():
    """run_mono_sequence under metric l1 with each matcher backend on the
    same draws: the same discrete per-frame stats, each backend's kernels
    launched twice a frame (temporal match and re-match); the card's run
    solves every frame, as the CPU's, with a Sim(3) ATE within
    max(1.5 c, c + 0.02 m) of the CPU's c (card and CPU are not held equal
    on discrete stats: near-tied RANSAC candidates fall either way)."""
    require_cuda()
    from libviso_torch.pipeline.mono import run_mono_sequence
    from libviso_torch.utils.metrics import ate_rmse

    seq = generate_sequence(num_frames=6, num_points=600, seed=13, width=416,
                            height=160, speed=0.6, yaw_rate=0.01)
    frames, K = [f[0] for f in seq.frames], seq.P1[:, :3]
    kernels = {"dense": [(cm, "launches")],
               "fused": [(fm.launches, "fused_gated_two_min")],
               "sweep": [(fm.launches, "sweep_order"),
                         (fm.launches, "fused_sweep_two_min")]}

    def count(where, key):
        return where[key] if isinstance(where, dict) else getattr(where, key)

    stats = {}
    for backend, counters in kernels.items():
        before = [count(*c) for c in counters]
        res = run_mono_sequence(frames, K, _mono_cfg(), device="cuda",
                                backend=backend)
        after = [count(*c) for c in counters]
        assert [a - b for a, b in zip(after, before)] == \
            [2 * len(frames)] * len(counters), backend
        stats[backend] = [{k: s[k] for k in ("ok", "num_matches",
                                             "num_inliers", "scale_support")}
                          for s in res.stats]
        assert res.frame_ok[1:].all(), backend
        if backend == "dense":
            gpu = res
    assert stats["fused"] == stats["dense"] == stats["sweep"]
    cpu = run_mono_sequence(frames, K, _mono_cfg(), device="cpu")
    assert cpu.frame_ok[1:].all()
    c = ate_rmse(cpu.poses, seq.gt_poses, align="sim3")
    assert ate_rmse(gpu.poses, seq.gt_poses, align="sim3") <= max(1.5 * c,
                                                                  c + 0.02)


def _loop_circle():
    """tests/test_loop_closure.py's 48-frame circle (416x160) and its
    tiny_config() in the port's classes."""
    from libviso_torch.config import DetectorConfig, RansacConfig

    T = 48
    yaw = 2 * np.pi / (T - 1)
    steps = np.zeros((T, 6))
    steps[1:] = [0.0, yaw, 0.0, 0.0, 0.0, 2 * 10.0 * np.sin(yaw / 2)]
    seq = generate_sequence(num_frames=T, num_points=1400, seed=3,
                            width=416, height=160, trajectory=steps)
    cfg = PipelineConfig(
        detector=DetectorConfig(max_features=240, nbinx=8, nbiny=3,
                                num_slots=256),
        ransac=RansacConfig(num_hypotheses=32, gn_iters=50))
    return seq, cfg


LOOP_KW = dict(keyframe_every=4, min_gap=24, min_matches=40, min_inliers=20,
               seed=0)


def test_loop_engine_backends_agree_on_the_card():
    """One store (the keyframes of frames 0-40 of the circle under metric
    l1) and one offer of frame 44's keyframe under each matcher route: the
    same candidate list and loop edge, one launch of the route's kernels
    for the candidate search and one for each guided match."""
    require_cuda()
    from libviso_torch.pipeline import loop as tl
    from libviso_torch.pipeline.stereo import build_frame_step, empty_state

    seq, cfg = _loop_circle()
    cfg = cfg.with_metric("l1")
    calib = Calib.from_projections(seq.P1, seq.P2)
    F = torch.as_tensor(F_from_P_host(seq.P1, seq.P2), dtype=torch.float32,
                        device="cuda")
    step = build_frame_step(calib, F, cfg)
    summarize = tl._build_summarize(256, cfg.detector.descriptor_dim, True)
    state = empty_state(cfg, "cuda")
    shape = (cfg.ransac.num_hypotheses, cfg.detector.num_slots)
    keyframes = {}
    for t in range(45):
        state, _ = step(state, *(torch.tensor(im, device="cuda")
                                 for im in seq.frames[t]),
                        sample_gumbel(shape, frame_generator(0, t)).cuda())
        if t % 4 == 0:
            keyframes[t] = summarize(state)
    counters = {"dense": ["l1"], "fused": ["fused_gated_two_min"],
                "sweep": ["sweep_order", "fused_sweep_two_min"]}
    results = {}
    for backend, names in counters.items():
        eng = tl.LoopEngine(cfg, calib, 0, device="cuda", backend=backend,
                            **{k: v for k, v in LOOP_KW.items()
                               if k != "seed"})
        for t in range(0, 44, 4):
            eng.offer(t, *keyframes[t], lambda: np.zeros(3, np.float32))
        before = {n: cm.launches if n == "l1" else fm.launches[n]
                  for n in names}
        eng.offer(44, *keyframes[44], lambda: np.zeros(3, np.float32))
        torch.cuda.synchronize()
        calls = 1 + sum(len(c.get("refine_trace", ())) + (
            1 if len(c.get("refine_trace", ())) == 2 else 0)
            for c in eng.candidates if c["frame_new"] == 44)
        for n in names:
            now = cm.launches if n == "l1" else fm.launches[n]
            assert now - before[n] == calls, (backend, n)
        results[backend] = (
            [{k: c[k] for k in ("frame_new", "frame_old", "score", "ok",
                                "num_inliers", "refined_inliers")}
             for c in eng.candidates],
            [(le.frame_new, le.frame_old, le.num_inliers, le.tr.tolist())
             for le in eng.loops])
    assert results["fused"] == results["dense"] == results["sweep"]
    assert results["dense"][1] and results["dense"][1][0][:2] == (44, 0)


def test_loop_resume_on_the_card_equals_the_uninterrupted_run(tmp_path):
    """The 48-frame circle in loop mode on the card, cut at frame 30 by a
    checkpoint and resumed: the uninterrupted run's loops, stats and poses
    bit for bit."""
    require_cuda()
    from libviso_torch.pipeline.loop import run_with_loop_closure
    from libviso_torch.utils.checkpoint import CheckpointManager

    seq, cfg = _loop_circle()
    frames = list(seq.frames)
    run = lambda frames, **kw: run_with_loop_closure(  # noqa: E731
        frames, seq.P1, seq.P2, cfg, device="cuda", **LOOP_KW, **kw)
    want = run(frames)
    assert want.loops
    mgr = CheckpointManager(str(tmp_path), every=20)
    run(frames[:30], checkpoint=mgr)
    got = run(frames, checkpoint=mgr)
    assert got.processed == len(frames) - 30
    assert got.stats == want.stats and got.candidates == want.candidates
    assert [(le.frame_new, le.frame_old, le.num_inliers) for le in got.loops] \
        == [(le.frame_new, le.frame_old, le.num_inliers) for le in want.loops]
    np.testing.assert_array_equal(got.poses, want.poses)
    assert got.graph_cost == want.graph_cost


def _ba_window(W=8, L=1280, seed=0):
    """A BA window at the pipeline's width (numpy from a seed, the
    generator of tests/test_bundle_adjust.py's make_window): W cameras
    driving forward over L landmarks, 0.3 px of noise, 85 % visible; the
    start perturbed.  Returns CPU tensors (poses0, X0, obs, mask) and the
    calibration."""
    from libviso_torch.solvers.gauss_newton import stereo_predict

    rng = np.random.default_rng(seed)
    calib = Calib(f=718.856, cu=607.19, cv=185.22, base=0.537)
    X = np.stack([rng.uniform(-15, 15, L), rng.uniform(-3, 3, L),
                  rng.uniform(8, 60, L)], axis=-1)
    poses = np.array([[0.002 * k, -0.004 * k, 0.001 * k, 0.02 * k,
                       -0.01 * k, -0.8 * k] for k in range(W)])
    obs, _ = stereo_predict(torch.tensor(poses, dtype=torch.float32),
                            torch.tensor(X, dtype=torch.float32), calib)
    obs = obs + 0.3 * torch.tensor(rng.normal(size=obs.shape),
                                   dtype=torch.float32)
    mask = rng.uniform(size=(W, L)) < 0.85
    mask[0] = True
    poses0 = poses + 0.01 * rng.normal(size=poses.shape)
    poses0[0] = poses[0]
    X0 = X + 0.05 * rng.normal(size=X.shape)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    return (f32(poses0), f32(X0), obs, torch.tensor(mask)), calib


def test_bundle_adjust_on_the_card_equals_the_cpu_run():
    """(W, L) = (8, 1280), the default window at the default slot count:
    within tests/test_torch_bundle_adjust.py's tolerances of the CPU run."""
    require_cuda()
    from libviso_torch.solvers.bundle_adjust import bundle_adjust

    args, calib = _ba_window()
    cpu = bundle_adjust(*args, calib, iters=10)
    gpu = bundle_adjust(*(a.cuda() for a in args), calib, iters=10)
    np.testing.assert_allclose(gpu.poses.cpu(), cpu.poses, atol=1e-4)
    np.testing.assert_allclose(gpu.landmarks.cpu(), cpu.landmarks,
                               atol=1e-3, rtol=2e-4)
    np.testing.assert_allclose(float(gpu.initial_cost),
                               float(cpu.initial_cost), rtol=1e-5)
    np.testing.assert_allclose(float(gpu.cost), float(cpu.cost), rtol=1e-4,
                               atol=1e-8)
    assert float(gpu.cost) < float(gpu.initial_cost)


def test_bundle_adjust_makes_no_host_sync():
    """After a first call (which loads the solver libraries), a call at
    (8, 1280) with a prior runs with torch's sync debug mode set to raise
    on any host synchronisation."""
    require_cuda()
    from libviso_torch.solvers.bundle_adjust import bundle_adjust

    args, calib = _ba_window()
    args = [a.cuda() for a in args]
    kw = dict(iters=10, pose_prior=args[0] + 1e-3,
              prior_weight=torch.full_like(args[0], 100.0))
    bundle_adjust(*args, calib, **kw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = bundle_adjust(*args, calib, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(res.poses).all()


def test_invert_match_map_keeps_the_last_writer_on_the_card():
    require_cuda()
    from libviso_torch.pipeline.refine import invert_match_map

    rng = np.random.default_rng(0)
    idx = rng.integers(0, 50, (14, 1280))
    valid = rng.random((14, 1280)) < 0.8
    want = np.full((14, 50), -1)
    for r in range(14):
        for cur in range(1280):
            if valid[r, cur]:
                want[r, idx[r, cur]] = cur
    idx_c = torch.tensor(idx, device="cuda")
    valid_c = torch.tensor(valid, device="cuda")
    for _ in range(5):
        got = invert_match_map(idx_c, valid_c, 50)
        np.testing.assert_array_equal(got.cpu().numpy(), want)


def _ba_sequence():
    seq = generate_sequence(num_frames=10, num_points=500, seed=31,
                            width=416, height=160, speed=0.6, f=360.0)
    return seq, PipelineConfig().with_metric("l1")


def test_windowed_ba_backends_agree_on_the_card():
    """run_windowed_ba under dense, fused and sweep on the card: the same
    motions, flags and window costs bit for bit, two launches of the
    route's kernels a window."""
    require_cuda()
    from libviso_torch.config import BAConfig
    from libviso_torch.pipeline.windowed import run_windowed_ba

    seq, cfg = _ba_sequence()
    names = {"dense": ["l1"], "fused": ["fused_gated_two_min"],
             "sweep": ["sweep_order", "fused_sweep_two_min"]}
    results = {}
    for backend, kernels in names.items():
        before = {n: cm.launches if n == "l1" else fm.launches[n]
                  for n in kernels}
        res = run_windowed_ba(seq.frames, seq.P1, seq.P2, cfg,
                              ba=BAConfig(window=6, stride=3, gate=False),
                              backend=backend, device="cuda")
        for n in kernels:
            now = cm.launches if n == "l1" else fm.launches[n]
            assert now - before[n] == 2 * len(res.window_costs), (backend, n)
        results[backend] = res
        assert res.frame_ok[1:].all()
    for backend in ("fused", "sweep"):
        np.testing.assert_array_equal(results[backend].motions,
                                      results["dense"].motions)
        np.testing.assert_array_equal(results[backend].frame_ok,
                                      results["dense"].frame_ok)
        assert results[backend].window_costs == results["dense"].window_costs


def test_windowed_resume_on_the_card_equals_the_uninterrupted_run(tmp_path):
    require_cuda()
    from libviso_torch.config import BAConfig
    from libviso_torch.pipeline.windowed import run_windowed_ba
    from libviso_torch.utils.checkpoint import CheckpointManager

    seq, cfg = _ba_sequence()
    run = lambda **kw: run_windowed_ba(  # noqa: E731
        seq.frames, seq.P1, seq.P2, cfg, ba=BAConfig(window=4, stride=2),
        backend="sweep", device="cuda", **kw)
    want = run()
    mgr = CheckpointManager(str(tmp_path), every=1, keep=10)
    run(checkpoint=mgr)
    names = sorted(p.name for p in tmp_path.iterdir())
    for name in names[2:]:
        (tmp_path / name).unlink()
    got = run(checkpoint=mgr)
    assert got.processed == 10 - 4
    np.testing.assert_array_equal(got.motions, want.motions)
    np.testing.assert_array_equal(got.poses, want.poses)
    np.testing.assert_array_equal(got.frame_ok, want.frame_ok)
    assert got.window_costs == want.window_costs


def _kitti_frame_problem(seed=0):
    """Detector output of one KITTI-size stereo pair on the card."""
    from libviso_torch.ops.features import detect_and_describe

    seq = generate_sequence(num_frames=2, num_points=900, seed=seed,
                            width=1241, height=376)
    cfg = PipelineConfig()
    ims = torch.tensor(np.stack([seq.frames[1][0], seq.frames[1][1],
                                 seq.frames[0][0], seq.frames[0][1]]),
                       device="cuda")
    kps, ds = detect_and_describe(ims, cfg.detector)
    F = torch.tensor(F_from_P_host(seq.P1, seq.P2), dtype=torch.float32,
                     device="cuda")
    return kps, ds, F, cfg


def test_tp_matcher_equals_local_at_kitti_size():
    """model = 1, 2, 4 entries all on cuda:0 at (1280, 1280, 128), stereo
    with F and temporal: equal to match_descriptors bit for bit, with k
    launches of the L1 kernel a problem."""
    require_cuda()
    from libviso_torch.config import MatchConfig
    from libviso_torch.ops.features import Keypoints
    from libviso_torch.ops.matching import match_descriptors
    from libviso_torch.parallel import make_mesh, tp_match_descriptors

    kps, ds, F, _ = _kitti_frame_problem()
    kp = [Keypoints(*(x[i] for x in kps)) for i in range(4)]
    problems = [(kp[0], ds[0], kp[1], ds[1], MatchConfig.stereo(), F),
                (kp[0], ds[0], kp[2], ds[2], MatchConfig.temporal(), None)]
    for k in (1, 2, 4):
        mesh = make_mesh(n_data=1, n_model=k, devices=["cuda:0"] * k)
        for kp1, d1, kp2, d2, mc, Fm in problems:
            cfg = dataclasses.replace(mc, metric="l1")
            local = match_descriptors(kp1, d1, kp2, d2, cfg, F=Fm)
            before = cm.launches
            got = tp_match_descriptors(mesh, kp1, d1, kp2, d2, cfg, F=Fm)
            assert cm.launches - before == k
            for a, b in zip(got, local):
                assert torch.equal(a, b)
            assert int(got.valid.sum()) > 100


def test_l2q8_cross_on_the_card_equals_cpu():
    """The quantized cross term is exact on either device (integer
    partial sums below 2^24), so the card's equals the CPU's and the
    int64 product; the l2q8 distances follow bit for bit."""
    require_cuda()
    from libviso_torch.ops.matching import (
        descriptor_distances,
        q8_cross,
        quantize_q8,
    )

    a, b = _pair((3, 1280, 128), (3, 1280, 128), integer=False)
    qa, qb = quantize_q8(a), quantize_q8(b)
    card = q8_cross(qa, qb)
    cpu = q8_cross(qa.cpu(), qb.cpu())
    exact = torch.matmul(qa.cpu().long(), qb.cpu().long().transpose(-1, -2))
    assert torch.equal(card.cpu(), cpu)
    assert torch.equal(card.cpu().long(), exact)
    assert torch.equal(descriptor_distances(a, b, "l2q8").cpu(),
                       descriptor_distances(a.cpu(), b.cpu(), "l2q8"))


@pytest.mark.parametrize("metric", ["l2", "l2q8"])
def test_banded_equals_dense_on_a_card_frame(metric):
    """A KITTI-size frame's three problems on the card: the banded
    matcher's indices equal the dense path's except on rows whose two
    candidates are at an exactly equal distance ('l2q8'), or within
    float32 rounding of one ('l2', cross products blocked differently)."""
    require_cuda()
    from libviso_torch.ops.features import Keypoints
    from libviso_torch.ops.matching import (
        descriptor_distances,
        match_frame_triple,
    )
    from libviso_torch.pipeline.stereo import match_layout

    kps, ds, F, cfg = _kitti_frame_problem()
    cfg = cfg.with_metric(metric)
    cfg = dataclasses.replace(cfg, stereo_match=dataclasses.replace(
        cfg.stereo_match, banded=True))
    kp = [Keypoints(*(x[i] for x in kps)) for i in range(4)]
    args = (kp[0], ds[0], kp[1], ds[1], kp[2], ds[2], kp[3], ds[3],
            cfg.stereo_match, cfg.temporal_match, F)
    layout = match_layout(cfg, 1241)
    assert layout is not None
    banded = match_frame_triple(*args, layout=layout, image_width=1241)
    dense = match_frame_triple(*args)
    targets = (ds[1], ds[2], ds[3])
    queries = (ds[0], ds[0], ds[1])
    for b, d, q, t in zip(banded, dense, queries, targets):
        assert torch.equal(b.valid, d.valid)
        rows = torch.nonzero(b.idx != d.idx)[:, 0]
        if len(rows):
            dd = descriptor_distances(q[rows], t, metric)
            pick_b = dd.gather(1, b.idx[rows, None])[:, 0]
            pick_d = dd.gather(1, d.idx[rows, None])[:, 0]
            if metric == "l2q8":
                assert torch.equal(pick_b, pick_d)
            else:
                torch.testing.assert_close(pick_b, pick_d, rtol=1e-6,
                                           atol=0)
        assert int(b.valid.sum()) > 300


def test_sharded_bundle_adjust_makes_no_host_sync():
    """The landmark axis of the (8, 1280) window over 4 entries of
    cuda:0: within 1e-4 (poses) and 1e-3 (landmarks) of bundle_adjust,
    and no host synchronisation after a first call."""
    require_cuda()
    from libviso_torch.parallel import make_mesh, sharded_bundle_adjust
    from libviso_torch.solvers.bundle_adjust import bundle_adjust

    args, calib = _ba_window()
    args = [a.cuda() for a in args]
    mesh = make_mesh(n_data=1, n_model=4, devices=["cuda:0"] * 4)
    ref = bundle_adjust(*args, calib, iters=10)
    sharded_bundle_adjust(mesh, *args, calib, iters=10)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = sharded_bundle_adjust(mesh, *args, calib, iters=10)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    np.testing.assert_allclose(res.poses.cpu(), ref.poses.cpu(), atol=1e-4)
    np.testing.assert_allclose(res.landmarks.cpu(), ref.landmarks.cpu(),
                               atol=1e-3)


def test_stream_pipeline_on_two_streams_equals_serial():
    """StreamPipeline with both stages on cuda:0, each on its own CUDA
    stream: the serial run's motions and ok flags bit for bit."""
    require_cuda()
    from libviso_torch.parallel.pp_odometry import StreamPipeline

    seq = generate_sequence(num_frames=6, num_points=500, seed=3,
                            width=416, height=160)
    cfg = PipelineConfig().with_metric("l1")
    serial = run_stereo_sequence(seq.frames, seq.P1, seq.P2, cfg,
                                 device="cuda")
    sp = StreamPipeline(seq.P1, seq.P2, cfg, devices=["cuda:0", "cuda:0"])
    assert sp._stages.streams is not None
    outs = [sp.push(im1, im2) for im1, im2 in seq.frames][1:] + [sp.flush()]
    motions = np.stack([o.tr.cpu().numpy() for o in outs])
    ok = np.array([bool(o.ok) for o in outs])
    ok[0] = False
    np.testing.assert_array_equal(ok, serial.frame_ok)
    np.testing.assert_array_equal(motions, serial.motions)


def test_staged_drivers_take_card_tensors():
    """Frames and draws already on the card: StreamPipeline.push and
    run_pipelined_odometry take them in the order of the stream that made
    them, and equal the serial run bit for bit."""
    require_cuda()
    from libviso_torch.parallel import make_pipe_mesh, run_pipelined_odometry
    from libviso_torch.parallel.pp_odometry import StreamPipeline

    seq = generate_sequence(num_frames=6, num_points=500, seed=3,
                            width=416, height=160)
    cfg = PipelineConfig().with_metric("l1")
    shape = (cfg.ransac.num_hypotheses, cfg.detector.num_slots)

    def draws(t):
        return sample_gumbel(shape, frame_generator(0, t)).cuda()

    serial = run_stereo_sequence(seq.frames, seq.P1, seq.P2, cfg,
                                 device="cuda")
    card = [[torch.as_tensor(f[v], device="cuda") for f in seq.frames]
            for v in (0, 1)]
    sp = StreamPipeline(seq.P1, seq.P2, cfg, devices=["cuda:0", "cuda:0"],
                        draws=draws)
    outs = [sp.push(a, b) for a, b in zip(*card)][1:] + [sp.flush()]
    ok = np.array([bool(o.ok) for o in outs])
    ok[0] = False
    np.testing.assert_array_equal(ok, serial.frame_ok)
    np.testing.assert_array_equal(
        np.stack([o.tr.cpu().numpy() for o in outs]), serial.motions)
    poses, motions, ok = run_pipelined_odometry(
        make_pipe_mesh(["cuda:0", "cuda:0"]), seq.P1, seq.P2,
        torch.stack(card[0]), torch.stack(card[1]), cfg, draws=draws)
    np.testing.assert_array_equal(motions, serial.motions)
    np.testing.assert_array_equal(ok, serial.frame_ok)
    np.testing.assert_array_equal(poses, serial.poses)


def test_profiling_on_the_card():
    """The profiling layer on the card: the peak table has the card's row,
    the device clock reads one call's time, and profile_matcher under l1
    goes through kernel #1 (warmup + reps) x chain times with every
    utilization at most 1 (the cost model and the timer agree)."""
    require_cuda()
    from libviso_torch.utils import profiling

    assert None not in profiling.device_peaks()
    x = torch.ones((256, 256), device="cuda")
    sec = profiling.time_call(torch.matmul, (x, x), reps=5)
    assert 0 < sec < 0.05
    before = cm.launches
    st = profiling.profile_matcher(512, 384, 128, reps=4, chain=2)
    assert cm.launches - before == (3 + 4) * 2
    assert 0 < st.flop_util <= 1.0 and 0 < st.bw_util <= 1.0
    before = cm.launches
    profiling.profile_matcher(512, 384, 128, backend="plain", reps=2)
    assert cm.launches == before


def test_bench_default_mode_on_the_card(capsys):
    """bench_torch.py's default mode (chunked streaming, metric l2, 4
    frames a call) at --reps=2 on the card: exactly one JSON line on
    stdout, with bench.py's keys and a finite positive rate."""
    require_cuda()
    import bench_torch

    line = bench_torch.main(["--reps=2"])
    assert capsys.readouterr().out.splitlines() == [json.dumps(line)]
    assert list(line) == ["metric", "value", "unit", "vs_baseline",
                          "value_best_window", "mode"]
    assert line["metric"] == "stereo_vo_fps"
    assert line["mode"] == "streaming_chunk4"
    assert math.isfinite(line["value"]) and line["value"] > 0
    assert line["vs_baseline"] == round(
        line["value"] / bench_torch.BASELINE_FPS, 3)
