"""The fused matcher's plain versions against the JAX package's Pallas
kernels, and the matcher's three backends against one another.

The plain versions (``ops/fused_matching.py``) are held against
``fused_gated_two_min`` and ``sorted_fused_two_min`` of
``libviso_tpu/ops/pallas_fused_match.py`` run in interpret mode, as
tests/test_pallas_fused_match.py runs them: on random float descriptors
best and second agree within rtol 1e-6 (sums in another order) and idx
exactly; on integer descriptors from a narrow range, where exact distance
ties occur, all three outputs are bitwise equal, including the sweep's
sorted tie order.  The CUDA kernels are held against the plain versions on
the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libviso_tpu.ops.pallas_fused_match import (
    fused_gated_two_min as jax_gated,
)
from libviso_tpu.ops.pallas_fused_match import (
    sorted_fused_two_min as jax_sorted,
)
from libviso_torch.config import MatchConfig, PipelineConfig
from libviso_torch.geometry.mvg import F_from_P_host
from libviso_torch.ops import fused_matching as fm
from libviso_torch.ops import matching as tmatch
from libviso_torch.ops.features import Keypoints
from libviso_torch.pipeline.stereo import build_frontend
from libviso_torch.synthetic import generate_sequence
from tests.torch_parity import to_np, to_torch

N, D = 256, 128
THRESH, RADIUS = 200.0, 120.0


def _problem(rng, integer):
    """One match problem: (xy, valid, d) per side and F, as numpy."""
    xy1 = rng.uniform(0, [400, 200], (N, 2)).astype(np.float32)
    xy2 = rng.uniform(0, [400, 200], (N, 2)).astype(np.float32)
    v1 = rng.random(N) > 0.1
    v2 = rng.random(N) > 0.1
    if integer:
        xy1, xy2 = np.round(xy1), np.round(xy2)
        d1 = rng.integers(0, 3, (N, D)).astype(np.float32)
        d2 = rng.integers(0, 3, (N, D)).astype(np.float32)
    else:
        d1 = rng.standard_normal((N, D)).astype(np.float32)
        d2 = rng.standard_normal((N, D)).astype(np.float32)
    F = rng.standard_normal((3, 3)).astype(np.float32)
    return xy1, v1, d1, xy2, v2, d2, F


def _jax(fn, prob, use_epi):
    xy1, v1, d1, xy2, v2, d2, F = map(jnp.asarray, prob)
    return tuple(np.asarray(x) for x in fn(
        xy1, v1, d1, xy2, v2, d2, F=F, use_epi=use_epi,
        sampson_thresh=THRESH, radius=RADIUS, interpret=True))


def _port(fn, prob, use_epi, **kw):
    """fn on the problem as a batch of one -> numpy (best, second, idx)."""
    args = [to_torch(x)[None] for x in prob] + [torch.tensor([use_epi])]
    return tuple(to_np(x[0]) for x in fn(*args, THRESH, RADIUS, **kw))


@pytest.mark.parametrize("use_epi", [False, True])
def test_plain_matches_pallas_on_floats(rng, use_epi):
    prob = _problem(rng, integer=False)
    for jfn, tfn in ((jax_gated, fm.fused_gated_two_min),
                     (jax_sorted, fm.sorted_fused_two_min)):
        jb, js, ji = _jax(jfn, prob, use_epi)
        tb, ts, ti = _port(tfn, prob, use_epi)
        has = np.isfinite(jb)
        assert has.sum() > 0
        np.testing.assert_array_equal(np.isfinite(tb), has)
        np.testing.assert_allclose(tb[has], jb[has], rtol=1e-6)
        np.testing.assert_allclose(ts[np.isfinite(js)],
                                   js[np.isfinite(js)], rtol=1e-6)
        np.testing.assert_array_equal(ti, ji)


@pytest.mark.parametrize("use_epi", [False, True])
def test_plain_bitwise_equals_pallas_on_integer_ties(rng, use_epi):
    """Descriptors in {0, 1, 2}: many exact distance ties.  The gated
    version breaks them to the lowest slot, the sweep to the lowest
    x-sorted slot, each exactly as its Pallas kernel does."""
    prob = _problem(rng, integer=True)
    gated = _port(fm.fused_gated_two_min, prob, use_epi)
    swept = _port(fm.sorted_fused_two_min, prob, use_epi)
    for got, want in ((gated, _jax(jax_gated, prob, use_epi)),
                      (swept, _jax(jax_sorted, prob, use_epi))):
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype
    assert np.isfinite(gated[0]).sum() > 20
    if not use_epi:   # the two tie orders really differ on this input
        assert (gated[2] != swept[2]).any()
        np.testing.assert_array_equal(gated[0], swept[0])


def test_batch_with_per_problem_F_equals_single_calls(rng):
    probs = [_problem(rng, integer=True) for _ in range(3)]
    use_epi = [True, False, True]
    batch = [torch.stack([to_torch(p[k]) for p in probs]) for k in range(7)]
    batch.append(torch.tensor(use_epi))
    for fn in (fm.fused_gated_two_min, fm.sorted_fused_two_min):
        out = fn(*batch, THRESH, RADIUS)
        for b, (prob, epi) in enumerate(zip(probs, use_epi)):
            single = _port(fn, prob, epi)
            for x, y in zip(out, single):
                np.testing.assert_array_equal(to_np(x[b]), y)


def test_empty_targets_and_ragged_shapes(rng):
    q = _problem(rng, integer=True)
    args = [to_torch(x)[None] for x in q] + [torch.tensor([False])]
    args[3], args[4], args[5] = args[3][:, :53], args[4][:, :53], \
        args[5][:, :53]
    args[0], args[1], args[2] = args[0][:, :37], args[1][:, :37], \
        args[2][:, :37]
    best, second, idx = fm.fused_gated_two_min(*args, THRESH, RADIUS)
    assert best.shape == second.shape == idx.shape == (1, 37)
    assert idx.dtype == torch.int32
    none = [a[:, :0] if i in (3, 4, 5) else a for i, a in enumerate(args)]
    best, second, idx = fm.fused_gated_two_min(*none, THRESH, RADIUS)
    assert torch.isinf(best).all() and torch.isinf(second).all()
    assert (idx == -1).all()


def _fold(a, b):
    """Merge two partial (best, second, idx) of the same rows in (value,
    column) order, as the CUDA kernel merges its target splits."""
    a_wins = (a[0] < b[0]) | ((a[0] == b[0]) & (a[2] < b[2]))
    win = [torch.where(a_wins, x, y) for x, y in zip(a, b)]
    lose_best = torch.where(a_wins, b[0], a[0])
    second = torch.minimum(lose_best, torch.minimum(a[1], b[1]))
    return win[0], second, win[2]


@pytest.mark.parametrize("chunks", [1, 2, 3, 4, 5, 8])
def test_target_split_folds_to_the_unsplit_result(rng, chunks):
    """The invariant the gated kernel's split of the target axis rests on:
    the plain version run over target chunks, the chunks' partials folded
    by (value, column) in any order, equals the unsplit plain version
    bitwise.  Descriptors in {0, 1, 2} tie often; the third quarter of the
    targets repeats the first, so ties cross chunk boundaries; rows whose
    candidates all lie in one chunk are empty in the others, and invalid
    queries are empty in all."""
    prob = _problem(rng, integer=True)
    args = [to_torch(x)[None] for x in prob] + [torch.tensor([True])]
    for k in (3, 4, 5):
        args[k][:, N // 2:3 * N // 4] = args[k][:, :N // 4]
    whole = fm.fused_gated_two_min(*args, THRESH, RADIUS)
    bounds = np.linspace(0, N, chunks + 1).astype(int)
    parts = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        part = fm.fused_gated_two_min(*args[:3], *(a[:, lo:hi] for a in
                                                   args[3:6]),
                                      *args[6:], THRESH, RADIUS)
        parts.append((part[0], part[1],
                      torch.where(part[2] >= 0, part[2] + int(lo), -1)))
    order = rng.permutation(chunks)
    folded = parts[order[0]]
    for k in order[1:]:
        folded = _fold(folded, parts[k])
    for x, y in zip(folded, whole):
        assert torch.equal(x, y.to(x.dtype))
    has = torch.isfinite(whole[0])
    assert 10 < int(has.sum()) < N
    if chunks > 1:   # some rows are empty in some chunk but not in all
        empty = torch.stack([~torch.isfinite(p[0]) for p in parts])
        assert (empty.any(0) & has).any()
        assert (whole[0][has] == whole[1][has]).any()      # ties


def _sorted_route_by_kernel_dataflow(args, rows, chunks, rng,
                                     map_first=False):
    """The sweep kernel's dataflow in plain PyTorch: the order's
    permutations and boxes, then per block of ``rows`` sorted queries its
    windows of sorted target columns (``sweep_columns``) split in
    ``chunks`` contiguous parts (one a CTA of a cluster), each part's rows
    and columns read through qperm and tperm, the parts folded in (value,
    sorted column) order in a random order of parts, and only at the store
    best and second written at query slot qperm[r] and the sorted column
    mapped through tperm.  ``map_first`` maps each part's columns to
    target slots before the fold instead, the order that breaks ties
    wrongly."""
    q_xy, q_valid, q_d, t_xy, t_valid, t_d, F, use_epi = args
    qperm, tperm, qbox, tbox = (x[0] for x in fm.sweep_order_plain(
        q_xy, q_valid, t_xy, t_valid))
    qperm, tperm = qperm.long(), tperm.long()
    W = fm.SWEEP_WINDOW
    N1, N2 = qperm.numel(), tperm.numel()
    c0, c1 = (x[0].tolist() for x in fm.sweep_columns(
        qbox[None], tbox[None], RADIUS, N2, rows=rows))
    best = torch.full((N1,), float("inf"))
    second, idx = best.clone(), torch.full((N1,), -1, dtype=torch.int32)
    for b in range(len(c0)):
        r = qperm[b * rows:(b + 1) * rows]
        n = -(-(c1[b] - c0[b]) // W)          # windows
        parts = []
        for k in range(chunks):
            c = torch.arange(c0[b] + k * n // chunks * W,
                             min(c0[b] + (k + 1) * n // chunks * W, c1[b]))
            j = tperm[c]
            part = fm.fused_gated_two_min_plain(
                q_xy[:, r], q_valid[:, r], q_d[:, r], t_xy[:, j],
                t_valid[:, j], t_d[:, j], F, use_epi, THRESH, RADIUS)
            col = (j if map_first else c).to(torch.int32)
            at = part[2][0].clamp(min=0).long()
            parts.append((part[0][0], part[1][0],
                          torch.where(part[2][0] >= 0, col[at] if len(c)
                                      else part[2][0], -1)))
        order = rng.permutation(chunks)
        m = parts[order[0]]
        for k in order[1:]:
            m = _fold(m, parts[k])
        best[r], second[r] = m[0], m[1]
        idx[r] = m[2] if map_first else torch.where(
            m[2] >= 0, tperm[m[2].clamp(min=0).long()].to(torch.int32), -1)
    return best[None], second[None], idx[None]


@pytest.mark.parametrize("chunks", [1, 2, 3, 4])
def test_sweep_dataflow_split_folds_to_the_sorted_route(rng, chunks):
    """The invariant the sweep kernel rests on: read through the order's
    permutations, its live tiles split over the CTAs of a cluster and
    folded by (value, sorted column) in any order, mapped to slots only at
    the store, it equals the sort-then-unsort route bitwise.  Descriptors
    in {0, 1, 2}; the third quarter of the targets repeats the first 30 px
    further left, so it sorts before the slots it repeats and ties with
    them across windows.  Both block heights of the kernel; a fold by
    target slot instead of sorted column gives another answer on some of
    those ties."""
    prob = _problem(rng, integer=True)
    args = [to_torch(x)[None] for x in prob] + [torch.tensor([False])]
    for k in (3, 4, 5):
        args[k][:, N // 2:3 * N // 4] = args[k][:, :N // 4]
    args[3][:, N // 2:3 * N // 4, 0] -= 30
    want = fm.sorted_fused_two_min(*args, THRESH, RADIUS)
    has = torch.isfinite(want[0])
    assert 10 < int(has.sum()) < N
    assert (want[0][has] == want[1][has]).any()      # ties
    for rows in (fm.SWEEP_TILING[0], 2 * fm.SWEEP_TILING[0]):
        got = _sorted_route_by_kernel_dataflow(args, rows, chunks, rng)
        for x, y in zip(got, want):
            assert torch.equal(x, y)
        if chunks > 1:
            wrong = _sorted_route_by_kernel_dataflow(args, rows, chunks, rng,
                                                     map_first=True)
            assert torch.equal(wrong[0], want[0])
            assert (wrong[2] != want[2]).any()


def _with_ties_of_x(rng, n=300):
    """(B=1) positions and validity of n slots: integer x in [0, 20), so
    many slots share an x, a -0.0 and a 0.0 among the valid ones, and a
    tenth invalid."""
    xy = np.stack([rng.integers(0, 20, n), rng.integers(0, 9, n)],
                  -1).astype(np.float32)
    valid = rng.random(n) > 0.1
    zeros = np.flatnonzero(valid & (xy[:, 0] == 0))
    assert len(zeros) >= 2
    xy[zeros[::2], 0] = -0.0
    assert np.signbit(xy[:, 0]).any()
    return xy, valid


def test_order_plain_equals_jax_keys_and_argsort(rng):
    """sweep_order_plain's permutations are the Pallas wrapper's: its keys
    (x, +1e6 for an invalid query, -1e6 for an invalid target) through
    jnp.argsort, on many equal x, invalid slots and a -0.0 key."""
    (q_xy, q_valid), (t_xy, t_valid) = _with_ties_of_x(rng), \
        _with_ties_of_x(rng, 277)
    qperm, tperm, _, _ = fm.sweep_order_plain(
        *(to_torch(x)[None] for x in (q_xy, q_valid, t_xy, t_valid)))
    jq = jnp.argsort(jnp.where(jnp.asarray(q_valid), jnp.asarray(q_xy)[:, 0],
                               1e6))
    jt = jnp.argsort(jnp.where(jnp.asarray(t_valid), jnp.asarray(t_xy)[:, 0],
                               -1e6))
    np.testing.assert_array_equal(to_np(qperm[0]), np.asarray(jq))
    np.testing.assert_array_equal(to_np(tperm[0]), np.asarray(jt))
    assert qperm.dtype == tperm.dtype == torch.int32
    unsorted = fm.sweep_order_plain(
        *(to_torch(x)[None] for x in (q_xy, q_valid, t_xy, t_valid)),
        sort=False)
    assert torch.equal(unsorted[0][0], torch.arange(300, dtype=torch.int32))


def test_order_boxes_equal_a_numpy_reference(rng):
    """The boxes, at the sweep kernel's tiling and ragged sizes, equal a
    per-block numpy reduction over the valid sorted slots; a block without
    one is [inf, -inf, inf, -inf]."""
    rows, cols = fm.SWEEP_TILING
    (q_xy, q_valid), (t_xy, t_valid) = _with_ties_of_x(rng, 301), \
        _with_ties_of_x(rng, 150)
    t_valid[:cols + 5] = False          # a target tile with no valid slot
    out = fm.sweep_order_plain(
        *(to_torch(x)[None] for x in (q_xy, q_valid, t_xy, t_valid)))
    for xy, valid, perm, box, block in ((q_xy, q_valid, out[0], out[2], rows),
                                        (t_xy, t_valid, out[1], out[3],
                                         cols)):
        perm = to_np(perm[0])
        n = -(-len(valid) // block)
        want = np.empty((4, n), np.float32)
        for b in range(n):
            s = perm[b * block:(b + 1) * block]
            v = xy[s][valid[s]]
            want[:, b] = ([v[:, 0].min(), v[:, 0].max(), v[:, 1].min(),
                           v[:, 1].max()] if len(v) else
                          [np.inf, -np.inf, np.inf, -np.inf])
        np.testing.assert_array_equal(to_np(box[0]), want)
    assert np.isinf(to_np(out[3][0])).any(0).sum() >= 1


def test_order_plain_above_one_cta_of_the_kernel():
    """Above MAX_SWEEP_SLOTS slots a side (one CTA of the order kernel) the
    plain order is the same stable sort of the keys: slots by (key, slot)
    with invalid queries keyed +1e6 and invalid targets -1e6, ties (equal
    x) in slot order."""
    rng = np.random.default_rng(8193)
    n = fm.MAX_SWEEP_SLOTS + 100
    xy = rng.integers(0, 50, (1, n, 2)).astype(np.float32)  # many ties
    valid = rng.random((1, n)) > 0.2
    qperm, tperm, qbox, tbox = fm.sweep_order_plain(
        to_torch(xy), to_torch(valid), to_torch(xy), to_torch(valid))
    for perm, key in ((qperm, 1e6), (tperm, -1e6)):
        keys = np.where(valid[0], xy[0, :, 0], np.float32(key))
        np.testing.assert_array_equal(to_np(perm[0]),
                                      np.lexsort((np.arange(n), keys)))
    assert qbox.shape == (1, 4, -(-n // fm.SWEEP_TILING[0]))
    assert tbox.shape == (1, 4, -(-n // fm.SWEEP_TILING[1]))


@pytest.mark.parametrize("use_epi", [False, True])
def test_sweep_route_above_the_order_limit(use_epi):
    """8200 target slots, above one CTA of the order kernel: the route
    equals the dense plain version on best and second, and on idx
    except where two targets are at exactly the same distance (where the
    lowest x-sorted target wins instead of the lowest slot)."""
    rng = np.random.default_rng(8200)
    n1, n2, d = 300, fm.MAX_SWEEP_SLOTS + 8, 4
    q_xy = rng.uniform(0, [1200, 370], (1, n1, 2)).astype(np.float32)
    t_xy = rng.uniform(0, [1200, 370], (1, n2, 2)).astype(np.float32)
    q_valid, t_valid = rng.random((1, n1)) > 0.1, rng.random((1, n2)) > 0.1
    q_d = rng.integers(0, 6, (1, n1, d)).astype(np.float32)
    t_d = rng.integers(0, 6, (1, n2, d)).astype(np.float32)
    F = np.asarray([[0, 0, 0], [0, 0, -1], [0, 1, 0]], np.float32)[None]
    args = [to_torch(x) for x in (q_xy, q_valid, q_d, t_xy, t_valid, t_d, F)]
    args.append(torch.tensor([use_epi]))
    got = fm.sorted_fused_two_min(*args, 1.0, 80.0)
    want = fm.fused_gated_two_min_plain(*args, 1.0, 80.0)
    np.testing.assert_array_equal(to_np(got[0]), to_np(want[0]))
    np.testing.assert_array_equal(to_np(got[1]), to_np(want[1]))
    differ = to_np(got[2] != want[2])[0]
    assert to_np(torch.isfinite(want[0])).sum() > 100
    # the rows where idx differs are exact ties: second == best
    np.testing.assert_array_equal(to_np(want[1])[0][differ],
                                  to_np(want[0])[0][differ])


def test_sweep_skip_is_exact(rng):
    """Every pair the gate admits lies in a (query block, target run) pair
    that the sweep's box test keeps, whatever the block sizes, and at the
    kernel's tiling within the sorted columns it computes for the query
    block (``sweep_columns``); a block of invalid slots has an empty box."""
    xy1, v1, _, xy2, v2, _, F = _problem(rng, integer=False)
    args = [to_torch(x)[None] for x in (xy1, v1, xy2, v2)]
    for rows, cols in ((32, 64), (16, 48), fm.SWEEP_TILING):
        qperm, tperm, qbox, tbox = fm.sweep_order_plain(*args,
                                                        tiling=(rows, cols))
        q_xy, q_valid = (x[0][qperm[0].long()][None] for x in args[:2])
        t_xy, t_valid = (x[0][tperm[0].long()][None] for x in args[2:])
        ok = fm.gate(q_xy, q_valid, t_xy, t_valid, to_torch(F)[None],
                     torch.tensor([False]), THRESH, RADIUS)[0]
        dx = torch.maximum(tbox[0, 0][None] - qbox[0, 1][:, None],
                           qbox[0, 0][:, None] - tbox[0, 1][None])
        dy = torch.maximum(tbox[0, 2][None] - qbox[0, 3][:, None],
                           qbox[0, 2][:, None] - tbox[0, 3][None])
        live = dx.clamp(min=0) + dy.clamp(min=0) < RADIUS
        i, j = ok.nonzero().unbind(1)
        assert live[i // rows, j // cols].all()
        assert torch.equal(fm.sweep_live(qbox, tbox, RADIUS)[0], live)
        assert live.float().mean() < 0.75     # it does skip
    for rows in (rows, 2 * rows):       # the kernel's two block heights
        c0, c1 = (x[0] for x in fm.sweep_columns(qbox, tbox, RADIUS, N,
                                                 rows=rows))
        assert ((c0[i // rows] <= j) & (j < c1[i // rows])).all()
        assert (c1 - c0).sum() < 0.75 * N * len(c0)      # it does skip
    _, _, qbox, _ = fm.sweep_order_plain(args[0], torch.zeros_like(args[1]),
                                         *args[2:])
    assert torch.isinf(qbox).all()


@pytest.fixture(scope="module")
def detector_problems():
    """The 3 match problems of frame 1 of a synthetic sequence, from the
    port's detector (the same slots as the JAX detector's,
    tests/test_torch_features.py)."""
    seq = generate_sequence(num_frames=2, num_points=500, seed=3, width=416,
                            height=160)
    cfg = PipelineConfig().with_metric("l1")
    frontend = build_frontend(cfg)
    prev, cur = (frontend(*(to_torch(im) for im in pair))
                 for pair in seq.frames)
    F = to_torch(F_from_P_host(seq.P1, seq.P2).astype(np.float32))
    return prev, cur, F, cfg


@pytest.mark.parametrize("backend", ["fused", "sweep"])
def test_fused_backends_equal_dense_on_detector_output(detector_problems,
                                                       backend):
    prev, cur, F, cfg = detector_problems
    args = (cur.kp1, cur.d1, cur.kp2, cur.d2, prev.kp1, prev.d1, prev.kp2,
            prev.d2, cfg.stereo_match, cfg.temporal_match, F)
    dense = tmatch.match_frame_triple(*args)
    fused = tmatch.match_frame_triple(*args, backend=backend)
    for a, b in zip(fused, dense):
        assert torch.equal(a.idx, b.idx)
        assert torch.equal(a.valid, b.valid)
        assert torch.equal(a.dist, b.dist)
    assert int(dense[0].valid.sum()) > 100
    one = tmatch.match_descriptors(cur.kp1, cur.d1, cur.kp2, cur.d2,
                                   cfg.stereo_match, F=F, backend=backend)
    assert torch.equal(one.idx, dense[0].idx)


def test_cpu_route_counts_no_launch(detector_problems):
    prev, cur, F, cfg = detector_problems
    before = dict(fm.launches)
    tmatch.match_frame_triple(cur.kp1, cur.d1, cur.kp2, cur.d2, prev.kp1,
                              prev.d1, prev.kp2, prev.d2, cfg.stereo_match,
                              cfg.temporal_match, F, backend="sweep")
    assert fm.launches == before


@pytest.mark.parametrize("backend,metric,error", [
    ("fused", "l2", "L1 only"), ("sweep", "l2", "L1 only"),
    ("pallas", "l1", "unknown matcher backend")])
def test_backend_and_metric_checks(backend, metric, error):
    kp = Keypoints(xy=torch.zeros(2, 2), response=torch.ones(2),
                   valid=torch.ones(2, dtype=bool))
    d = torch.ones(2, 128)
    with pytest.raises(ValueError, match=error):
        tmatch.match_descriptors(kp, d, kp, d, MatchConfig(metric=metric),
                                 backend=backend)


def test_other_devices_raise_instead_of_falling_back():
    d = torch.empty(1, 4, 8, device="meta")
    with pytest.raises(ValueError, match="no fused matcher kernel"):
        fm.fused_gated_two_min(d, d, d, d, d, d, d, d)
