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


def _d(valid):
    return np.zeros((len(valid), D), np.float32)


def test_sweep_skip_is_exact(rng):
    """Every pair the gate admits lies in a (query block, target tile)
    pair that the sweep's box test keeps, whatever the block sizes; a
    block of invalid slots has an empty box."""
    xy1, v1, _, xy2, v2, _, F = _problem(rng, integer=False)
    (q_xy, q_valid, _, t_xy, t_valid, _), _, _ = fm.sort_slots(
        *(to_torch(x)[None] for x in (xy1, v1, _d(v1), xy2, v2, _d(v2))))
    ok = fm.gate(q_xy, q_valid, t_xy, t_valid, to_torch(F)[None],
                 torch.tensor([False]), THRESH, RADIUS)[0]
    for rows, cols in ((32, 64), (16, 48)):
        qbox = fm.sweep_boxes(q_xy, q_valid, rows)
        tbox = fm.sweep_boxes(t_xy, t_valid, cols)
        dx = torch.maximum(tbox[0, 0][None] - qbox[0, 1][:, None],
                           qbox[0, 0][:, None] - tbox[0, 1][None])
        dy = torch.maximum(tbox[0, 2][None] - qbox[0, 3][:, None],
                           qbox[0, 2][:, None] - tbox[0, 3][None])
        live = dx.clamp(min=0) + dy.clamp(min=0) < RADIUS
        i, j = ok.nonzero().unbind(1)
        assert live[i // rows, j // cols].all()
        assert int(fm.sweep_live_tiles(qbox, tbox, RADIUS)) == \
            int(live.sum())
        assert live.float().mean() < 0.75     # it does skip
    qbox = fm.sweep_boxes(q_xy, torch.zeros_like(q_valid), 32)
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
