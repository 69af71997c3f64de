"""libviso_torch.ops.matching against libviso_tpu.ops.matching on detector
output: match indices and validity equal.  L1 distances agree within rtol
1e-5 (float sums in different orders).  L2 distances come from
||a||^2 + ||b||^2 - 2 a.b, whose cancellation leaves float32 rounding of
the norms in the result, so squared L2 distances agree within
1e-6 * (||a||^2 + ||b||^2) of the largest pair."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libviso_tpu.config import PipelineConfig
from libviso_tpu.geometry.mvg import F_from_P_host
from libviso_tpu.ops import circle as jcircle
from libviso_tpu.ops import features as jfeat
from libviso_tpu.ops import matching as jmatch
from libviso_tpu.synthetic import generate_sequence
from libviso_torch.config import MatchConfig, from_jax_config
from libviso_torch.ops import circle as tcircle
from libviso_torch.ops import matching as tmatch
from libviso_torch.ops.features import Keypoints
from tests.torch_parity import to_np, to_torch


@pytest.fixture(scope="module")
def frame_pair():
    """Detector output of two consecutive stereo frames, for both packages
    (the detectors agree exactly, tests/test_torch_features.py), and F."""
    seq = generate_sequence(num_frames=2, num_points=500, seed=3, width=416,
                            height=160)
    det = PipelineConfig().detector
    detect = jax.jit(lambda im: jfeat.detect_and_describe(im, det))
    feats = [detect(jnp.asarray(im)) for pair in seq.frames for im in pair]
    F = F_from_P_host(seq.P1, seq.P2).astype(np.float32)
    return feats, F


def _torch_feats(feats):
    return [(Keypoints(*(to_torch(x) for x in kp)), to_torch(d))
            for kp, d in feats]


def _assert_same(tres, jres, metric, norm_sq):
    np.testing.assert_array_equal(to_np(tres.idx), np.asarray(jres.idx))
    np.testing.assert_array_equal(to_np(tres.valid), np.asarray(jres.valid))
    if metric == "l1":
        np.testing.assert_allclose(to_np(tres.dist), np.asarray(jres.dist),
                                   rtol=1e-5)
    else:
        ok = to_np(tres.valid)
        np.testing.assert_allclose(
            to_np(tres.dist)[ok] ** 2, np.asarray(jres.dist)[ok] ** 2,
            rtol=0, atol=1e-6 * 2 * norm_sq)


@pytest.mark.parametrize("metric,temporal_radius", [
    ("l1", 80.0), ("l2", 80.0), ("l1", 60.0)])
def test_match_frame_triple(frame_pair, metric, temporal_radius):
    """One 3-problem batch, and the three-call branch taken when the
    stereo and temporal configs differ in radius."""
    feats, F = frame_pair
    cfg = PipelineConfig().with_metric(metric)
    cfg = dataclasses.replace(cfg, temporal_match=dataclasses.replace(
        cfg.temporal_match, radius=temporal_radius))
    (kp1p, d1p), (kp2p, d2p), (kp1, d1), (kp2, d2) = feats
    jres = jmatch.match_frame_triple(
        kp1, d1, kp2, d2, kp1p, d1p, kp2p, d2p, cfg.stereo_match,
        cfg.temporal_match, jnp.asarray(F))
    (tkp1p, td1p), (tkp2p, td2p), (tkp1, td1), (tkp2, td2) = \
        _torch_feats(feats)
    tcfg = from_jax_config(cfg)
    tres = tmatch.match_frame_triple(
        tkp1, td1, tkp2, td2, tkp1p, td1p, tkp2p, td2p, tcfg.stereo_match,
        tcfg.temporal_match, to_torch(F))
    norm_sq = max(float((np.asarray(d) ** 2).sum(-1).max())
                  for _, d in feats)
    for t, j in zip(tres, jres):
        _assert_same(t, j, metric, norm_sq)
    assert int(tres[0].valid.sum()) > 100   # a real workload, not empty
    # and the circle filter over those matches
    np.testing.assert_array_equal(
        to_np(tcircle.circle_filter(tres[0].idx, tres[0].idx, tres[1].idx,
                                    tres[2].idx).valid),
        np.asarray(jcircle.circle_filter(jres[0].idx, jres[0].idx,
                                         jres[1].idx, jres[2].idx).valid))


def test_two_smallest_ties_and_empty_rows():
    inf = float("inf")
    dd = torch.tensor([[3.0, 1.0, 1.0, 2.0], [inf, inf, inf, inf],
                       [5.0, inf, 4.0, 4.0]])
    best, second, idx = tmatch.two_smallest(dd)
    assert idx.tolist() == [1, 0, 2]
    assert best.tolist() == [1.0, inf, 4.0]
    assert second.tolist() == [1.0, inf, 4.0]
    res = tmatch.finalize_match(best, second, idx, torch.ones(3, dtype=bool),
                                MatchConfig(use_ratio=True, ratio=0.9))
    assert res.idx.tolist() == [-1, -1, -1]   # ties fail the ratio test


def test_sampson_nan_pairs_are_rejected():
    # F = 0 makes every Sampson distance 0/0: the epipolar gate must drop
    # every pair, never pass them through as NaN
    kp = Keypoints(xy=torch.tensor([[10.0, 10.0], [20.0, 12.0]]),
                   response=torch.ones(2), valid=torch.ones(2, dtype=bool))
    d = torch.ones(2, 128)
    res = tmatch.match_descriptors(kp, d, kp, d, MatchConfig.stereo(),
                                   F=torch.zeros(3, 3))
    assert not res.valid.any()


@pytest.mark.parametrize("cfg", [MatchConfig(metric="l2q8"),
                                 MatchConfig(banded=True)])
def test_unported_matcher_options_raise(cfg):
    """No matcher option is left unported: 'l2q8' and the banded flag,
    which used to raise NotImplementedError, now match (the banded path
    needs a layout, so match_descriptors stays dense); their parity with
    JAX is tests/test_torch_matcher_variants.py's."""
    kp = Keypoints(xy=torch.tensor([[10.0, 10.0], [40.0, 12.0]]),
                   response=torch.ones(2), valid=torch.ones(2, dtype=bool))
    d = torch.tensor([[8.0] * 128, [-24.0] * 128])
    res = tmatch.match_descriptors(kp, d, kp, d, cfg)
    assert res.idx.tolist() == [0, 1] and res.dist.tolist() == [0.0, 0.0]
    with pytest.raises(ValueError, match="unknown metric"):
        tmatch.descriptor_distances(d, d, metric="cosine")
