"""The matcher variants of libviso_torch against libviso_tpu: metric 'l2q8'
and the strip-banded matcher (``MatchConfig.banded``).

Tolerances:
  - 'l2q8': distances, indices and validity equal JAX's exactly.  The
    quantized levels, the integer cross term (a float32 product whose
    partial sums are integers below 2^24) and the norms are exact, and the
    square root is correctly rounded.
  - banded 'l2': indices and validity equal JAX's banded result exactly;
    squared distances within 1e-6 * (||a||^2 + ||b||^2) of the largest
    pair, the bound of tests/test_torch_matching.py (float32 rounding of
    the norms).
  - banded against the port's dense path: indices and validity equal, on
    the detector output below (no bit-exact distance tie changes a row).
  - the stereo runs under each variant: every frame's discrete stats equal
    JAX's on JAX's draws, motions within 1e-4, as tests/test_torch_pipeline.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libviso_tpu.config import DetectorConfig, PipelineConfig
from libviso_tpu.geometry.mvg import F_from_P_host
from libviso_tpu.ops import features as jfeat
from libviso_tpu.ops import matching as jmatch
from libviso_tpu.pipeline import run_stereo_sequence as jax_run
from libviso_tpu.pipeline.stereo import match_layout as jax_match_layout
from libviso_tpu.synthetic import generate_sequence
from libviso_torch.config import from_jax_config
from libviso_torch.ops import matching as tmatch
from libviso_torch.ops.features import Keypoints
from libviso_torch.pipeline import stereo as tstereo
from tests.torch_parity import jax_frame_gumbel, to_np, to_torch

WIDTH = 416
# the layout of tests/test_matching.py's banded case: 11 strips of 37 px,
# a band of 3 strips either side (7 of 11 scored)
DETECTOR = DetectorConfig(max_features=462, nbinx=11, nbiny=3, num_slots=512)
KEYS = ("ok", "num_lr", "num_circle", "num_inliers")


def _cfg(metric, banded):
    cfg = PipelineConfig(detector=DETECTOR).with_metric(metric)
    return dataclasses.replace(cfg, stereo_match=dataclasses.replace(
        cfg.stereo_match, banded=banded))


@pytest.fixture(scope="module")
def frame_pair():
    seq = generate_sequence(num_frames=2, num_points=600, seed=9,
                            width=WIDTH, height=160)
    detect = jax.jit(lambda im: jfeat.detect_and_describe(im, DETECTOR))
    feats = [detect(jnp.asarray(im)) for pair in seq.frames for im in pair]
    F = F_from_P_host(seq.P1, seq.P2).astype(np.float32)
    return feats, F


def _triple(feats, F, cfg, package, banded):
    """match_frame_triple of frame 1 against frame 0 in either package."""
    (kp1p, d1p), (kp2p, d2p), (kp1, d1), (kp2, d2) = feats
    if package == "jax":
        layout = jax_match_layout(cfg, WIDTH) if banded else None
        return jmatch.match_frame_triple(
            kp1, d1, kp2, d2, kp1p, d1p, kp2p, d2p, cfg.stereo_match,
            cfg.temporal_match, jnp.asarray(F), layout=layout,
            image_width=WIDTH)
    tcfg = from_jax_config(cfg)
    layout = tstereo.match_layout(tcfg, WIDTH) if banded else None
    t = [(Keypoints(*(to_torch(x) for x in kp)), to_torch(d))
         for kp, d in feats]
    (kp1p, d1p), (kp2p, d2p), (kp1, d1), (kp2, d2) = t
    return tmatch.match_frame_triple(
        kp1, d1, kp2, d2, kp1p, d1p, kp2p, d2p, tcfg.stereo_match,
        tcfg.temporal_match, to_torch(F), layout=layout, image_width=WIDTH)


def _norm_sq(feats):
    return max(float((np.asarray(d) ** 2).sum(-1).max()) for _, d in feats)


def test_l2q8_distances_equal_jax_exactly(frame_pair):
    feats, _ = frame_pair
    (_, d1), (_, d2) = feats[2], feats[3]
    got = tmatch.descriptor_distances(to_torch(d1), to_torch(d2), "l2q8")
    want = jmatch.descriptor_distances(d1, d2, metric="l2q8")
    np.testing.assert_array_equal(to_np(got), np.asarray(want))
    # the cross term is the exact integer product
    q1, q2 = (tmatch.quantize_q8(to_torch(d)) for d in (d1, d2))
    exact = q1.long() @ q2.long().T
    assert torch.equal(tmatch.q8_cross(q1, q2).long(), exact)


@pytest.mark.parametrize("banded", [False, True])
def test_l2q8_matches_equal_jax_exactly(frame_pair, banded):
    feats, F = frame_pair
    cfg = _cfg("l2q8", banded)
    for t, j in zip(_triple(feats, F, cfg, "torch", banded),
                    _triple(feats, F, cfg, "jax", banded)):
        for field in ("idx", "valid", "dist"):
            np.testing.assert_array_equal(to_np(getattr(t, field)),
                                          np.asarray(getattr(j, field)))
    assert int(t.valid.sum()) > 100


def test_banded_l2_equals_jax_banded(frame_pair):
    feats, F = frame_pair
    cfg = _cfg("l2", True)
    for t, j in zip(_triple(feats, F, cfg, "torch", True),
                    _triple(feats, F, cfg, "jax", True)):
        np.testing.assert_array_equal(to_np(t.idx), np.asarray(j.idx))
        np.testing.assert_array_equal(to_np(t.valid), np.asarray(j.valid))
        ok = to_np(t.valid)
        np.testing.assert_allclose(
            to_np(t.dist)[ok] ** 2, np.asarray(j.dist)[ok] ** 2, rtol=0,
            atol=1e-6 * 2 * _norm_sq(feats))


@pytest.mark.parametrize("metric", ["l2", "l2q8"])
def test_banded_equals_dense(frame_pair, metric):
    feats, F = frame_pair
    cfg = _cfg(metric, True)
    banded = _triple(feats, F, cfg, "torch", True)
    dense = _triple(feats, F, cfg, "torch", False)
    for b, d in zip(banded, dense):
        assert torch.equal(b.idx, d.idx) and torch.equal(b.valid, d.valid)
        np.testing.assert_allclose(to_np(b.dist)[to_np(b.valid)] ** 2,
                                   to_np(d.dist)[to_np(d.valid)] ** 2,
                                   rtol=0, atol=1e-6 * 2 * _norm_sq(feats))
    assert int(banded[0].valid.sum()) > 100


@pytest.mark.parametrize("nbx,nby,k,band", [
    (11, 3, 14, 3), (24, 5, 10, 2), (6, 2, 3, 1), (4, 1, 2, 2)])
def test_banded_tables_equal_jax(nbx, nby, k, band):
    got = tmatch._banded_tables_np(nbx, nby, k, band)
    want = jmatch._banded_tables_np(nbx, nby, k, band)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


@pytest.mark.parametrize("width,change", [
    (None, {}),                                  # no width known
    (WIDTH, {"pyramid_levels": 2}),              # per-level slot blocks
    (WIDTH, {"banded": False}),                  # switched off
])
def test_match_layout_none(width, change):
    cfg = _cfg("l2", True)
    if "pyramid_levels" in change:
        cfg = dataclasses.replace(cfg, detector=dataclasses.replace(
            cfg.detector, pyramid_levels=2))
    if "banded" in change:
        cfg = _cfg("l2", False)
    assert jax_match_layout(cfg, width) is None
    assert tstereo.match_layout(from_jax_config(cfg), width) is None


@pytest.mark.parametrize("metric,width,n_query", [
    ("l1", WIDTH, 512),      # 'l1' keeps the dense path
    ("l2", 8, 512),          # strips narrower than a pixel
    ("l2", 120, 512),        # the band covers the whole image
    ("l2", WIDTH, 256),      # the query count is not the slot count
])
def test_band_of_declines(metric, width, n_query):
    layout = tstereo.match_layout(from_jax_config(_cfg("l2", True)), WIDTH)
    assert tmatch.band_of(layout, "l2", 80.0, WIDTH, 512) == 3
    assert tmatch.band_of(layout, metric, 80.0, width, n_query) is None


@pytest.mark.parametrize("metric,banded", [
    ("l2q8", False), ("l2", True), ("l2q8", True)])
def test_stereo_run_equals_jax(metric, banded):
    seq = generate_sequence(num_frames=4, num_points=600, seed=9,
                            width=WIDTH, height=160)
    cfg = _cfg(metric, banded)
    jres = jax_run(seq.frames, seq.P1, seq.P2, cfg, seed=0)
    H, N = cfg.ransac.num_hypotheses, cfg.detector.num_slots
    tres = tstereo.run_stereo_sequence(
        seq.frames, seq.P1, seq.P2, from_jax_config(cfg), device="cpu",
        draws=lambda t: jax_frame_gumbel(0, t, H, N))
    for a, b in zip(tres.stats, jres.stats):
        assert {k: a[k] for k in KEYS} == {k: b[k] for k in KEYS}, a["frame"]
    assert tres.frame_ok[1:].all()
    np.testing.assert_allclose(tres.motions, jres.motions, atol=1e-4)
