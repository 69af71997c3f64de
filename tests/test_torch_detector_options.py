"""The detector options of libviso_torch against libviso_tpu:
``nms_radius``, sharpening (always on, and gated by the blur metric),
``subpixel`` and ``pyramid_levels``.

Both packages see the same 8-bit frames.  Slots, validity, coordinates and
descriptors are compared exactly wherever the arithmetic is a sequence of
single IEEE operations in the same order in both packages (stencils as
shifted multiply-adds, exact 2x2 means of 8-bit values, elementwise
quadratic fits).  The blur metric holds two full-image reductions whose
summation order differs between the frameworks: it is held to 1e-5
relative, and the test frames lie well away from the trigger so that the
gate's decision is the same.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libviso_tpu.config import DetectorConfig as JDetectorConfig
from libviso_tpu.ops import features as jfeat
from libviso_tpu.ops import pyramid as jpyr
from libviso_tpu.synthetic import _gaussian_blur, generate_sequence
from libviso_torch.config import from_jax_config
from libviso_torch.ops import features as tfeat
from libviso_torch.ops import pyramid as tpyr
from tests.torch_parity import to_np, to_torch

BASE = JDetectorConfig(max_features=240, nbinx=8, nbiny=3, num_slots=256)


@pytest.fixture(scope="module")
def frames():
    """Two sharp 8-bit stereo pairs and a defocused copy (blur sigma 3)."""
    seq = generate_sequence(num_frames=2, num_points=400, seed=5, width=208,
                            height=96)
    sharp = np.stack([np.asarray(f, np.uint8) for pair in seq.frames
                      for f in pair])                       # (4, H, W)
    blurred = np.stack([
        np.clip(np.round(_gaussian_blur(im.astype(np.float32), 3.0)), 0,
                255).astype(np.uint8) for im in sharp])
    return sharp, blurred


def _both(images, jcfg):
    """(JAX, port) detect_and_describe of a stack of images."""
    jk, jd = jax.vmap(lambda im: jfeat.detect_and_describe(im, jcfg))(
        jnp.asarray(images))
    tk, td = tfeat.detect_and_describe(to_torch(images),
                                       from_jax_config(jcfg))
    return (jk, jd), (tk, td)


def _assert_equal(j, t):
    (jk, jd), (tk, td) = j, t
    np.testing.assert_array_equal(to_np(tk.valid), np.asarray(jk.valid))
    np.testing.assert_array_equal(to_np(tk.xy), np.asarray(jk.xy))
    np.testing.assert_array_equal(to_np(tk.response),
                                  np.asarray(jk.response))
    np.testing.assert_array_equal(to_np(td), np.asarray(jd))
    assert np.asarray(jk.valid).sum() > 50


@pytest.mark.parametrize("radius", [1, 2])
def test_nms_radius_equals_jax(frames, radius):
    jcfg = dataclasses.replace(BASE, nms_radius=radius)
    j, t = _both(frames[0], jcfg)
    _assert_equal(j, t)
    # it does change the detections
    plain = tfeat.detect_and_describe(to_torch(frames[0]),
                                      from_jax_config(BASE))[0]
    assert not torch.equal(plain.xy, t[0].xy)


def test_sharpen_always_equals_jax(frames):
    jcfg = dataclasses.replace(BASE, sharpen_sigma=2.0, sharpen_amount=3.0)
    _assert_equal(*_both(frames[1], jcfg))


def test_unsharp_mask_equals_jax(frames):
    im = frames[1][0].astype(np.float32)
    np.testing.assert_array_equal(
        to_np(tfeat.unsharp_mask(to_torch(im), 3.0, 4.0)),
        np.asarray(jfeat.unsharp_mask(jnp.asarray(im), 3.0, 4.0)))


def test_blur_metric_close_to_jax_and_separates_the_frames(frames):
    sharp, blurred = frames
    both = np.concatenate([sharp, blurred]).astype(np.float32)
    jm = np.asarray(jax.vmap(jfeat.blur_metric)(jnp.asarray(both)))
    tm = to_np(tfeat.blur_metric(to_torch(both)))
    # two image-wide float32 reductions, summed in another order
    np.testing.assert_allclose(tm, jm, rtol=1e-5)
    trigger = BASE.sharpen_trigger
    assert (jm[:4] > trigger + 0.015).all() and (jm[4:] < trigger - 0.015).all()


def test_sharpen_auto_gates_per_image_as_jax(frames):
    """Sharp frames pass through unchanged, defocused ones are sharpened;
    one call holds frames on both sides of the trigger."""
    sharp, blurred = frames
    both = np.concatenate([sharp[:2], blurred[:2]])
    jcfg = dataclasses.replace(BASE, sharpen_sigma=3.0, sharpen_auto=True)
    j, t = _both(both, jcfg)
    _assert_equal(j, t)
    off = tfeat.detect_and_describe(to_torch(both), from_jax_config(BASE))
    assert torch.equal(off[1][:2], t[1][:2])          # no-op on sharp
    assert not torch.equal(off[1][2:], t[1][2:])      # applied on blurred


def test_sharpen_gate_argument_overrides_the_metric(frames):
    sharp, _ = frames
    jcfg = dataclasses.replace(BASE, sharpen_sigma=3.0, sharpen_auto=True)
    tcfg = from_jax_config(jcfg)
    gate = np.array([True, False, True, False])
    jk, jd = jax.vmap(lambda im, g: jfeat.detect_and_describe(
        im, jcfg, sharpen_gate=g))(jnp.asarray(sharp), jnp.asarray(gate))
    tk, td = tfeat.detect_and_describe(to_torch(sharp), tcfg,
                                       sharpen_gate=to_torch(gate))
    _assert_equal((jk, jd), (tk, td))


def test_subpixel_equals_jax(frames):
    jcfg = dataclasses.replace(BASE, subpixel=True)
    j, t = _both(frames[0], jcfg)
    _assert_equal(j, t)
    xy = to_np(t[0].xy)[to_np(t[0].valid)]
    assert (xy != np.round(xy)).any()                 # fractional


@pytest.mark.parametrize("levels,subpixel", [(2, False), (2, True),
                                             (3, False), (3, True)])
def test_pyramid_levels_equal_jax(frames, levels, subpixel):
    """8-bit inputs make the 2x2 means exact at these levels."""
    jcfg = dataclasses.replace(BASE, pyramid_levels=levels,
                               subpixel=subpixel)
    _assert_equal(*_both(frames[0], jcfg))


def test_multiscale_scales_and_budget(frames):
    jcfg = dataclasses.replace(BASE, pyramid_levels=3)
    tcfg = from_jax_config(jcfg)
    im = frames[0][0]
    _, _, js = jpyr.detect_and_describe_multiscale(jnp.asarray(im), jcfg,
                                                   levels=3, subpixel=False)
    kp, desc, ts = tpyr.detect_and_describe_multiscale(
        to_torch(frames[0]), tcfg, levels=3, subpixel=False)
    np.testing.assert_array_equal(to_np(ts), np.asarray(js))
    assert tpyr._level_budget(tcfg, 3) == jpyr._level_budget(jcfg, 3)
    assert sum(tpyr._level_budget(tcfg, 3)) == tcfg.num_slots
    assert kp.xy.shape == (4, 256, 2) and desc.shape == (4, 256, 128)


def test_pyramid_helpers_equal_jax(frames):
    im = frames[0][0].astype(np.float32)
    for a, b in zip(tpyr.build_pyramid(to_torch(frames[0]).float(), 3),
                    jpyr.build_pyramid(jnp.asarray(im), 3)):
        np.testing.assert_array_equal(to_np(a[0]), np.asarray(b))
    odd = im[:95, :207]
    np.testing.assert_array_equal(
        to_np(tpyr.downsample2(to_torch(odd))),
        np.asarray(jpyr.downsample2(jnp.asarray(odd))))
