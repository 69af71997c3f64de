"""libviso_torch.ops.features against libviso_tpu.ops.features.

The Harris response is held within rtol 1e-5 of JAX's (both run the same
separable stencils in the same tap order, in float32).  Slot positions,
validity and descriptors are required exactly equal on every view of the
synthetic frames: the per-bin top-k breaks ties to the lowest index, as
JAX's does, so no slot may move.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libviso_tpu.config import DetectorConfig
from libviso_tpu.ops import features as jfeat
from libviso_tpu.synthetic import generate_sequence
from libviso_torch.config import from_jax_config
from libviso_torch.ops import features as tfeat
from libviso_torch.ops.topk import topk_iterative
from tests.torch_parity import to_np, to_torch

CFG = DetectorConfig()


@pytest.fixture(scope="module")
def frames():
    seq = generate_sequence(num_frames=4, num_points=500, seed=3, width=416,
                            height=160)
    return [im for pair in seq.frames for im in pair]


@pytest.fixture(scope="module")
def jax_detect():
    return jax.jit(lambda im: jfeat.detect_and_describe(im, CFG))


def test_harris_response(frames):
    for im in frames[:2]:
        a = tfeat.harris_response(to_torch(im))
        b = np.asarray(jfeat.harris_response(jnp.asarray(im)))
        np.testing.assert_allclose(to_np(a), b, rtol=1e-5,
                                   atol=1e-5 * np.abs(b).max())


@pytest.mark.parametrize("dx", [True, False])
def test_sobel_derivatives(frames, dx):
    a = tfeat.sobel_derivatives(to_torch(frames[0]), dx=dx)
    b = jfeat.sobel_derivatives(jnp.asarray(frames[0]), dx=dx)
    np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=1e-6)


def test_slots_valid_and_descriptors_equal(frames, jax_detect):
    tcfg = from_jax_config(CFG)
    for i, im in enumerate(frames):
        kj, dj = jax_detect(jnp.asarray(im))
        kt, dt = tfeat.detect_and_describe(to_torch(im), tcfg)
        np.testing.assert_array_equal(to_np(kt.valid), np.asarray(kj.valid),
                                      err_msg=f"frame {i}")
        np.testing.assert_array_equal(to_np(kt.xy), np.asarray(kj.xy),
                                      err_msg=f"frame {i}")
        np.testing.assert_array_equal(to_np(dt), np.asarray(dj),
                                      err_msg=f"frame {i}")
        np.testing.assert_allclose(to_np(kt.response),
                                   np.asarray(kj.response), rtol=1e-5)


def test_stereo_pair_batch_equals_single_views(frames):
    tcfg = from_jax_config(CFG)
    pair = torch.stack([to_torch(frames[0]), to_torch(frames[1])])
    kb, db = tfeat.detect_and_describe(pair, tcfg)
    for v in range(2):
        ks, ds = tfeat.detect_and_describe(pair[v], tcfg)
        assert torch.equal(kb.xy[v], ks.xy) and torch.equal(db[v], ds)


def test_invalid_slots_and_descriptor_tail_are_zero(frames):
    # a flat image has no corners: every slot invalid, at (0, 0), zero rows
    flat = torch.full((160, 416), 77.0)
    kp, d = tfeat.detect_and_describe(flat, from_jax_config(CFG))
    assert not kp.valid.any()
    assert not kp.xy.any() and not d.any()
    kp, d = tfeat.detect_and_describe(to_torch(frames[0]),
                                      from_jax_config(CFG))
    assert not d[:, CFG.descriptor_dim:].any()
    assert not d[~kp.valid].any()


def test_topk_ties_go_to_lowest_index():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0, 0.0]])
    vals, idx = topk_iterative(x, 4)
    assert idx.tolist() == [[1, 2, 4, 3]]
    assert vals.tolist() == [[3.0, 3.0, 3.0, 2.0]]
    # the JAX package's own top-k agrees
    jv, ji = jax.lax.top_k(jnp.asarray(to_np(x)), 4)
    assert np.asarray(ji).tolist() == idx.tolist()


@pytest.mark.parametrize("option", [
    dict(sharpen_sigma=2.0), dict(pyramid_levels=2), dict(subpixel=True),
    dict(nms_radius=2)])
def test_options_not_ported_raise(option, frames):
    """No detector option is left unported: each of the four that used to
    raise NotImplementedError now runs and fills the default slot tensors
    (their parity with JAX is tests/test_torch_detector_options.py's)."""
    cfg = from_jax_config(DetectorConfig(**option))
    kp, d = tfeat.detect_and_describe(to_torch(frames[0]), cfg)
    assert kp.xy.shape == (1280, 2) and d.shape == (1280, 128)
    assert int(kp.valid.sum()) > 300 and not d[~kp.valid].any()
    assert torch.isfinite(kp.xy).all()
