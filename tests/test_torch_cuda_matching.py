"""The L1 descriptor-distance kernel wrapper and its plain version.

On the CPU the plain version is held against the JAX package's Pallas
kernel in interpret mode and its XLA reference (rtol 1e-5: float sums in
different orders), and a CPU call must not count a kernel launch.  The
CUDA kernel itself is held against the plain version on the card by
tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libviso_tpu.ops.matching import _l1_desc_dist_xla as jax_l1_xla
from libviso_tpu.ops.pallas_matching import l1_distance_matrix as jax_l1
from libviso_torch.ops import cuda_matching as cm
from tests.torch_parity import to_np, to_torch


def test_plain_matches_pallas_interpret_and_xla(rng):
    d1 = (rng.normal(size=(256, 128)) * 10).astype(np.float32)
    d2 = (rng.normal(size=(128, 128)) * 10).astype(np.float32)
    ours = to_np(cm.l1_distance_matrix_plain(to_torch(d1), to_torch(d2)))
    pallas = np.asarray(jax_l1(jnp.asarray(d1), jnp.asarray(d2),
                               interpret=True))
    xla = np.asarray(jax_l1_xla(jnp.asarray(d1), jnp.asarray(d2)))
    np.testing.assert_allclose(ours, pallas, rtol=1e-5)
    np.testing.assert_allclose(ours, xla, rtol=1e-5)


def test_cpu_route_is_plain_and_counts_no_launch(rng):
    d1 = to_torch(rng.normal(size=(3, 200, 128)).astype(np.float32))
    d2 = to_torch(rng.normal(size=(3, 70, 128)).astype(np.float32))
    before = cm.launches
    out = cm.l1_distance_matrix(d1, d2)
    assert cm.launches == before
    assert out.shape == (3, 200, 70)
    assert torch.equal(out, cm.l1_distance_matrix_plain(d1, d2))
    assert torch.equal(cm.l1_distance_matrix(d1[1], d2[1]), out[1])


def test_plain_ragged_and_integer_exact(rng):
    d1 = rng.integers(-1020, 1021, size=(2, 37, 124)).astype(np.float32)
    d2 = rng.integers(-1020, 1021, size=(2, 53, 124)).astype(np.float32)
    ref = np.abs(d1[:, :, None, :].astype(np.int64)
                 - d2[:, None, :, :]).sum(-1)
    out = to_np(cm.l1_distance_matrix_plain(to_torch(d1), to_torch(d2)))
    np.testing.assert_array_equal(out, ref.astype(np.float32))


def test_other_devices_raise_instead_of_falling_back():
    d = torch.empty(4, 8, device="meta")
    with pytest.raises(ValueError, match="no L1 kernel"):
        cm.l1_distance_matrix(d, d)
    with pytest.raises(ValueError, match="descriptors on"):
        cm.l1_distance_matrix(torch.zeros(4, 8), d)
