"""The numpy Threefry of libviso_torch against ``jax.random``.

``tools/threefry.py`` reproduces the JAX package's keys and bits exactly
and its Gumbel draws within 1e-6 (XLA's float32 log is not numpy's; the
largest gap, a few ulp of the inner log, shows where the draw is near 0),
with every row's top 5 in the same order, so a RANSAC that samples a
row's top k picks the same points.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tools import threefry as tf
from tests.torch_parity import (
    jax_chunk_gumbel,
    jax_frame_gumbel,
    jax_loop_verify_gumbel,
    jax_mono_gumbel,
    jax_sim3_verify_gumbel,
    jax_window_gumbel,
    to_np,
)


def _key(k):
    return tuple(int(x) for x in np.asarray(jax.random.key_data(k))) \
        if jnp.issubdtype(k.dtype, jax.dtypes.prng_key) else \
        tuple(int(x) for x in np.asarray(k))


@pytest.mark.parametrize("seed", [0, 1, 7, 2**31 - 1])
def test_keys_equal_jax(seed):
    jk = jax.random.PRNGKey(seed)
    tk = tf.prng_key(seed)
    assert _key(jk) == tuple(int(x) for x in tk)
    for data in (0, 5, 1_000_044, 2_000_089):
        jk2 = jax.random.fold_in(jk, data)
        tk2 = tf.fold_in(tk, data)
        assert _key(jk2) == tuple(int(x) for x in tk2)
        for num in (1, 2, 3):
            assert [_key(k) for k in jax.random.split(jk2, num)] == \
                [tuple(int(x) for x in k) for k in tf.split(tk2, num)]


@pytest.mark.parametrize("shape", [(7,), (32, 256), (3, 5, 4)])
def test_bits_equal_jax(shape):
    key = jax.random.fold_in(jax.random.PRNGKey(3), 11)
    want = np.asarray(jax.random.bits(key, shape, jnp.uint32))
    got = tf.random_bits(tf.fold_in(tf.prng_key(3), 11), shape)
    np.testing.assert_array_equal(got, want)


def _same_draws(got, want, k=5):
    want = to_np(want)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    top = [np.argsort(-x, -1, kind="stable")[..., :k] for x in (got, want)]
    np.testing.assert_array_equal(*top)


@pytest.mark.parametrize("seed,t", [(0, 0), (0, 17), (4, 95)])
def test_helpers_equal_the_jax_package_draws(seed, t):
    _same_draws(tf.frame_gumbel(seed, t, (32, 256)),
                jax_frame_gumbel(seed, t, 32, 256))
    for got, want in zip(tf.mono_gumbel(seed, t, (64, 512), (128, 512)),
                         jax_mono_gumbel(seed, t, 64, 128, 512)):
        _same_draws(got, want)
    for it in (None, 0, 1):
        _same_draws(tf.loop_verify_gumbel(seed, t, it, (256, 256)),
                    jax_loop_verify_gumbel(seed, t, it, 256, 256))
    _same_draws(tf.sim3_verify_gumbel(seed, t, (128, 256)),
                jax_sim3_verify_gumbel(seed, t, 128, 256))


@pytest.mark.parametrize("seed,w,T_w", [(0, 0, 8), (0, 3, 8), (6, 2, 6)])
def test_window_draws_equal_the_jax_package_draws(seed, w, T_w):
    """A BA window's draws: fold_in(w), split(T_w - 1), gumbel each."""
    got = tf.window_gumbel(seed, w, T_w, (32, 512))
    assert got.shape == (T_w - 1, 32, 512)
    _same_draws(got, jax_window_gumbel(seed, w, T_w - 1, 32, 512))


@pytest.mark.parametrize("seed,B,c,n", [(0, 4, 0, 5), (0, 4, 3, 5),
                                        (2, 2, 1, 2)])
def test_chunk_draws_equal_the_jax_package_draws(seed, B, c, n):
    """A sharded odometry chunk's draws: split(PRNGKey(seed), B)[c],
    split(n), gumbel each."""
    got = tf.chunk_gumbel(seed, B, c, n, (32, 256))
    assert got.shape == (n, 32, 256)
    _same_draws(got, jax_chunk_gumbel(seed, B, c, n, 32, 256))
