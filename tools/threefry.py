"""The JAX package's random draws, reproduced in numpy.

The JAX package draws its RANSAC samples with ``jax.random``: the
Threefry-2x32 counter-based hash under keys derived by ``PRNGKey(seed)``,
``fold_in`` and ``split`` (the partitionable form, JAX's default), then
``gumbel``.  This module computes the same keys and bits with numpy, so a
run of the port can be given the JAX package's draws on a machine without
JAX: the keys and uniform bits are exact, the Gumbel values (two float32
logarithms) within a few ulp of XLA's, which leaves every row's order,
hence every RANSAC sample, the same (``tests/test_torch_threefry.py``).

The port's pipelines draw from ``solvers/ransac.py::frame_generator``;
these draws are injected through their ``draws``/``verify_draws``
arguments to hold a run against a recorded JAX reference
(``chip_smoke.py``).  The module imports numpy only, so the card's
machine, which has no JAX, can load it.
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k1, k2, x0, x1):
    """The Threefry-2x32 block (20 rounds) of counts (x0, x1) under the
    key (k1, k2); uint32 arrays in, two uint32 arrays out."""
    k1, k2 = np.uint32(k1), np.uint32(k2)
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(0x1BD11BDA))
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int):
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: (0, seed)."""
    return np.uint32(0), np.uint32(seed & 0xFFFFFFFF)


def fold_in(key, data: int):
    """``jax.random.fold_in(key, data)``."""
    b0, b1 = threefry2x32(*key, np.zeros(1, np.uint32),
                          np.asarray([data & 0xFFFFFFFF], np.uint32))
    return b0[0], b1[0]


def split(key, num: int = 2):
    """``jax.random.split(key, num)`` (partitionable): the hash of the
    counts 0..num-1."""
    b0, b1 = threefry2x32(*key, np.zeros(num, np.uint32),
                          np.arange(num, dtype=np.uint32))
    return list(zip(b0, b1))


def random_bits(key, shape):
    """32 uniform bits per element of ``shape`` (partitionable)."""
    n = int(np.prod(shape))
    b0, b1 = threefry2x32(*key, np.zeros(n, np.uint32),
                          np.arange(n, dtype=np.uint32))
    return (b0 ^ b1).reshape(shape)


def gumbel(key, shape):
    """``jax.random.gumbel(key, shape, float32)``: -log(-log(u)) of
    uniform u in [tiny, 1) made from the top 23 bits."""
    bits = (random_bits(key, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    tiny = np.finfo(np.float32).tiny
    u = bits.view(np.float32) - np.float32(1.0)
    u = np.maximum(np.float32(tiny),
                   u * (np.float32(1.0) - np.float32(tiny)) + np.float32(tiny))
    return -np.log(-np.log(u))


def frame_gumbel(seed: int, t: int, shape):
    """The draws of frame t's stereo solve in the JAX package:
    PRNGKey(seed) -> fold_in(t) -> split(1) -> gumbel."""
    return gumbel(split(fold_in(prng_key(seed), t), 1)[0], shape)


def mono_gumbel(seed: int, t: int, shape1, shape2):
    """The two draws (est1, est2) of frame t's mono step: fold_in(t) ->
    split -> gumbel each."""
    k1, k2 = split(fold_in(prng_key(seed), t), 2)
    return gumbel(k1, shape1), gumbel(k2, shape2)


def loop_verify_gumbel(seed: int, t: int, it, shape):
    """A stereo loop verification's draws: fold_in(1_000_000 + t) for the
    seed solve (``it`` None), fold_in(2_000_000 + 2 t + it) for refinement
    round ``it``, sampled directly."""
    index = 1_000_000 + t if it is None else 2_000_000 + 2 * t + it
    return gumbel(fold_in(prng_key(seed), index), shape)


def sim3_verify_gumbel(seed: int, q: int, shape):
    """The mono loop's Sim(3) verification draws of query keyframe q:
    fold_in(fold_in(key, 1_000_003), q), sampled directly."""
    return gumbel(fold_in(fold_in(prng_key(seed), 1_000_003), q), shape)


def window_gumbel(seed: int, w: int, T_w: int, shape):
    """The draws of window w of the windowed BA (a window of T_w frames):
    fold_in(w) -> split(T_w - 1) -> gumbel each, stacked as
    (T_w - 1, *shape)."""
    keys = split(fold_in(prng_key(seed), w), T_w - 1)
    return np.stack([gumbel(k, shape) for k in keys])


def chunk_gumbel(seed: int, n_chunks: int, c: int, n: int, shape):
    """The draws of chunk c of the JAX package's sharded odometry (chunks
    of n + 1 frames): split(PRNGKey(seed), n_chunks)[c] -> split(n) ->
    gumbel each, stacked as (n, *shape)."""
    keys = split(split(prng_key(seed), n_chunks)[c], n)
    return np.stack([gumbel(k, shape) for k in keys])
