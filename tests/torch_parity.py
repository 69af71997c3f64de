"""Shared helpers for the tests that hold libviso_torch against libviso_tpu.

Inputs are made with numpy from a seed and handed to both packages; JAX
stays on the CPU (tests/conftest.py).  Torch is pinned to one thread
because the suite runs in several worker processes at once.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

torch.set_num_threads(1)


def to_torch(x):
    """numpy or jax array -> CPU torch tensor (a copy)."""
    return torch.from_numpy(np.array(x))


def to_np(x):
    """torch tensor or jax array -> numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def jax_frame_gumbel(seed: int, t: int, num_hypotheses: int, num_slots: int):
    """The RANSAC Gumbel draws the JAX pipeline makes for frame ``t``
    (PRNGKey(seed) -> fold_in(t) -> split(1) -> gumbel), as a torch tensor.
    """
    key = jax.random.fold_in(jax.random.PRNGKey(seed), t)
    rk, = jax.random.split(key, 1)
    return to_torch(jax.random.gumbel(rk, (num_hypotheses, num_slots),
                                      jnp.float32))


def jax_mono_gumbel(seed: int, t: int, H1: int, H2: int, N: int):
    """The two RANSAC draws (est1, est2) the JAX mono step makes for frame
    ``t`` (PRNGKey(seed) -> fold_in(t) -> split -> gumbel each), as torch
    tensors."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), t)
    k1, k2 = jax.random.split(key)
    return (to_torch(jax.random.gumbel(k1, (H1, N), jnp.float32)),
            to_torch(jax.random.gumbel(k2, (H2, N), jnp.float32)))


def jax_null_basis(Q):
    """The 5-point solver's null-space basis as the JAX package computes
    it (``jnp.linalg.svd``, rows 5-8 of Vh reversed), for the port's
    ``null_basis`` seam: Q (..., 5, 9) torch -> (..., 4, 3, 3) torch."""
    vt = np.asarray(jnp.linalg.svd(jnp.asarray(to_np(Q)),
                                   full_matrices=True)[2])
    basis = vt[..., 5:9, :].reshape(*Q.shape[:-2], 4, 3, 3)[..., ::-1, :, :]
    return torch.from_numpy(np.ascontiguousarray(basis)).to(Q.device)


def jax_key_gumbel(key, shape):
    """``jax.random.gumbel(key, shape)`` as a torch tensor: the draws of a
    JAX function that samples from its key directly (the 3D-3D RANSACs of
    ``geometry/procrustes.py``)."""
    return to_torch(jax.random.gumbel(key, shape, jnp.float32))


def jax_loop_verify_gumbel(seed: int, t: int, it, num_hypotheses: int,
                           num_slots: int):
    """The draws of a loop verification solve of the JAX ``LoopEngine``
    for keyframe-cadence frame ``t``: the seed solve (``it`` None) draws
    under fold_in(key, 1_000_000 + t), refinement round ``it`` under
    fold_in(key, 2_000_000 + 2 t + it), and ``ransac_pose`` samples that
    key directly (a frame's step splits its key first)."""
    index = 1_000_000 + t if it is None else 2_000_000 + 2 * t + it
    return jax_key_gumbel(jax.random.fold_in(jax.random.PRNGKey(seed), index),
                          (num_hypotheses, num_slots))


def jax_sim3_verify_gumbel(seed: int, q: int, num_hypotheses: int,
                           num_slots: int):
    """The draws of the JAX mono loop's Sim(3) verification of query
    keyframe ``q``: fold_in(fold_in(PRNGKey(seed), 1_000_003), q), sampled
    directly by ``ransac_similarity``."""
    key = jax.random.fold_in(
        jax.random.fold_in(jax.random.PRNGKey(seed), 1_000_003), q)
    return jax_key_gumbel(key, (num_hypotheses, num_slots))


def jax_window_gumbel(seed: int, w: int, n: int, num_hypotheses: int,
                      num_slots: int):
    """The draws of window w of the JAX windowed BA, for its n transitions:
    fold_in(PRNGKey(seed), w) -> split(n) -> gumbel each, as an (n, H, N)
    torch tensor (the port's ``draws(w, n)`` seam)."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), w)
    return torch.stack([
        to_torch(jax.random.gumbel(k, (num_hypotheses, num_slots),
                                   jnp.float32))
        for k in jax.random.split(key, n)])


def jax_chunk_gumbel(seed: int, n_chunks: int, c: int, n: int,
                     num_hypotheses: int, num_slots: int):
    """The draws of chunk c of the JAX sharded odometry, for its n
    transitions: split(PRNGKey(seed), n_chunks)[c] -> split(n) -> gumbel
    each, as an (n, H, N) torch tensor (the port's ``draws(c, n)`` seam)."""
    key = jax.random.split(jax.random.PRNGKey(seed), n_chunks)[c]
    return torch.stack([
        to_torch(jax.random.gumbel(k, (num_hypotheses, num_slots),
                                   jnp.float32))
        for k in jax.random.split(key, n)])
