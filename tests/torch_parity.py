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
