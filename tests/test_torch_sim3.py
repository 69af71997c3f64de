"""The Sim(3) utilities of libviso_torch against libviso_tpu.

``geometry/sim3.py``'s six functions on random 7-vectors (scales 0.5-2,
angles away from the ry = +-pi/2 lock) and on the products of such
transforms; float32 throughout, within 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from libviso_tpu.geometry import sim3 as js
from libviso_torch.geometry import sim3 as ts
from tests.torch_parity import to_np, to_torch


@pytest.fixture(scope="module")
def xi():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-0.8, 0.8, (32, 3)),
                        rng.uniform(-5, 5, (32, 3)),
                        rng.uniform(np.log(0.5), np.log(2.0), (32, 1))], -1)
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def S(xi):
    return np.asarray(js.sim3_vector_to_matrix(jnp.asarray(xi)))


def test_vector_to_matrix(xi, S):
    np.testing.assert_allclose(to_np(ts.sim3_vector_to_matrix(to_torch(xi))),
                               S, atol=1e-5)


def test_from_parts(xi, S):
    rng = np.random.default_rng(1)
    s = rng.uniform(0.5, 2.0, 32).astype(np.float32)
    R, t = S[:, :3, :3], S[:, :3, 3]
    np.testing.assert_allclose(
        to_np(ts.sim3_from_parts(to_torch(s), to_torch(R), to_torch(t))),
        np.asarray(js.sim3_from_parts(s, R, t)), atol=1e-5)


@pytest.mark.parametrize("fn", ["sim3_scale", "matrix_to_sim3_vector",
                                "invert_sim3", "sim3_to_se3"])
def test_matrix_functions(S, fn):
    prod = S @ S[::-1]    # products: scales up to 4
    for M in (S, prod):
        np.testing.assert_allclose(to_np(getattr(ts, fn)(to_torch(M))),
                                   np.asarray(getattr(js, fn)(M)),
                                   rtol=1e-5, atol=1e-5)


def test_round_trip_and_inverse(xi, S):
    St = to_torch(S)
    np.testing.assert_allclose(to_np(ts.matrix_to_sim3_vector(St)), xi,
                               atol=1e-5)
    eye = to_np(ts.invert_sim3(St) @ St)
    np.testing.assert_allclose(eye, np.broadcast_to(np.eye(4), eye.shape),
                               atol=1e-5)
