"""The tensor-parallel matcher of libviso_torch (``parallel/tp_matching.py``)
against the port's local matcher and libviso_tpu's ``tp_match_descriptors``.

Meshes repeat the CPU device (the JAX side uses the 8 virtual CPU devices
of tests/conftest.py).  Tolerances:
  - 'l1' on integer-valued descriptors: indices, validity and distances
    equal the local matcher's and JAX's exactly (every L1 sum is an exact
    integer, whatever the order);
  - 'l2': at least 99 % of indices equal the local matcher's and the
    distances of those rows agree within rtol 1e-5, the tolerance of
    tests/test_tp_matching.py::test_tp_l2_metric_matches_local_within_tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libviso_tpu.config import MatchConfig as JMatchConfig
from libviso_tpu.ops.features import Keypoints as JKeypoints
from libviso_tpu.parallel import make_mesh as jax_make_mesh
from libviso_tpu.parallel import tp_match_descriptors as jax_tp_match
from libviso_torch.config import MatchConfig
from libviso_torch.ops.features import Keypoints
from libviso_torch.ops.matching import match_descriptors
from libviso_torch.parallel import (
    build_tp_matcher,
    make_mesh,
    tp_match_descriptors,
)
from libviso_torch.parallel.tp_matching import merge_shard_minima
from tests.torch_parity import to_np


def _problem(rng, n1=64, n2=128, d=32, w=200.0, h=100.0, integer=True):
    def kp(n):
        return (rng.uniform(0, [w, h], (n, 2)).astype(np.float32),
                rng.random(n).astype(np.float32), rng.random(n) > 0.1)

    def desc(n):
        if integer:   # exact L1 sums, with real ties among them
            return rng.integers(-30, 31, (n, d)).astype(np.float32)
        return rng.standard_normal((n, d)).astype(np.float32)

    return kp(n1), desc(n1), kp(n2), desc(n2)


def _torch(p):
    (k1, d1, k2, d2) = p
    return (Keypoints(*(torch.from_numpy(x) for x in k1)),
            torch.from_numpy(d1),
            Keypoints(*(torch.from_numpy(x) for x in k2)),
            torch.from_numpy(d2))


def _jax(p):
    (k1, d1, k2, d2) = p
    return (JKeypoints(*(jnp.asarray(x) for x in k1)), jnp.asarray(d1),
            JKeypoints(*(jnp.asarray(x) for x in k2)), jnp.asarray(d2))


def _assert_same(a, b):
    for field in ("idx", "valid", "dist"):
        np.testing.assert_array_equal(to_np(getattr(a, field)),
                                      np.asarray(to_np(getattr(b, field))))


def _mesh(n_model, n_data=1):
    return make_mesh(n_data=n_data, n_model=n_model,
                     devices=["cpu"] * (n_data * n_model))


@pytest.mark.parametrize("n_model", [2, 4, 8])
def test_tp_l1_equals_local_and_jax_exactly(rng, n_model):
    p = _problem(rng)
    cfg = dict(radius=120.0, use_ratio=True, ratio=0.9, metric="l1")
    local = match_descriptors(*_torch(p), MatchConfig(**cfg))
    got = tp_match_descriptors(_mesh(n_model), *_torch(p), MatchConfig(**cfg))
    _assert_same(got, local)
    want = jax_tp_match(jax_make_mesh(n_data=1, n_model=n_model), *_jax(p),
                        JMatchConfig(**cfg))
    _assert_same(got, want)
    assert int(got.valid.sum()) > 10


@pytest.mark.parametrize("n_data,n_model", [(1, 4), (2, 4)])
def test_tp_with_epipolar_gate(rng, n_data, n_model):
    """With the Sampson gate, and on a mesh with a 'data' axis too."""
    p = _problem(rng, n1=32, n2=64, d=16)
    F = rng.standard_normal((3, 3)).astype(np.float32)
    cfg = MatchConfig(radius=500.0, use_epipolar=True, sampson_thresh=50.0,
                      metric="l1")
    local = match_descriptors(*_torch(p), cfg, F=torch.from_numpy(F))
    got = tp_match_descriptors(_mesh(n_model, n_data), *_torch(p), cfg,
                               F=torch.from_numpy(F))
    _assert_same(got, local)
    assert int(got.valid.sum()) > 0


@pytest.mark.parametrize("backend", ["fused", "sweep"])
def test_tp_fused_backends(rng, backend):
    """The fused routes run per shard too (their plain versions on the
    CPU); the fused kernel keeps the lowest slot among ties, the sweep
    the lowest x, so only the fused route is held to the local result
    bit for bit."""
    p = _problem(rng)
    cfg = MatchConfig(radius=120.0, use_ratio=True, ratio=0.9, metric="l1")
    got = tp_match_descriptors(_mesh(4), *_torch(p), cfg, backend=backend)
    local = match_descriptors(*_torch(p), cfg, backend=backend)
    if backend == "fused":
        _assert_same(got, local)
    assert torch.equal(got.dist, local.dist)


def test_merge_tie_breaking_prefers_lowest_global_index():
    best, second, idx = merge_shard_minima(
        torch.tensor([[1.0], [1.0]]), torch.tensor([[5.0], [7.0]]),
        torch.tensor([[3], [9]]))
    assert int(idx[0]) == 3          # the first shard wins ties
    assert float(best[0]) == 1.0
    assert float(second[0]) == 1.0   # the other shard's equal best


def test_merge_second_best_across_shards():
    best, second, idx = merge_shard_minima(
        torch.tensor([[1.0], [2.0]]), torch.tensor([[10.0], [11.0]]),
        torch.tensor([[0], [5]]))
    assert float(best[0]) == 1.0 and int(idx[0]) == 0
    assert float(second[0]) == 2.0


def test_build_tp_matcher_reuse_and_divisibility(rng):
    p = _problem(rng, n1=32, n2=64, d=16)
    cfg = MatchConfig(radius=150.0, metric="l1")
    fn = build_tp_matcher(_mesh(4), cfg)
    _assert_same(fn(*_torch(p)), match_descriptors(*_torch(p), cfg))
    _assert_same(fn(*_torch(p)), match_descriptors(*_torch(p), cfg))
    with pytest.raises(ValueError, match="divisible"):
        build_tp_matcher(_mesh(3), cfg)(*_torch(p))


def test_tp_l2_metric_matches_local_within_tolerance(rng):
    p = _problem(rng, n1=128, n2=256, d=32, integer=False)
    cfg = MatchConfig(radius=120.0, use_ratio=True, ratio=0.9, metric="l2")
    ref = match_descriptors(*_torch(p), cfg)
    got = tp_match_descriptors(_mesh(8), *_torch(p), cfg)
    same = to_np(ref.idx) == to_np(got.idx)
    assert same.mean() > 0.99, same.mean()
    rd, gd = to_np(ref.dist)[same], to_np(got.dist)[same]
    finite = np.isfinite(rd)
    np.testing.assert_allclose(gd[finite], rd[finite], rtol=1e-5)
