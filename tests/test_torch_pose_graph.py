"""The pose-graph back-ends of libviso_torch against libviso_tpu.

``solvers/pose_graph.py`` and ``solvers/pose_graph_sim3.py`` on the graphs
of ``tests/test_pose_graph.py`` (the drifted circle with a true closing
edge and a false one) and on a Sim(3) graph whose loop edge carries a
scale, under each robust kernel.  Both packages solve in float32 with the
same step rule; their Jacobians (``jax.jacfwd`` and ``torch.func.jacfwd``)
and Cholesky factors round differently, and the graph with a false edge
amplifies that rounding: with the false edge under a soft or no kernel the
optimum is a flat valley (the cost changes in the 7th digit over the last
iterations) along which float32 noise moves the poses.  So each case has
its pose tolerance, against JAX and against the port's own float64 solve
(which both float32 solves approach alike), from these measured gaps:

  graph, kernel     |port - JAX|  |port - f64|  |JAX - f64|   tolerance
  SE(3) cauchy/huber    < 1e-4                                  1e-4
  SE(3) none            5.5e-3        6.1e-3       5.7e-4        1e-2
  Sim(3) cauchy         2.1e-4        3.7e-4       2.0e-4        2e-3
  Sim(3) huber          1.3e-3        9.4e-4       3.2e-4        2e-3
  Sim(3) none           5.8e-3        9.4e-6       5.8e-3        1e-2

Costs agree within rtol 1e-3 and the IRLS edge weights within 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libviso_tpu.geometry import sim3 as jsim3
from libviso_tpu.solvers import pose_graph as jpg
from libviso_tpu.solvers import pose_graph_sim3 as jpg3
from libviso_torch.geometry import sim3 as tsim3
from libviso_torch.solvers import pose_graph as tpg
from libviso_torch.solvers import pose_graph_sim3 as tpg3
from tests.test_pose_graph import _drifted_loop_setup
from tests.torch_parity import to_np, to_torch

KERNELS = ("cauchy", "huber", "none")


@pytest.fixture(scope="module")
def false_edge_graph():
    """tests/test_pose_graph.py's drifted 24-node circle with its true
    closing edge and a false one (loop edges robust, weight 50)."""
    T = 24
    gt, i, j, z_noisy, drifted, z_true = _drifted_loop_setup(T)
    z_false = jpg.invert_se3(gt[8])[None] @ (
        gt[-1] @ jpg.pose_vector_to_matrix(
            jnp.asarray([0.0, 0.6, 0.0, 4.0, 0.0, 3.0], jnp.float32)))[None]
    return dict(
        poses=np.asarray(drifted),
        ei=np.concatenate([np.asarray(i), [0, 8]]).astype(np.int32),
        ej=np.concatenate([np.asarray(j), [T - 1, T - 1]]).astype(np.int32),
        z=np.concatenate([np.asarray(z_noisy), np.asarray(z_true),
                          np.asarray(z_false)]),
        w=np.concatenate([np.ones(T - 1), [50.0, 50.0]]).astype(np.float32),
        mask=np.concatenate([np.zeros(T - 1, bool), [True, True]]),
        gt=np.asarray(gt))


def _same(jres, tres, pose_atol=1e-4, t64=None):
    np.testing.assert_allclose(to_np(tres.poses), np.asarray(jres.poses),
                               atol=pose_atol)
    if t64 is not None:
        np.testing.assert_allclose(to_np(tres.poses), to_np(t64.poses),
                                   atol=pose_atol)
    np.testing.assert_allclose(float(tres.cost0), float(jres.cost0),
                               rtol=1e-3)
    np.testing.assert_allclose(float(tres.cost), float(jres.cost),
                               rtol=1e-3, atol=1e-7)
    assert bool(tres.ok) == bool(jres.ok)
    np.testing.assert_allclose(to_np(tres.edge_scale),
                               np.asarray(jres.edge_scale), atol=1e-4)


@pytest.mark.parametrize("robust", KERNELS)
def test_optimize_pose_graph_matches_jax(false_edge_graph, robust):
    g = false_edge_graph
    jres = jpg.optimize_pose_graph(
        jnp.asarray(g["poses"]), jnp.asarray(g["ei"]), jnp.asarray(g["ej"]),
        jnp.asarray(g["z"]), weights=g["w"], iters=15, robust=robust,
        robust_mask=jnp.asarray(g["mask"]))
    tres, t64 = (tpg.optimize_pose_graph(
        to_torch(g["poses"]).to(dt), to_torch(g["ei"]), to_torch(g["ej"]),
        to_torch(g["z"]).to(dt), weights=to_torch(g["w"]).to(dt), iters=15,
        robust=robust, robust_mask=to_torch(g["mask"]))
        for dt in (torch.float32, torch.float64))
    _same(jres, tres, pose_atol=1e-2 if robust == "none" else 1e-4,
          t64=t64)
    if robust == "cauchy":
        # the kernel's verdict: the true edge believed, the false rejected
        T = g["poses"].shape[0]
        assert float(tres.edge_scale[T - 1]) > 0.5
        assert float(tres.edge_scale[T]) < 0.05


def test_robust_mask_none_means_every_edge(false_edge_graph):
    g = false_edge_graph
    args = [g["poses"], g["ei"], g["ej"], g["z"]]
    jres = jpg.optimize_pose_graph(*map(jnp.asarray, args), weights=g["w"],
                                   iters=6)
    tres = tpg.optimize_pose_graph(*map(to_torch, args),
                                   weights=to_torch(g["w"]), iters=6)
    _same(jres, tres)


def test_odometry_edges_and_exact_graph(false_edge_graph):
    gt = false_edge_graph["gt"]
    ji, jj, jz = jpg.odometry_edges(jnp.asarray(gt))
    ti, tj, tz = tpg.odometry_edges(to_torch(gt))
    np.testing.assert_array_equal(to_np(ti), np.asarray(ji))
    np.testing.assert_array_equal(to_np(tj), np.asarray(jj))
    np.testing.assert_allclose(to_np(tz), np.asarray(jz), rtol=1e-6,
                               atol=1e-6)
    res = tpg.optimize_pose_graph(to_torch(gt), ti, tj, tz, iters=3)
    assert bool(res.ok)
    np.testing.assert_allclose(to_np(res.poses), gt, atol=1e-4)


def test_reanchor_segments_matches_jax(false_edge_graph):
    gt = false_edge_graph["gt"][:12]
    nodes = np.asarray([0, 4, 8, 11], np.int32)
    rng = np.random.default_rng(4)
    shifted = gt[nodes] @ np.asarray(jpg.pose_vector_to_matrix(
        jnp.asarray(rng.normal(size=(4, 6)) * 0.05, jnp.float32)))
    want = jpg.reanchor_segments(jnp.asarray(gt), jnp.asarray(nodes),
                                 jnp.asarray(shifted))
    got = tpg.reanchor_segments(to_torch(gt), to_torch(nodes),
                                to_torch(shifted))
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-5)


@pytest.fixture(scope="module")
def sim3_graph(false_edge_graph):
    """The drifted circle as a Sim(3) graph: the true closing edge scaled
    by 1.15 and the false edge kept."""
    g = dict(false_edge_graph)
    z = g["z"].copy()
    T = g["poses"].shape[0]
    z[T - 1, :3, :3] *= 1.15
    g["z"] = z
    return g


@pytest.mark.parametrize("robust", KERNELS)
def test_optimize_sim3_graph_matches_jax(sim3_graph, robust):
    g = sim3_graph
    kw = dict(iters=10, robust=robust, robust_delta=0.5, scale_weight=2.0)
    jres = jpg3.optimize_sim3_graph(
        jnp.asarray(g["poses"]), jnp.asarray(g["ei"]), jnp.asarray(g["ej"]),
        jnp.asarray(g["z"]), weights=g["w"],
        robust_mask=jnp.asarray(g["mask"]), **kw)
    tres, t64 = (tpg3.optimize_sim3_graph(
        to_torch(g["poses"]).to(dt), to_torch(g["ei"]), to_torch(g["ej"]),
        to_torch(g["z"]).to(dt), weights=to_torch(g["w"]).to(dt),
        robust_mask=to_torch(g["mask"]), **kw)
        for dt in (torch.float32, torch.float64))
    _same(jres, tres, pose_atol=1e-2 if robust == "none" else 2e-3, t64=t64)
    np.testing.assert_allclose(to_np(tsim3.sim3_scale(tres.poses)),
                               np.asarray(jsim3.sim3_scale(jres.poses)),
                               atol=1e-4)


def test_reanchor_segments_sim3_matches_jax(sim3_graph):
    gt = sim3_graph["gt"][:12]
    nodes = np.asarray([0, 4, 8, 11], np.int32)
    rng = np.random.default_rng(5)
    xi = rng.normal(size=(4, 7)) * 0.05
    S = gt[nodes] @ np.asarray(jsim3.sim3_vector_to_matrix(
        jnp.asarray(xi, jnp.float32)))
    want = jpg3.reanchor_segments_sim3(jnp.asarray(gt), jnp.asarray(nodes),
                                       jnp.asarray(S))
    got = tpg3.reanchor_segments_sim3(to_torch(gt), to_torch(nodes),
                                      to_torch(S.astype(np.float32)))
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-5)


def test_unknown_kernel_raises(false_edge_graph):
    g = false_edge_graph
    with pytest.raises(ValueError, match="robust"):
        tpg.optimize_pose_graph(to_torch(g["poses"]), to_torch(g["ei"]),
                                to_torch(g["ej"]), to_torch(g["z"]),
                                robust="tukey")


def test_failed_factorization_keeps_the_poses():
    """A graph with no edge into node 1 gives a singular H (Cholesky fails
    on the unconstrained delta only through the 1e-8 ridge); the solve
    stays finite and never raises."""
    poses = torch.eye(4).repeat(3, 1, 1)
    z = torch.eye(4)[None]
    res = tpg.optimize_pose_graph(poses, torch.tensor([0]),
                                  torch.tensor([2]), z, iters=2)
    assert torch.isfinite(res.poses).all() and bool(res.ok)
