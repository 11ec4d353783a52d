"""ekf_slam_tpu_torch.parallel.posegraph against ekf_slam_tpu's on the
CPU at f64: the square loop of tests/test_posegraph.py built through both
packages' add_node/add_edge, then relative_pose, the edge residuals and
Jacobians, graph_error, the device Gauss-Newton (``optimize``) and the
host f64 one (``optimize_np``), nodes within 1e-9; and the capacity
masking of both tables."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekf_slam_tpu.parallel import posegraph as jpg
from ekf_slam_tpu_torch.parallel import posegraph as tpg

from torch_parity_helpers import n
from test_posegraph import build_square_graph


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _tables(g):
    return {f: n(getattr(g, f)) for f in tpg.PoseGraph._fields[:6]}


def _assert_graphs(jg, tg, tol=1e-9):
    assert tg.n_nodes == int(jg.n_nodes) and tg.n_edges == int(jg.n_edges)
    want, got = _tables(jg), _tables(tg)
    for f in ("node_valid", "edge_ij", "edge_valid"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    for f in ("nodes", "edge_z", "edge_info"):
        np.testing.assert_allclose(got[f], want[f], rtol=0, atol=tol,
                                   err_msg=f)


def _port_graph(jg):
    """The JAX graph rebuilt through the port's add_node/add_edge, in the
    order the JAX graph holds its nodes and edges."""
    g = tpg.init_graph(jg.nodes.shape[0], jg.edge_ij.shape[0],
                       torch.float64, device="cpu")
    for i in range(int(jg.n_nodes)):
        g, nid = tpg.add_node(g, np.array(jg.nodes[i]))
        assert nid == i
    for e in range(int(jg.n_edges)):
        i, j = (int(v) for v in np.asarray(jg.edge_ij[e]))
        g = tpg.add_edge(g, i, j, np.array(jg.edge_z[e]),
                         np.array(jg.edge_info[e]))
    return g


@functools.lru_cache(maxsize=None)
def _square(drift, noise, closure):
    """The square loop (odometry drift and noise), with or without a
    closure edge from the last node to the first at the true relative
    pose; built once a case (JAX's appends are slow eagerly)."""
    jg, true = build_square_graph(drift=drift, noise=noise)
    if closure:
        k = int(jg.n_nodes)
        z = jpg.relative_pose(jnp.asarray(true[k - 1]), jnp.asarray(true[0]))
        jg = jpg.add_edge(jg, k - 1, 0, z,
                          jnp.asarray([100.0, 100.0, 100.0], jnp.float64))
    return jg, true


CASES = [(0.0, 0.0, False), (0.01, 0.001, True), (0.02, 0.01, True)]


@pytest.mark.parametrize("drift,noise,closure", CASES)
def test_graph_built_through_the_port_matches(drift, noise, closure):
    jg, _ = _square(drift, noise, closure)
    _assert_graphs(jg, _port_graph(jg), tol=0.0)


@pytest.mark.parametrize("iters", [1, 15])
@pytest.mark.parametrize("drift,noise,closure", CASES)
def test_optimize_matches_jax(drift, noise, closure, iters):
    """The device Gauss-Newton (scatter-add of 3×3 blocks, dense solve)
    on the CPU at f64: nodes within 1e-9 of JAX's after each count of
    iterations."""
    jg, _ = _square(drift, noise, closure)
    want = jpg.optimize(jg, iters=iters)
    got = tpg.optimize(_port_graph(jg), iters=iters)
    _assert_graphs(want, got)


@pytest.mark.parametrize("drift,noise,closure", CASES)
def test_optimize_np_matches_jax(drift, noise, closure):
    jg, _ = _square(drift, noise, closure)
    want = jpg.optimize_np(jg, iters=15)
    got = tpg.optimize_np(_port_graph(jg), iters=15)
    assert got.nodes.dtype == torch.float64
    _assert_graphs(want, got)


def test_optimize_np_keeps_an_f32_graph_f32():
    """The host solve runs in f64 whatever the graph's dtype; the nodes
    come back rounded to it, as JAX's do."""
    jg, _ = _square(0.01, 0.001, True)
    j32 = jg._replace(**{f: getattr(jg, f).astype(jnp.float32)
                         for f in ("nodes", "edge_z", "edge_info")})
    t32 = _port_graph(jg)
    t32 = t32._replace(**{f: getattr(t32, f).float()
                          for f in ("nodes", "edge_z", "edge_info")})
    want = jpg.optimize_np(j32, iters=15)
    got = tpg.optimize_np(t32, iters=15)
    assert got.nodes.dtype == torch.float32
    np.testing.assert_array_equal(n(got.nodes), n(want.nodes))


@pytest.mark.parametrize("drift,noise,closure", CASES)
def test_graph_error_matches(drift, noise, closure):
    jg, _ = _square(drift, noise, closure)
    want = float(jpg.graph_error(jg))
    got = float(tpg.graph_error(_port_graph(jg)))
    assert got == pytest.approx(want, rel=1e-12, abs=1e-15)


@pytest.mark.parametrize("seed", range(4))
def test_relative_pose_and_jacobians_match(seed):
    rng = np.random.default_rng(seed)
    xi = np.array([*rng.normal(0, 3, 2), rng.uniform(-180, 360)])
    xj = np.array([*rng.normal(0, 3, 2), rng.uniform(-180, 360)])
    z = np.array([*rng.normal(0, 1, 2), rng.uniform(-200, 200)])
    want = jpg.relative_pose(jnp.asarray(xi), jnp.asarray(xj))
    got = tpg.relative_pose(torch.from_numpy(xi), torch.from_numpy(xj))
    np.testing.assert_allclose(n(got), n(want), rtol=0, atol=1e-12)
    for w, g in zip(jpg._residual_and_jac(jnp.asarray(xi), jnp.asarray(xj),
                                          jnp.asarray(z)),
                    tpg._residual_and_jac(torch.from_numpy(xi),
                                          torch.from_numpy(xj),
                                          torch.from_numpy(z))):
        np.testing.assert_allclose(n(g), n(w), rtol=0, atol=1e-12)


def test_batched_jacobians_equal_the_single_edge_ones():
    rng = np.random.default_rng(7)
    xi, xj = rng.normal(0, 2, (5, 3)), rng.normal(0, 2, (5, 3))
    z = rng.normal(0, 1, (5, 3))
    batch = tpg._residual_and_jac(*(torch.from_numpy(a) for a in (xi, xj, z)))
    for e in range(5):
        one = tpg._residual_and_jac(*(torch.from_numpy(a[e])
                                      for a in (xi, xj, z)))
        for b, o in zip(batch, one):
            assert torch.equal(b[e], o)


def test_capacity_masking_matches_jax():
    """A full node table drops the node (and still returns n_nodes), a
    full edge table drops the edge, as in JAX."""
    jg = jpg.init_graph(max_nodes=2, max_edges=1, dtype=jnp.float64)
    tg = tpg.init_graph(max_nodes=2, max_edges=1, dtype=torch.float64,
                        device="cpu")
    for x in (0.0, 1.0, 2.0):
        jg, ji = jpg.add_node(jg, jnp.asarray([x, 0.0, 0.0], jnp.float64))
        tg, ti = tpg.add_node(tg, np.array([x, 0.0, 0.0]))
        assert ti == int(ji)
    assert tg.n_nodes == 2
    for z in (1.0, -1.0):
        jg = jpg.add_edge(jg, 0, 1, jnp.asarray([z, 0, 0], jnp.float64),
                          jnp.ones(3, jnp.float64))
        tg = tpg.add_edge(tg, 0, 1, np.array([z, 0.0, 0.0]), np.ones(3))
    assert tg.n_edges == 1
    _assert_graphs(jg, tg, tol=0.0)


def test_append_leaves_the_given_graph_as_it_was():
    g0 = tpg.init_graph(4, 4, torch.float64, device="cpu")
    g1, _ = tpg.add_node(g0, np.array([1.0, 2.0, 3.0]))
    g2 = tpg.add_edge(g1, 0, 0, np.ones(3), np.ones(3))
    assert g0.n_nodes == 0 and not bool(g0.node_valid.any())
    assert not bool(g0.nodes.any())
    assert g1.n_edges == 0 and not bool(g1.edge_valid.any())
    assert g2.n_nodes == 1 and g2.n_edges == 1


def test_init_graph_needs_a_device_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpg.init_graph(4, 4)
