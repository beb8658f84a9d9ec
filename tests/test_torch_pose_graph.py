"""The port's pose graph against the JAX package's, on the CPU.

The graphs are those of tests/test_pose_graph.py (``make_loop_graph``:
poses around a circle, noisy odometry edges and one exact loop edge), the
same numpy inputs fed to both packages. Bands: residuals, Jacobians and
the solved poses within the SE(3) band (1e-5; the port sums in float64
where the JAX package sums in float32), chi² relative 1e-4; the Jacobians
against finite differences within the JAX test's 5e-2; dense and CG chi²
within 1e-4 relative of each other (tests/test_pose_graph.py:122); the
sharded solves over 4 gloo ranks within 1e-3 m of one rank (the JAX
test's band, tests/test_pose_graph.py:146), two runs equal to the bit.
"""

import numpy as np
import pytest
import torch

import mp2p_icp_tpu_torch
from mp2p_icp_tpu.core import se3 as jse3
from mp2p_icp_tpu.parallel import pose_graph as jpg
from mp2p_icp_tpu_torch.convert import pose_from_numpy, pose_graph_edges_from_jax
from mp2p_icp_tpu_torch.core import se3
from mp2p_icp_tpu_torch.core.se3 import Pose
from mp2p_icp_tpu_torch.parallel import pose_graph as pg
from mp2p_icp_tpu_torch.parallel import ranks
from mp2p_icp_tpu_torch.parallel.launch import spawn_ranks
from mp2p_icp_tpu_torch.parallel.mesh import Mesh, MeshAxis
from tests.test_pose_graph import make_loop_graph

SE3_BAND = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _ask_for_the_cpu():
    """The port's constructors default to the card; these tests run on the
    CPU and say so once for the whole file."""
    mp2p_icp_tpu_torch.set_default_device("cpu")
    yield
    mp2p_icp_tpu_torch.set_default_device(None)


def _pose(p) -> Pose:
    return pose_from_numpy(np.asarray(p.R), np.asarray(p.t))


def _graph(**kw):
    gt, init, edges = make_loop_graph(**kw)
    return (gt, init, edges), (_pose(gt), _pose(init), pose_graph_edges_from_jax(edges))


def _edges_numpy(edges) -> dict:
    return {"i": np.asarray(edges.i), "j": np.asarray(edges.j), "z_R": np.asarray(edges.z.R),
            "z_t": np.asarray(edges.z.t), "information": np.asarray(edges.information),
            "valid": np.asarray(edges.valid)}


def test_adjoint_and_from_matrix_match_jax():
    rng = np.random.RandomState(0)
    xi = rng.randn(5, 6).astype(np.float32) * 0.5
    jp = jse3.exp(xi)
    tp = se3.exp(torch.from_numpy(xi))
    np.testing.assert_allclose(se3.adjoint(tp).numpy(), np.asarray(jse3.adjoint(jp)), atol=SE3_BAND)
    T = np.asarray(jp.as_matrix())
    fm = se3.from_matrix(torch.from_numpy(T))
    np.testing.assert_array_equal(fm.R.numpy(), np.asarray(jse3.from_matrix(T).R))
    np.testing.assert_array_equal(fm.t.numpy(), np.asarray(jse3.from_matrix(T).t))
    # T exp(xi) T^-1 = exp(Ad(T) xi)
    v = torch.from_numpy(rng.randn(5, 6).astype(np.float32) * 0.1)
    lhs = se3.compose(se3.compose(tp, se3.exp(v)), se3.inverse(tp))
    rhs = se3.exp(torch.einsum("nab,nb->na", se3.adjoint(tp), v))
    np.testing.assert_allclose(lhs.t.numpy(), rhs.t.numpy(), atol=1e-4)
    np.testing.assert_allclose(lhs.R.numpy(), rhs.R.numpy(), atol=1e-4)


@pytest.mark.parametrize("noise", [0.0, 0.05])
def test_edge_residuals_match_jax(noise):
    (_, jinit, jedges), (_, init, edges) = _graph(odo_noise=noise)
    rj, Jij, Jjj = jpg.edge_residuals(jinit, jedges)
    r, Ji, Jj = pg.edge_residuals(init, edges)
    np.testing.assert_allclose(r.numpy(), np.asarray(rj), atol=SE3_BAND)
    np.testing.assert_allclose(Ji.numpy(), np.asarray(Jij), atol=SE3_BAND)
    np.testing.assert_allclose(Jj.numpy(), np.asarray(Jjj), atol=SE3_BAND)
    if noise == 0.0:
        gt = _graph(odo_noise=0.0)[1][0]
        np.testing.assert_allclose(pg.edge_residuals(gt, edges)[0].numpy(), 0, atol=1e-4)


@pytest.mark.parametrize("node", ["i", "j"])
def test_jacobians_match_finite_differences(node):
    _, (_, init, edges) = _graph(odo_noise=0.05)
    r0, Ji, Jj = pg.edge_residuals(init, edges)
    e, h = 3, 1e-3
    n = int(getattr(edges, node)[e])
    J = (Ji if node == "i" else Jj)[e].numpy()
    for comp in range(6):
        d = torch.zeros(6)
        d[comp] = h
        p = se3.compose(Pose(init.R[n], init.t[n]), se3.exp(d))
        R, t = init.R.clone(), init.t.clone()
        R[n], t[n] = p.R, p.t
        r1 = pg.edge_residuals(Pose(R, t), edges)[0]
        fd = (r1[e] - r0[e]).numpy() / h
        np.testing.assert_allclose(fd, J[:, comp], atol=5e-2)


# the graphs of TestOptimize / TestOptimizeCG (tests/test_pose_graph.py)
GRAPHS = [(12, 0), (24, 3)]


@pytest.mark.parametrize("n, seed", GRAPHS)
def test_dense_matches_jax(n, seed):
    (_, jinit, jedges), (gt, init, edges) = _graph(n=n, odo_noise=0.05, seed=seed)
    jp = jpg.PoseGraphParams(max_iterations=10, damping=1e-4)
    jopt, jchi = jpg.optimize_pose_graph(jinit, jedges, jp)
    opt, chi = pg.optimize_pose_graph(init, edges, pg.PoseGraphParams(max_iterations=10,
                                                                      damping=1e-4))
    np.testing.assert_allclose(opt.t.numpy(), np.asarray(jopt.t), atol=SE3_BAND)
    np.testing.assert_allclose(opt.R.numpy(), np.asarray(jopt.R), atol=SE3_BAND)
    assert abs(float(chi) - float(jchi)) <= 1e-4 * max(1.0, float(jchi))
    init_err = np.linalg.norm(init.t.numpy() - gt.t.numpy(), axis=-1).mean()
    assert np.linalg.norm(opt.t.numpy() - gt.t.numpy(), axis=-1).mean() < 0.6 * init_err


@pytest.mark.parametrize("n, seed", GRAPHS)
def test_cg_matches_jax_and_dense(n, seed):
    (_, jinit, jedges), (_, init, edges) = _graph(n=n, odo_noise=0.05, seed=seed)
    cgp = dict(max_iterations=10, cg_iterations=100, damping=1e-4)
    jopt, jchi = jpg.optimize_pose_graph_cg(jinit, jedges, jpg.PoseGraphCGParams(**cgp))
    opt, chi = pg.optimize_pose_graph_cg(init, edges, pg.PoseGraphCGParams(**cgp))
    np.testing.assert_allclose(opt.t.numpy(), np.asarray(jopt.t), atol=SE3_BAND)
    assert abs(float(chi) - float(jchi)) <= 1e-4 * max(1.0, float(jchi))
    dense, chi_d = pg.optimize_pose_graph(init, edges, pg.PoseGraphParams(max_iterations=10,
                                                                          damping=1e-4))
    assert abs(float(chi) - float(chi_d)) < 1e-4 * max(1.0, float(chi_d))
    if n == 12:  # the translations too, on the JAX test's graph (up to the gauge's wiggle)
        np.testing.assert_allclose(opt.t.numpy(), dense.t.numpy(), atol=1e-2)


def test_perfect_graph_stays_put_and_runs_repeat_to_the_bit():
    _, (gt, _, edges) = _graph(odo_noise=0.0)
    opt, chi = pg.optimize_pose_graph(gt, edges)
    np.testing.assert_allclose(opt.t.numpy(), gt.t.numpy(), atol=1e-3)
    assert float(chi) < 1e-6
    _, (_, init, edges) = _graph(odo_noise=0.05)
    for solve in (pg.optimize_pose_graph, pg.optimize_pose_graph_cg):
        a, ca = solve(init, edges)
        b, cb = solve(init, edges)
        assert torch.equal(a.R, b.R) and torch.equal(a.t, b.t) and float(ca) == float(cb)


def test_sharded_needs_edges_divisible_by_the_ranks():
    _, (_, init, edges) = _graph(n=12)  # 12 edges
    mesh = Mesh(data=MeshAxis("data", 5, 0), space=MeshAxis("space", 1, 0))
    with pytest.raises(ValueError, match="pad with valid=False"):
        pg.optimize_pose_graph_sharded(init, edges, mesh)
    with pytest.raises(ValueError, match="pad with valid=False"):
        pg.optimize_pose_graph_cg(init, edges, mesh=mesh)


def _padded_graph(n, ranks_):
    """make_loop_graph(n) with its edges padded to a multiple of ``ranks_``
    by invalid ones (tests/test_parallel.py:113-136)."""
    (gt, init, edges), _ = _graph(n=n, odo_noise=0.05, seed=1)
    e = _edges_numpy(edges)
    pad = (-len(e["i"])) % ranks_
    e = {"i": np.concatenate([e["i"], np.zeros(pad, np.int32)]),
         "j": np.concatenate([e["j"], np.zeros(pad, np.int32)]),
         "z_R": np.concatenate([e["z_R"], np.tile(np.eye(3, dtype=np.float32), (pad, 1, 1))]),
         "z_t": np.concatenate([e["z_t"], np.zeros((pad, 3), np.float32)]),
         "information": np.concatenate([e["information"],
                                        np.tile(np.eye(6, dtype=np.float32), (pad, 1, 1))]),
         "valid": np.concatenate([e["valid"], np.zeros(pad, bool)])}
    return np.asarray(gt.t), (np.asarray(init.R), np.asarray(init.t)), e


def test_sharded_solves_match_one_rank():
    """Dense (optimize_pose_graph_sharded) and CG with a mesh, the edges
    over 4 gloo ranks, against the same solves on one rank: every rank
    within 1e-3 m of one rank, every rank the same bits."""
    gt_t, init, e = _padded_graph(15, 4)
    dense_p = pg.PoseGraphParams(max_iterations=8)
    cg_p = pg.PoseGraphCGParams(max_iterations=8)
    out = spawn_ranks(ranks.sequence, 4, "gloo", args=([
        (ranks.pose_graph, (init, e, "dense", dense_p)),
        (ranks.pose_graph, (init, e, "cg", cg_p)),
    ],), device="cpu")
    p0 = pose_from_numpy(*init)
    edges = pg.PoseGraphEdges(*(torch.from_numpy(np.asarray(e[k])) for k in ("i", "j")),
                              Pose(torch.from_numpy(e["z_R"]), torch.from_numpy(e["z_t"])),
                              torch.from_numpy(e["information"]), torch.from_numpy(e["valid"]))
    one = [pg.optimize_pose_graph(p0, edges, dense_p), pg.optimize_pose_graph_cg(p0, edges, cg_p)]
    init_err = np.linalg.norm(init[1] - gt_t, axis=-1).mean()
    for which, (opt, chi) in enumerate(one):
        for rank in out:
            got = rank[which]
            np.testing.assert_allclose(got["pose"][1], opt.t.numpy(), atol=1e-3)
            np.testing.assert_array_equal(got["pose"][1], out[0][which]["pose"][1])
            assert abs(got["chi2"] - float(chi)) <= 1e-4 * max(1.0, float(chi))
        assert np.linalg.norm(out[0][which]["pose"][1] - gt_t, axis=-1).mean() < 0.5 * init_err
