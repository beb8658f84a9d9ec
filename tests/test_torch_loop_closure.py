"""The port's loop closure against the JAX package's, on the CPU.

The cases of tests/test_loop_closure.py with the same numpy inputs: the
revisit proposal on an out-and-back and a straight path (equal lists), and
the end-to-end closure of an out-and-back drive with synthetic odometry
drift (16 frames of 24 rings x 256 azimuths, decimated at 0.4 m,
point-to-plane): the same candidates and accepted loops as JAX, the
endpoint drift more than halved as in JAX, and the corrected trajectory
within 1e-3 m of JAX's (the pose graph on the same loop edges; each loop
edge is an align held in the align band, 5e-3). The pose graph alone on
JAX's own loop edges matches JAX's within the SE(3) band (1e-5).
"""

import numpy as np
import pytest

import mp2p_icp_tpu_torch
from mp2p_icp_tpu import loop_closure as jlc
from mp2p_icp_tpu.core import se3 as jse3
from mp2p_icp_tpu.eval.lidar_sim import make_street_scene, render_spinning_scan, scan_to_pointcloud
from mp2p_icp_tpu.filters.decimate_voxels import FilterDecimateVoxels as JDecimate
from mp2p_icp_tpu.icp import ICP as JICP
from mp2p_icp_tpu.icp import ICPParameters as JICPParameters
from mp2p_icp_tpu.matchers.base import LayerMatch as JLayerMatch
from mp2p_icp_tpu.matchers.point2plane import MatcherPoint2Plane as JPoint2Plane
from mp2p_icp_tpu.solvers.gauss_newton import GNParams as JGNParams
from mp2p_icp_tpu.solvers.solver import SolverGaussNewton as JGaussNewton
from mp2p_icp_tpu_torch import loop_closure as lc
from mp2p_icp_tpu_torch.convert import (
    config_of,
    icp_from_config,
    pointcloud_from_jax,
    pose_from_numpy,
)
from mp2p_icp_tpu_torch.icp import ICPParameters


@pytest.fixture(autouse=True, scope="module")
def _ask_for_the_cpu():
    """The port's constructors default to the card; these tests run on the
    CPU and say so once for the whole file."""
    mp2p_icp_tpu_torch.set_default_device("cpu")
    yield
    mp2p_icp_tpu_torch.set_default_device(None)


def _line(xs):
    poses = np.tile(np.eye(4), (len(xs), 1, 1))
    poses[:, 0, 3] = xs
    return poses


@pytest.mark.parametrize("case", ["out_and_back", "straight", "out_and_back_strided"])
def test_proposal_matches_jax(case):
    if case == "straight":
        poses, kw = _line(2.0 * np.arange(20)), dict(min_frame_gap=5, max_distance=1.0)
    else:
        poses = _line(list(range(10)) + list(range(9, -1, -1)))
        kw = dict(min_frame_gap=5, max_distance=0.5)
        if case == "out_and_back_strided":
            kw.update(max_distance=2.5, stride=2, max_candidates=3)
    got = lc.propose_loop_candidates(poses, **kw)
    assert got == jlc.propose_loop_candidates(poses, **kw)
    if case == "straight":
        assert got == []
    else:
        assert got
        flat = [k for ij in got for k in ij]
        assert len(flat) == len(set(flat))  # no frame twice
        assert all(j - i >= kw["min_frame_gap"] for i, j in got)


@pytest.fixture(scope="module")
def drive():
    """tests/test_loop_closure.py::TestEndToEndClosure's drive and
    drifting odometry, with both packages' clouds and ICP."""
    rng = np.random.RandomState(5)
    scene = make_street_scene(rng, length=80.0, n_pillars=24)
    n = 16
    xs = list(np.linspace(8, 36, 8)) + list(np.linspace(36, 8, 8))
    gt = np.tile(np.eye(4), (n, 1, 1))
    dec = JDecimate(input_pointcloud_layer=("raw",), output_pointcloud_layer="dec",
                    voxel_filter_resolution=0.4, output_capacity=4096)
    jclouds = []
    for k, x in enumerate(xs):
        p = jse3.from_xyz_ypr(float(x), 0.0, 1.6, 0.0 if k < 8 else np.pi, 0.0, 0.0)
        gt[k, :3, :3], gt[k, :3, 3] = np.asarray(p.R), np.asarray(p.t)
        scan = render_spinning_scan(scene, p, np.zeros(6, np.float32), rng,
                                    n_rings=24, n_azimuth=256)
        jclouds.append(dec({"raw": scan_to_pointcloud(scan, capacity=8192)})["dec"])
    drift = jse3.from_xyz_ypr(0.06, 0.03, 0.0, 0.008, 0.0, 0.0)
    d = np.eye(4)
    d[:3, :3], d[:3, 3] = np.asarray(drift.R), np.asarray(drift.t)
    est = np.tile(np.eye(4), (n, 1, 1))
    est[0] = gt[0]
    for k in range(1, n):
        est[k] = est[k - 1] @ np.linalg.inv(gt[k - 1]) @ gt[k] @ d
    jicp = JICP(matchers=[JPoint2Plane(distance_threshold=1.5, knn=8, layer_matches=(
        JLayerMatch(global_layer="dec", local_layer="dec"),))],
        solvers=[JGaussNewton(gn_params=JGNParams(max_iterations=3))])
    icp = icp_from_config([config_of(m) for m in jicp.matchers],
                          [config_of(s) for s in jicp.solvers])
    return {"gt": gt, "est": est, "jclouds": jclouds, "jicp": jicp, "icp": icp,
            "clouds": [pointcloud_from_jax(c) for c in jclouds]}


KW = dict(min_frame_gap=6, max_distance=4.0, layer="dec", min_quality=0.3)


def test_closure_shrinks_endpoint_drift_as_jax(drive):
    est, gt = drive["est"], drive["gt"]
    jout = jlc.close_and_optimize(drive["jicp"], JICPParameters(max_iterations=25),
                                  drive["jclouds"], est, **KW)
    out = lc.close_and_optimize(drive["icp"], ICPParameters(max_iterations=25),
                                drive["clouds"], est, **KW)
    assert out["n_candidates"] == jout["n_candidates"]
    assert [(i, j) for i, j, _q in out["loops"]] == [(i, j) for i, j, _q in jout["loops"]]
    assert out["n_accepted"] == jout["n_accepted"] >= 1
    np.testing.assert_allclose([q for *_, q in out["loops"]], [q for *_, q in jout["loops"]],
                               atol=1e-3)
    before = np.linalg.norm(est[-1, :3, 3] - gt[-1, :3, 3])
    after = np.linalg.norm(out["poses"][-1, :3, 3] - gt[-1, :3, 3])
    assert before > 0.5 and after < before / 2, (before, after)
    np.testing.assert_allclose(out["poses"][:, :3, 3], jout["poses"][:, :3, 3], atol=1e-3)
    np.testing.assert_allclose(out["poses"][0], est[0], atol=1e-5)  # the anchor


def test_optimize_trajectory_matches_jax_on_the_same_loops(drive):
    """The pose graph of the closure alone: JAX's accepted loop edges fed
    to both packages' optimize_trajectory."""
    est = drive["est"]
    cands = jlc.propose_loop_candidates(est, min_frame_gap=6, max_distance=4.0)
    jloops = jlc.close_loops(drive["jicp"], JICPParameters(max_iterations=25), drive["jclouds"],
                             est, cands, layer="dec", min_quality=0.3)
    assert jloops
    loops = [(i, j, pose_from_numpy(np.asarray(z.R), np.asarray(z.t)), q)
             for i, j, z, q in jloops]
    got = lc.optimize_trajectory(est, loops)
    want = jlc.optimize_trajectory(est, jloops)
    np.testing.assert_allclose(got[:, :3, 3], want[:, :3, 3], atol=1e-5)
    np.testing.assert_allclose(got[:, :3, :3], want[:, :3, :3], atol=1e-5)
    np.testing.assert_array_equal(lc.optimize_trajectory(est, []), est)  # no loop: as it was
