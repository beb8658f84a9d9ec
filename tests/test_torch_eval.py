"""The port's own copies of the numpy evaluation modules equal the JAX
package's: the LiDAR simulator array for array for one seed, the trajectory
metrics value for value."""

import numpy as np
import pytest

import bench
from mp2p_icp_tpu.core import se3 as jse3
from mp2p_icp_tpu.eval import lidar_sim as jsim
from mp2p_icp_tpu.eval import trajectory as jtraj
import mp2p_icp_tpu_torch
from mp2p_icp_tpu_torch import convert
from mp2p_icp_tpu_torch.eval import lidar_sim as sim
from mp2p_icp_tpu_torch.eval import trajectory as traj


@pytest.fixture(autouse=True, scope="module")
def _ask_for_the_cpu():
    """The port's constructors default to the card; these tests run on the
    CPU and say so once for the whole file."""
    mp2p_icp_tpu_torch.set_default_device("cpu")
    yield
    mp2p_icp_tpu_torch.set_default_device(None)


def test_lidar_sim_equals_the_jax_package():
    scene_j = jsim.make_street_scene(np.random.RandomState(7), length=260.0, n_pillars=60)
    scene_t = sim.make_street_scene(np.random.RandomState(7), length=260.0, n_pillars=60)
    assert scene_j.walls == scene_t.walls and scene_j.cylinders == scene_t.cylinders
    xyz_ypr = (20.0, 0.3, 1.7, 0.04, 0.0, 0.0)
    twist = np.array([10.0, 0.5, 0.0, 0.0, 0.01, 0.2], np.float32)
    pose_j = jse3.from_xyz_ypr(*xyz_ypr)
    pose_t = convert.pose_from_numpy(np.asarray(pose_j.R), np.asarray(pose_j.t))
    scan_j = jsim.render_spinning_scan(scene_j, pose_j, twist,
                                       np.random.RandomState(8), n_rings=16, n_azimuth=128)
    scan_t = sim.render_spinning_scan(scene_t, pose_t, twist,
                                      np.random.RandomState(8), n_rings=16, n_azimuth=128)
    assert sorted(scan_j) == sorted(scan_t)
    for key in scan_j:
        np.testing.assert_array_equal(scan_t[key], scan_j[key], err_msg=key)
    assert 1000 < scan_t["valid"].sum() < 16 * 128
    tangents = np.random.RandomState(9).randn(50, 6) * np.array([1, 1, 1, 0.3, 0.3, 0.3])
    tangents[0, 3:] = 0.0
    for a, b in zip(jsim._se3_exp_batch(tangents), sim._se3_exp_batch(tangents)):
        np.testing.assert_array_equal(a, b)
    pj = jsim.scan_to_pointcloud(scan_j, capacity=2048)
    pt = sim.scan_to_pointcloud(scan_j, capacity=2048)  # the same scan into both clouds
    assert int(pj.count) == int(pt.count) == int(scan_j["valid"].sum())
    for name in ("xyz", "intensity", "ring", "time"):
        np.testing.assert_array_equal(getattr(pt, name).numpy(), np.asarray(getattr(pj, name)))


@pytest.mark.parametrize("seed", [0, 5])
def test_scene_pool_and_sweeps_equal_the_benchmark_script(seed):
    """The port's copies of bench.make_scene / bench.sample_scan: the same
    draws from the same RandomState, array for array."""
    scene_b = bench.make_scene(np.random.RandomState(seed))
    scene_t = sim.make_scene(np.random.RandomState(seed))
    assert scene_t.dtype == np.float32 and scene_t.shape == (200_000, 3)
    np.testing.assert_array_equal(scene_t, scene_b)
    np.testing.assert_array_equal(sim.make_scene(np.random.RandomState(seed), n=4000, extent=30.0),
                                  bench.make_scene(np.random.RandomState(seed), n=4000, extent=30.0))
    for n, noise in ((8192, 0.02), (777, 0.1)):
        a = sim.sample_scan(scene_t, np.random.RandomState(seed + 1), n=n, noise=noise)
        b = bench.sample_scan(scene_b, np.random.RandomState(seed + 1), n=n, noise=noise)
        assert a.dtype == np.float32 and a.shape == (n, 3)
        np.testing.assert_array_equal(a, b)


def test_street_sequence_is_the_benchmark_drive():
    gt, twists, scans = sim.make_street_sequence(4, n_rings=8, n_azimuth=64)
    assert gt.shape == (4, 4, 4) and len(twists) == len(scans) == 4
    np.testing.assert_allclose(gt[:, 0, 3], 12.0 + np.arange(4.0), atol=1e-6)  # 10 m/s at 10 Hz
    assert abs(twists[0][0] - 10.0) < 1.0 and twists[0].dtype == np.float32
    assert scans[0]["xyz"].shape == (8 * 64, 3)
    again = sim.make_street_sequence(4, n_rings=8, n_azimuth=64)
    np.testing.assert_array_equal(again[2][3]["xyz"], scans[3]["xyz"])


def test_trajectory_metrics_equal_the_jax_package(tmp_path):
    rng = np.random.RandomState(10)
    poses_j = [jse3.from_xyz_ypr(*(rng.randn(6) * [5, 5, 1, 1, 0.1, 0.1])) for _ in range(12)]
    poses_t = [convert.pose_from_numpy(np.asarray(p.R), np.asarray(p.t)) for p in poses_j]
    gt = traj.poses_from_se3(poses_t)
    np.testing.assert_array_equal(gt, jtraj.poses_from_se3(poses_j))
    est = gt.copy()
    est[:, :3, 3] += 0.05 * rng.randn(12, 3)
    assert traj.ate_rmse(est, gt) == jtraj.ate_rmse(est, gt) > 0
    assert traj.ate_rmse(est, gt, align=False) == jtraj.ate_rmse(est, gt, align=False)
    assert traj.rpe(est, gt) == jtraj.rpe(est, gt)
    for a, b in zip(traj.umeyama_align(est[:, :3, 3], gt[:, :3, 3], with_scale=True),
                    jtraj.umeyama_align(est[:, :3, 3], gt[:, :3, 3], with_scale=True)):
        np.testing.assert_array_equal(a, b)
    traj.save_kitti_poses(tmp_path / "poses.txt", est)
    np.testing.assert_allclose(traj.load_kitti_poses(tmp_path / "poses.txt"), est, atol=1e-8)
