"""Parity of the port's OdometryMapper with the JAX package on the CPU.

The same frames (the port's street drive, ``eval.lidar_sim.
make_street_sequence``, at a small size: 8 frames of 32 rings x 512
azimuths, raw capacity 16384, FirstPoint at 0.5 m into 3072 rows, a
16384-row map cropped to 4096, 1024 normals queries; fewer rings leave the
align so weakly constrained that both packages wander by 0.1 m a frame)
and the same noisy twists go through both packages, with the configuration of the odometry benchmark
(bench.py:621-683): stored-normal point-to-plane + Gauss-Newton, motion-
model guess, voxel-hash map insert with the winners-only normals fit.

Tolerances, all stated where they are used:

- one step from the same state: pose within 5e-3 (error_log_norm),
  iterations within 1, same termination, the same voxels inserted, the map
  normals equal to 1e-3 on >= 99% of the new rows;
- free-running: the port's ATE within max(1.5 x, + 0.01 m) of the JAX
  package's, the map count within 2%, Jaccard of the voxel sets >= 0.97.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mp2p_icp_tpu.core import se3 as jse3
from mp2p_icp_tpu.core.pointcloud import PointCloud as JPointCloud
from mp2p_icp_tpu.filters.decimate_voxels import FilterDecimateVoxels as JDecimate
from mp2p_icp_tpu.filters.deskew import FilterDeskew as JDeskew
from mp2p_icp_tpu.icp import ICP as JICP
from mp2p_icp_tpu.icp import ICPParameters as JICPParameters
from mp2p_icp_tpu.matchers.base import LayerMatch as JLayerMatch
from mp2p_icp_tpu.matchers.point2plane import MatcherPoint2Plane as JPoint2Plane
from mp2p_icp_tpu.odometry import OdometryMapper as JOdometryMapper
from mp2p_icp_tpu.solvers.gauss_newton import GNParams as JGNParams
from mp2p_icp_tpu.solvers.solver import SolverGaussNewton as JGaussNewton
import mp2p_icp_tpu_torch
from mp2p_icp_tpu_torch import convert
from mp2p_icp_tpu_torch.core import se3
from mp2p_icp_tpu_torch.eval.lidar_sim import make_street_sequence, scan_to_pointcloud
from mp2p_icp_tpu_torch.eval.trajectory import ate_rmse
from mp2p_icp_tpu_torch.filters import FilterDecimateVoxels, FilterDeskew
from mp2p_icp_tpu_torch.icp import ICP, ICPParameters
from mp2p_icp_tpu_torch.matchers import LayerMatch, MatcherPoint2Plane
from mp2p_icp_tpu_torch.odometry import OdometryMapper
from mp2p_icp_tpu_torch.ops.voxel_unique import key_words, voxel_cells
from mp2p_icp_tpu_torch.solvers.gauss_newton import GNParams
from mp2p_icp_tpu_torch.solvers.solver import SolverGaussNewton


@pytest.fixture(autouse=True, scope="module")
def _ask_for_the_cpu():
    """The port's constructors default to the card; these tests run on the
    CPU and say so once for the whole file."""
    mp2p_icp_tpu_torch.set_default_device("cpu")
    yield
    mp2p_icp_tpu_torch.set_default_device(None)


N_FRAMES, RAW_CAP, DEC_CAP, MAP_CAP, CROP_CAP, QUERY_CAP = 8, 16384, 3072, 16384, 4096, 1024
# The world frame is the scene's, moved by this much along each axis. The
# scene's walls (y = +-7 m) and ground (z = 0) lie exactly on borders of the
# 0.5 m voxel grid, where the 2 cm range noise alone decides a point's
# voxel: unmoved, each plane fills both voxel layers at random and any
# 1 cm difference between two trajectories reshuffles them (Jaccard 0.95
# between the packages, against 0.985 with the planes inside their voxels).
WORLD_SHIFT = 0.13
RESOLUTION, DT = 0.5, 0.1


def _mapper(pkg, incremental=True, merge_every=1):
    """The benchmark's mapper (bench.py:621-683) at the small size, built
    from either package's classes. The sort-maintenance mode cannot carry
    stored normals (its FirstPoint map filter passes no normals channel on,
    in either package), so it matches with the kNN re-fit branch."""
    (Mapper, Icp, Params, Match, LM, Solver, GN, Deskew, Decimate) = pkg
    return Mapper(
        icp=Icp(
            matchers=[Match(distance_threshold=1.5, use_point_normals=incremental, knn=7,
                            layer_matches=(LM(global_layer="map", local_layer="decimated"),))],
            solvers=[Solver(gn_params=GN(max_iterations=3))],
        ),
        params=Params(max_iterations=30, crop_capacity=CROP_CAP, crop_extra_margin=3.0),
        filters=[
            Deskew(input_pointcloud_layer="raw", output_pointcloud_layer="deskewed"),
            Decimate(input_pointcloud_layer=("deskewed",), output_pointcloud_layer="decimated",
                     voxel_filter_resolution=RESOLUTION, output_capacity=DEC_CAP),
        ],
        incremental_map_resolution=RESOLUTION if incremental else None,
        map_filters=[] if incremental else [Decimate(
            input_pointcloud_layer=("map",), output_pointcloud_layer="map",
            voxel_filter_resolution=RESOLUTION, output_capacity=MAP_CAP)],
        normals_knn=8 if incremental else 0, normals_radius=1.5,
        normals_query_capacity=QUERY_CAP,
        local_layer="decimated", map_layer="map", map_capacity=MAP_CAP,
        merge_every=merge_every,
    )


JAX = (JOdometryMapper, JICP, JICPParameters, JPoint2Plane, JLayerMatch, JGaussNewton,
       JGNParams, JDeskew, JDecimate)
PORT = (OdometryMapper, ICP, ICPParameters, MatcherPoint2Plane, LayerMatch,
        SolverGaussNewton, GNParams, FilterDeskew, FilterDecimateVoxels)


@pytest.fixture(scope="module")
def sequence():
    gt, twists, scans = make_street_sequence(N_FRAMES, n_rings=32, n_azimuth=512)
    gt[:, :3, 3] += WORLD_SHIFT
    frames_t = [{"raw": scan_to_pointcloud(s, capacity=RAW_CAP)} for s in scans]
    frames_j = [{"raw": JPointCloud.from_numpy(
        s["xyz"][s["valid"]], capacity=RAW_CAP, intensity=s["intensity"][s["valid"]],
        ring=s["ring"][s["valid"]], time=s["time"][s["valid"]])} for s in scans]
    p0_t = convert.pose_from_numpy(gt[0, :3, :3], gt[0, :3, 3])
    p0_j = jse3.Pose(jnp.asarray(gt[0, :3, :3], jnp.float32), jnp.asarray(gt[0, :3, 3], jnp.float32))
    return gt, twists, frames_t, frames_j, p0_t, p0_j


@pytest.fixture(scope="module")
def jax_runs(sequence):
    """The JAX package's free runs, one per map mode."""
    gt, twists, _, frames_j, _, p0_j = sequence
    return {inc: _mapper(JAX, incremental=inc).run(frames_j, twists=twists, dt=DT,
                                                   initial_pose=p0_j)
            for inc in (True, False)}


def _voxel_set(xyz, count):
    """The voxel keys of a cloud's valid rows, as a set of (k1, k2)."""
    xyz = torch.from_numpy(np.array(xyz)[: int(count)])
    k1, k2 = key_words(voxel_cells(xyz, RESOLUTION), torch.ones(len(xyz), dtype=torch.bool))
    return set(zip(k1.tolist(), k2.tolist()))


def test_one_step_from_the_same_state(sequence):
    """Seed the JAX mapper from frame 0, carry its state across with
    convert.py, run frame 1 in both packages."""
    gt, twists, frames_t, frames_j, p0_t, p0_j = sequence
    jm, tm = _mapper(JAX), _mapper(PORT)
    state_j = jm.seed_map(frames_j[0], p0_j, jnp.asarray(twists[0]))
    state_t = convert.voxel_hash_map_from_jax(state_j)
    # the port's own seed gives the same voxels in the same rows
    own = tm.seed_map(frames_t[0], p0_t, twists[0])
    assert int(own.pc.count) == int(state_j.pc.count)
    np.testing.assert_array_equal(own.table_k1.numpy(), np.asarray(state_j.table_k1))
    np.testing.assert_allclose(own.pc.xyz.numpy(), np.asarray(state_j.pc.xyz), atol=1e-4)

    count0 = int(state_t.pc.count)
    tw1, tw0 = torch.from_numpy(twists[1]), torch.from_numpy(twists[0])
    new_t, res_t, _ = tm._step(state_t, frames_t[1], p0_t, se3.identity(), tw1, tw0, True, DT)
    step = jax.jit(jm._build_step_fn(DT))
    new_j, pose_j, _, q_j, _ = step(state_j, frames_j[1], p0_j, jse3.identity(),
                                    jnp.asarray(twists[1]), jnp.asarray(twists[0]),
                                    jnp.asarray(True))
    # the same align from the same state, through the JAX package's ICP
    l_j = jm.filters[1](jm.filters[0](dict(frames_j[1]), dict(zip(
        ("vx", "vy", "vz", "wx", "wy", "wz"), jnp.asarray(twists[1])))))
    guess_j = jse3.compose(p0_j, jse3.exp(jnp.float32(DT) * jnp.asarray(twists[0])))
    res_j = jm.icp.align({"decimated": l_j["decimated"]}, {"map": state_j.pc}, guess_j, jm.params)

    pose_jt = convert.pose_from_numpy(np.asarray(pose_j.R), np.asarray(pose_j.t))
    gap = float(se3.error_log_norm(pose_jt, res_t.optimal_tf))
    assert gap < 5e-3, gap  # pose within 5e-3
    assert abs(res_t.n_iterations - int(res_j.n_iterations)) <= 1  # iterations +-1
    assert int(res_t.termination_reason) == int(res_j.termination_reason)
    assert abs(float(res_t.quality) - float(q_j)) < 0.02

    # the inserted voxel set is equal; the rows may differ where the two
    # poses put a point on different sides of a voxel border
    n_t, n_j = int(new_t.pc.count), int(new_j.pc.count)
    assert n_t > count0 + 50
    new_vox_t = _voxel_set(new_t.pc.xyz.numpy()[count0:], n_t - count0)
    new_vox_j = _voxel_set(np.asarray(new_j.pc.xyz)[count0:], n_j - count0)
    jaccard = len(new_vox_t & new_vox_j) / len(new_vox_t | new_vox_j)
    assert jaccard >= 0.97, jaccard
    assert int(new_t.n_dropped) == int(new_j.n_dropped) == 0

    # normals of the new map points: compare voxel by voxel (>= 99% of the
    # voxels both inserted agree to 1e-3; a fit near the planarity
    # threshold, or a k=8 neighbourhood that differs in its last member,
    # accounts for the rest)
    def by_voxel(xyz, normals, lo, hi):
        xyz, normals = np.asarray(xyz)[lo:hi], np.asarray(normals)[lo:hi]
        k1, k2 = key_words(voxel_cells(torch.from_numpy(np.array(xyz)), RESOLUTION),
                           torch.ones(len(xyz), dtype=torch.bool))
        return {key: nrm for key, nrm in zip(zip(k1.tolist(), k2.tolist()), normals)}

    nt = by_voxel(new_t.pc.xyz.numpy(), new_t.pc.normals.numpy(), count0, n_t)
    nj = by_voxel(new_j.pc.xyz, new_j.pc.normals, count0, n_j)
    common = sorted(set(nt) & set(nj))
    close = [np.abs(nt[key] - nj[key]).max() <= 1e-3 for key in common]
    assert np.mean(close) >= 0.99, np.mean(close)
    assert any(np.abs(nt[key]).sum() > 0 for key in common)


@pytest.mark.parametrize("incremental", [True, False], ids=["hash_map", "sort_maintenance"])
def test_free_running_tracks_jax(sequence, jax_runs, incremental):
    gt, twists, frames_t, _, p0_t, _ = sequence
    rj = jax_runs[incremental]
    rt = _mapper(PORT, incremental=incremental).run(frames_t, twists=twists, dt=DT,
                                                    initial_pose=p0_t)
    ate_j, ate_t = ate_rmse(rj["poses"], gt), ate_rmse(rt["poses"], gt)
    assert ate_t < 0.1
    assert ate_t <= max(1.5 * ate_j, ate_j + 0.01), (ate_t, ate_j)  # max(1.5 x, + 0.01 m)
    n_j, n_t = int(rj["map"].count), int(rt["map"].count)
    assert abs(n_t - n_j) <= 0.02 * n_j, (n_t, n_j)  # map count within 2%
    vox_t = _voxel_set(rt["map"].xyz.numpy(), n_t)
    vox_j = _voxel_set(rj["map"].xyz, n_j)
    jaccard = len(vox_t & vox_j) / len(vox_t | vox_j)
    assert jaccard >= 0.97, jaccard
    assert rt["poses"].shape == (N_FRAMES, 4, 4)
    assert rt["qualities"].shape == (N_FRAMES - 1,) and np.isfinite(rt["qualities"]).all()
    assert np.abs(rt["qualities"] - rj["qualities"]).max() < 0.05
    assert rt["iterations"].shape == rt["frame_seconds"].shape == (N_FRAMES - 1,)
    np.testing.assert_array_equal(rt["map_counts"][-1], n_t)
    assert rt["scans_per_s"] > 0
    if incremental:
        assert int(rt["map_state"].n_dropped) == 0


class _Replay:
    """An ICP stand-in that returns given poses: the two map modes are then
    fed identical poses, and only the map maintenance differs."""

    def __init__(self, icp, poses):
        self.matchers, self._icp, self._poses, self._at = icp.matchers, icp, iter(poses), None

    def _crop_globals(self, *args):
        return self._icp._crop_globals(*args)

    def _align_core(self, params, g_layers, l_layers, guess, prior, gidx_maps=None):
        res = self._icp._align_core(dataclasses.replace(params, max_iterations=0),
                                    g_layers, l_layers, guess, prior, gidx_maps)
        return res._replace(optimal_tf=next(self._poses))


def test_map_modes_keep_the_same_voxels_on_the_same_poses(sequence):
    """The JAX package's own contract (odometry.py:27-30): the incremental
    hash map and the sort maintenance (FilterMerge + FirstPoint) keep the
    same FirstPoint winner per voxel when they are given the same poses."""
    gt, twists, frames_t, _, p0_t, _ = sequence
    poses = [convert.pose_from_numpy(g[:3, :3], g[:3, 3]) for g in gt[1:]]
    maps = {}
    for incremental in (True, False):
        mapper = _mapper(PORT, incremental=incremental)
        mapper.icp = _Replay(mapper.icp, poses)
        maps[incremental] = mapper.run(frames_t, twists=twists, dt=DT, initial_pose=p0_t)["map"]
    a, b = maps[True], maps[False]
    assert int(a.count) == int(b.count) > 4000
    rows = lambda pc: np.unique(pc.xyz.numpy()[: int(pc.count)], axis=0)  # noqa: E731
    np.testing.assert_array_equal(rows(a), rows(b))  # the same winners, not only voxels


def test_merge_every_third_frame(sequence):
    """merge_every=3: every frame aligns, frames 3 and 6 merge."""
    gt, twists, frames_t, _, p0_t, _ = sequence
    r = _mapper(PORT, merge_every=3).run(frames_t, twists=twists, dt=DT, initial_pose=p0_t)
    counts = r["map_counts"]
    grew = np.diff(np.concatenate([[counts[0]], counts])) > 0
    # counts[i] is the map after frame i+1; frame 1 and 2 leave the seed as it is
    assert counts[0] == counts[1] < counts[2] == counts[3] == counts[4] < counts[5] == counts[6]
    assert grew.sum() == 2
    assert ate_rmse(r["poses"], gt) < 0.1


def test_guess_without_dt_uses_the_previous_relative_pose(sequence):
    """Without dt the guess is pose·rel_prev; with identical inputs the
    first step's guess is the previous pose itself."""
    gt, twists, frames_t, _, p0_t, _ = sequence
    r = _mapper(PORT).run(frames_t[:3], twists=twists[:3], initial_pose=p0_t)
    assert r["poses"].shape == (3, 4, 4) and np.isfinite(r["poses"]).all()
    assert np.linalg.norm(r["poses"][1, :3, 3] - gt[1, :3, 3]) < 0.2


def test_unported_entry_points_raise(sequence):
    """Options that exclude each other raise; ``run_offline`` no longer
    does (it is held equal to ``run`` in tests/test_torch_fleet.py)."""
    gt, twists, frames_t, _, p0_t, _ = sequence
    r = _mapper(PORT).run_offline(frames_t[:2], twists=twists[:2], dt=DT, initial_pose=p0_t)
    assert r["poses"].shape == (2, 4, 4) and np.isfinite(r["poses"]).all()
    with pytest.raises(ValueError, match="map_filters"):
        OdometryMapper(icp=None, params=None, incremental_map_resolution=0.5,
                       map_filters=[FilterDecimateVoxels()])
