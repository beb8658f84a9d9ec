"""SpatialOdometryMapper on 2 gloo ranks of the CPU, in both map modes.

The cases of tests/test_odometry_mapping.py::TestSpatialShardedOdometry at
a small size (6 frames of the street drive at 16 rings x 256 azimuths,
maps of 2^13 rows cropped to 2^12): the sort-maintenance mapper (FirstPoint
map filters, point-to-plane refit) and the incremental one (voxel hash map,
stored normals, the normals fit of the new voxels). Each runs once over 2
ranks (one spawn for both) and once unsharded. Bands, the JAX test's:
every shard owns only its voxels and no voxel is on two shards (exact);
ATE < 0.25 m; every frame within 0.05 m of the unsharded run (the
normals' candidate pools differ per shard); the union's voxel set has
Jaccard > 0.9 against the unsharded map; nothing dropped. The ownership
hash equals the JAX package's int32 one; ``reference_pipeline_map`` equals
the fused merge as in tests/test_odometry_mapping.py.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
import mp2p_icp_tpu_torch
from mp2p_icp_tpu_torch.convert import pointcloud_to_numpy
from mp2p_icp_tpu_torch.eval.lidar_sim import make_street_sequence
from mp2p_icp_tpu_torch.eval.trajectory import ate_rmse
from mp2p_icp_tpu_torch.filters import FilterDecimateVoxels, FilterDeskew
from mp2p_icp_tpu_torch.icp import ICP, ICPParameters
from mp2p_icp_tpu_torch.matchers import LayerMatch, MatcherPoint2Plane
from mp2p_icp_tpu_torch.odometry import OdometryMapper, reference_pipeline_map, voxel_owner
from mp2p_icp_tpu_torch.parallel import ranks
from mp2p_icp_tpu_torch.parallel.launch import spawn_ranks
from mp2p_icp_tpu_torch.solvers.gauss_newton import GNParams
from mp2p_icp_tpu_torch.solvers.solver import SolverGaussNewton

FRAMES, DT, RES, SHARDS = 6, 0.1, 0.5, 2
MAP_CAP = 1 << 13


@pytest.fixture(autouse=True, scope="module")
def _ask_for_the_cpu():
    """The port's constructors default to the card; these tests run on the
    CPU and say so once for the whole file."""
    mp2p_icp_tpu_torch.set_default_device("cpu")
    yield
    mp2p_icp_tpu_torch.set_default_device(None)


def make_mapper(incremental: bool) -> OdometryMapper:
    """tests/test_odometry_mapping.py's mappers, cut to size."""
    icp = ICP(matchers=[MatcherPoint2Plane(
        distance_threshold=1.5, knn=8, use_point_normals=incremental,
        layer_matches=(LayerMatch(global_layer="map", local_layer="decimated"),))],
        solvers=[SolverGaussNewton(gn_params=GNParams(max_iterations=3))])
    common = dict(
        icp=icp, params=ICPParameters(max_iterations=30, crop_capacity=1 << 12,
                                      crop_extra_margin=3.0),
        filters=[FilterDeskew(input_pointcloud_layer="raw", output_pointcloud_layer="deskewed"),
                 FilterDecimateVoxels(input_pointcloud_layer=("deskewed",),
                                      output_pointcloud_layer="decimated",
                                      voxel_filter_resolution=RES, output_capacity=2048)],
        local_layer="decimated", map_layer="map", map_capacity=MAP_CAP)
    if incremental:
        return OdometryMapper(incremental_map_resolution=RES, normals_knn=8, normals_radius=1.5,
                              normals_query_capacity=1024, **common)
    return OdometryMapper(map_filters=[FilterDecimateVoxels(
        input_pointcloud_layer=("map",), output_pointcloud_layer="map",
        voxel_filter_resolution=RES, output_capacity=MAP_CAP)], **common)


MODES = {"sort": False, "incremental": True}


@pytest.fixture(scope="module")
def drive(_ask_for_the_cpu):
    gt, twists, scans = make_street_sequence(FRAMES, n_rings=16, n_azimuth=256)
    frames = cs.odometry_frames(scans)
    return gt, twists, frames


@pytest.fixture(scope="module")
def runs(drive):
    """{mode: (the 2 ranks' results, the unsharded run)}."""
    gt, twists, frames = drive
    fnp = [{k: pointcloud_to_numpy(v) for k, v in f.items()} for f in frames]
    pose0 = (gt[0, :3, :3], gt[0, :3, 3])
    tasks = [(ranks.spatial_mapper, (make_mapper(inc), fnp, twists, pose0, DT, RES))
             for inc in MODES.values()]
    out = spawn_ranks(ranks.sequence, SHARDS, "gloo", args=(tasks,), device="cpu")
    return {mode: ([r[m] for r in out],
                   make_mapper(inc).run(frames, twists=twists, dt=DT,
                                        initial_pose=cs.pose_of(gt[0])))
            for m, (mode, inc) in enumerate(MODES.items())}


def _cells(xyz):
    return {tuple(c) for c in np.floor(xyz / RES).astype(np.int64)}


@pytest.mark.parametrize("mode", list(MODES))
def test_shards_partition_the_voxels(runs, mode):
    sharded, _ = runs[mode]
    m = sharded[0]["map"]
    assert m["xyz"].shape[:2] == (SHARDS, MAP_CAP // SHARDS)
    sets = []
    for s in range(SHARDS):
        xyz = m["xyz"][s][:m["count"][s]]
        assert len(xyz) > 0
        owner = voxel_owner(torch.from_numpy(xyz), RES, SHARDS).numpy()
        assert (owner == s).all(), f"shard {s} holds a foreign voxel"
        sets.append(_cells(xyz))
    assert not (sets[0] & sets[1])
    assert all(r["dropped"] == 0 for r in sharded)


@pytest.mark.parametrize("mode", list(MODES))
def test_spatial_mapper_tracks_like_the_unsharded_run(drive, runs, mode):
    gt = drive[0]
    sharded, seq = runs[mode]
    poses = sharded[0]["poses"]
    np.testing.assert_array_equal(poses, sharded[1]["poses"])  # every rank the same poses
    assert ate_rmse(poses, gt) < 0.25
    assert np.linalg.norm(poses[:, :3, 3] - seq["poses"][:, :3, 3], axis=1).max() < 0.05
    n = int(seq["map"].count)
    want = _cells(seq["map"].xyz[:n].numpy())
    m = sharded[0]["map"]
    union = set().union(*(_cells(m["xyz"][s][:m["count"][s]]) for s in range(SHARDS)))
    assert len(want & union) / len(want | union) > 0.9


def test_voxel_owner_is_the_jax_hash():
    """The JAX package's step hashes int32 cells with wrapping products
    (odometry.py:823-827); the port's int64 hash, masked to 31 bits, gives
    the same owner."""
    rng = np.random.RandomState(3)
    xyz = np.concatenate([rng.uniform(-3000, 3000, (5000, 3)),
                          rng.uniform(-5, 5, (5000, 3))]).astype(np.float32)
    cell = np.floor(xyz * np.float32(1.0 / RES)).astype(np.int32)
    with np.errstate(over="ignore"):
        h = (cell[:, 0] * np.int32(73856093) ^ cell[:, 1] * np.int32(19349663)
             ^ cell[:, 2] * np.int32(83492791)) & np.int32(0x7FFFFFFF)
    for n in (2, 3, 4, 8):
        np.testing.assert_array_equal(voxel_owner(torch.from_numpy(xyz), RES, n).numpy(), h % n)


def test_reference_pipeline_map_equals_the_fused_merge(drive):
    gt, twists, frames = drive
    mapper = make_mapper(False)
    out = mapper.run(frames[:3], twists=twists[:3], dt=DT, initial_pose=cs.pose_of(gt[0]))
    ref = reference_pipeline_map(mapper, frames[:3], out["poses"], twists=twists[:3])
    n = int(out["map"].count)
    assert int(ref.count) == n > 0
    np.testing.assert_allclose(out["map"].xyz[:n].numpy(), ref.xyz[:n].numpy(), atol=5e-3)
    np.testing.assert_allclose(out["map"].intensity[:n].numpy(), ref.intensity[:n].numpy(),
                               atol=1e-6)
