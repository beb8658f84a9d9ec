"""The system under test, built from a configuration file: the program's
objects (mp2p_icp_tpu_torch) with the settings the file states. The only
module of the benchmark, with the drivers, that imports the program."""

from __future__ import annotations

import torch

from mp2p_icp_tpu_torch.core.pointcloud import PointCloud
from mp2p_icp_tpu_torch.filters import FilterDecimateVoxels, FilterDeskew
from mp2p_icp_tpu_torch.icp import ICP, ICPParameters
from mp2p_icp_tpu_torch.matchers import LayerMatch, MatcherPoint2Plane, MatcherPointsDistanceThreshold
from mp2p_icp_tpu_torch.odometry import OdometryMapper
from mp2p_icp_tpu_torch.solvers.gauss_newton import GNParams
from mp2p_icp_tpu_torch.solvers.solver import SolverGaussNewton, SolverHorn


def odometry_mapper(cfg: dict) -> OdometryMapper:
    """bench_torch.odometry_mapper() with the configuration's capacities:
    deskew, FirstPoint decimation (sort backend), the incremental voxel-hash
    map with normals of the new points, point to plane on stored normals
    with Gauss-Newton."""
    m = cfg["mapper"]
    return OdometryMapper(
        icp=ICP(
            matchers=[MatcherPoint2Plane(
                distance_threshold=m["distance_threshold_m"], use_point_normals=True,
                layer_matches=(LayerMatch(global_layer="map", local_layer="decimated"),))],
            solvers=[SolverGaussNewton(gn_params=GNParams(max_iterations=m["gn_inner_iterations"]))],
        ),
        params=ICPParameters(max_iterations=m["max_iterations"], crop_capacity=m["crop_capacity"],
                             crop_extra_margin=m["crop_margin_m"],
                             min_abs_step_trans=m["min_abs_step_trans"],
                             min_abs_step_rot=m["min_abs_step_rot"]),
        filters=[
            FilterDeskew(input_pointcloud_layer="raw", output_pointcloud_layer="deskewed"),
            FilterDecimateVoxels(input_pointcloud_layer=("deskewed",),
                                 output_pointcloud_layer="decimated",
                                 voxel_filter_resolution=m["voxel_m"],
                                 output_capacity=m["decimated_capacity"], backend="sort"),
        ],
        incremental_map_resolution=m["voxel_m"],
        normals_knn=m["normals_knn"], normals_radius=m["normals_radius_m"],
        normals_eigen_threshold=m["normals_eigen_threshold"],
        normals_query_capacity=m["normals_query_capacity"],
        local_layer="decimated", map_layer="map", map_capacity=m["map_capacity"],
    )


def map_icp(cfg: dict):
    """(ICP, ICPParameters) of bench.py:386-402 with the configuration's
    crop: point to point within the threshold, Horn up to the iteration
    given, Gauss-Newton after it."""
    c = cfg["icp"]
    icp = ICP(
        matchers=[MatcherPointsDistanceThreshold(
            threshold=c["distance_threshold_m"],
            layer_matches=(LayerMatch(global_layer="map", local_layer="raw"),))],
        solvers=[SolverHorn(run_up_to_iteration=c["horn_up_to_iteration"]),
                 SolverGaussNewton(run_from_iteration=c["horn_up_to_iteration"] + 1,
                                   gn_params=GNParams(max_iterations=c["gn_inner_iterations"]))],
    )
    params = ICPParameters(max_iterations=c["max_iterations"], crop_capacity=c["crop_capacity"],
                           crop_extra_margin=c["crop_margin_m"],
                           min_abs_step_trans=c["min_abs_step_trans"],
                           min_abs_step_rot=c["min_abs_step_rot"])
    return icp, params


def frame_cloud(raw: dict) -> PointCloud:
    """A raw frame (scenes.compact_scan) as the program's PointCloud."""
    return PointCloud(xyz=raw["xyz"], count=torch.tensor(raw["count"], dtype=torch.int32,
                                                        device=raw["xyz"].device),
                      intensity=raw["intensity"], ring=raw["ring"], time=raw["time"])


def points_cloud(xyz: torch.Tensor) -> PointCloud:
    """Points [N, 3] as the program's PointCloud of capacity N."""
    return PointCloud(xyz=xyz.contiguous(),
                      count=torch.tensor(xyz.shape[0], dtype=torch.int32, device=xyz.device))


def pose(R: torch.Tensor, t: torch.Tensor, device):
    from mp2p_icp_tpu_torch.core.se3 import Pose

    return Pose(R.to(device, torch.float32), t.to(device, torch.float32))


def build_kernels():
    """Builds (first run in a checkout) or finds the kNN kernel libraries."""
    from mp2p_icp_tpu_torch.ops import cuda_build

    cuda_build.build()
