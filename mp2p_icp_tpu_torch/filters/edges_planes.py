"""LOAM-style edge/plane feature extraction by per-voxel eigen analysis.

Port of ``mp2p_icp_tpu/filters/edges_planes.py`` (reference:
FilterEdgesPlanes.cpp:59-221). The cloud is voxelised; each voxel with at
least ``min_points_per_voxel`` points gets the eigenvalues e0 <= e1 <= e2 of
its covariance and a class:

  EDGE  when e2 < max_e2_e0 * e0 and e1 < max_e1_e0 * e0
  PLANE when e2 > min_e2_e0 * e0 and e1 > min_e1_e0 * e0 and e1 > min_e1

A plane voxel gives a plane (centroid + smallest eigenvector, flipped to
face the vehicle) to the map's plane set and its centroid to the
``plane_centroids`` layer; near-horizontal planes (|n_z| >= 0.9) stay planes
but their member points leave ``plane_points`` (reference comment
:186-190). Member points are decimated within their voxel into
``edge_points`` / ``plane_points``; every ``full_pointcloud_decimation``-th
point of every voxel goes to ``full_decim``.

One stable voxel sort (``voxel_segments``), the means and covariances as
sums of each voxel's rows in sorted order (``segment_sums_in_order``: one
value whatever the device's order of atomics, equal to the JAX package's
segment sums on the CPU), the closed-form ``eigh3x3``. The planes ride in
the reserved ``_planes`` key, which ``apply_filter_pipeline`` moves into
``MetricMap.planes``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from mp2p_icp_tpu_torch.core.metric_map import PlaneSet
from mp2p_icp_tpu_torch.core.pointcloud import PointCloud, scatter_rows
from mp2p_icp_tpu_torch.core.se3 import sum3
from mp2p_icp_tpu_torch.filters.base import FilterBase
from mp2p_icp_tpu_torch.filters.common import compact
from mp2p_icp_tpu_torch.ops.eigen import eigh3x3
from mp2p_icp_tpu_torch.ops.voxel_unique import segment_sums_in_order, voxel_segments


@dataclasses.dataclass(frozen=True)
class FilterEdgesPlanes(FilterBase):
    """Params (reference: FilterEdgesPlanes.h:60-71, defaults preserved)."""

    input_pointcloud_layer: str = "raw"
    voxel_filter_resolution: float = 0.5
    full_pointcloud_decimation: int = 20
    voxel_filter_decimation: int = 1
    voxel_filter_max_e2_e0: float = 30.0
    voxel_filter_max_e1_e0: float = 30.0
    voxel_filter_min_e2_e0: float = 100.0
    voxel_filter_min_e1_e0: float = 100.0
    voxel_filter_min_e1: float = 0.0
    min_points_per_voxel: int = 5

    def classify(self, pc: PointCloud):
        """(segments, count, mean, eigenvalues, normal, is_edge, is_plane) per
        voxel segment; the normal is the smallest eigenvector facing the
        vehicle."""
        C = pc.capacity
        segs = voxel_segments(pc.xyz, pc.valid_mask(), self.voxel_filter_resolution)
        seg = segs.segment_id
        xyz_sorted = pc.xyz[segs.order]
        w = segs.valid.to(torch.float32)
        sums = segment_sums_in_order(torch.cat([w[:, None], xyz_sorted * w[:, None]], dim=1),
                                     segs, C)
        cnt = sums[:, 0]
        n_safe = torch.clamp(cnt, min=1.0)
        mean = sums[:, 1:] / n_safe[:, None]
        centered = (xyz_sorted - mean[seg]) * w[:, None]
        outer = centered[:, :, None] * centered[:, None, :]
        cov = segment_sums_in_order(outer, segs, C) / n_safe[:, None, None]
        evals, evecs = eigh3x3(cov)
        e0, e1, e2 = evals[:, 0], evals[:, 1], evals[:, 2]
        enough = cnt >= self.min_points_per_voxel
        is_edge = (enough & (e2 < self.voxel_filter_max_e2_e0 * e0)
                   & (e1 < self.voxel_filter_max_e1_e0 * e0))
        is_plane = (enough & ~is_edge & (e2 > self.voxel_filter_min_e2_e0 * e0)
                    & (e1 > self.voxel_filter_min_e1_e0 * e0) & (e1 > self.voxel_filter_min_e1))
        n = evecs[:, :, 0]
        c_norm = torch.sqrt(sum3(mean * mean))[:, None]
        u = mean / torch.clamp(c_norm, min=1e-9)
        n = torch.where((sum3(u * n) > 0)[:, None], -n, n)
        return segs, cnt, mean, evals, n, is_edge, is_plane

    def __call__(self, layers: Dict[str, PointCloud], variables=None):
        pc = layers[self.input_pointcloud_layer]
        C, dev = pc.capacity, pc.device
        segs, _, mean, _, n, is_edge, is_plane = self.classify(pc)
        seg = segs.segment_id
        horizontal = torch.abs(n[:, 2]) >= 0.9

        # per-point masks: the voxel's class and the decimation within it
        row = torch.arange(C, device=dev)
        seg_start = torch.full((C,), C, dtype=torch.int64, device=dev).scatter_reduce(
            0, seg, row, "amin")
        pos = row - seg_start[seg]
        decim_ok = (pos % max(self.voxel_filter_decimation, 1)) == 0
        pt_edge = segs.valid & is_edge[seg] & decim_ok
        pt_plane = segs.valid & is_plane[seg] & ~horizontal[seg] & decim_ok

        def unsort(mask_sorted):  # sorted rows -> input order
            return torch.zeros(C, dtype=torch.bool, device=dev).scatter(0, segs.order,
                                                                         mask_sorted)

        out = dict(layers)
        out["edge_points"] = compact(pc, unsort(pt_edge))
        out["plane_points"] = compact(pc, unsort(pt_plane))
        if self.full_pointcloud_decimation > 0:
            full_ok = segs.valid & ((pos % self.full_pointcloud_decimation) == 0)
            out["full_decim"] = compact(pc, unsort(full_ok))

        # the plane voxels' centroids and normals to the front, in key order
        n_planes = torch.sum(is_plane, dtype=torch.int32)
        dest = torch.where(is_plane, torch.cumsum(is_plane, dim=0) - 1, C)
        cent = scatter_rows(torch.full_like(mean, PointCloud.PAD_VALUE), dest, mean)
        normal = scatter_rows(torch.zeros_like(n), dest, n)
        out["plane_centroids"] = PointCloud(xyz=cent, count=n_planes)
        out["_planes"] = PlaneSet(normal=normal, centroid=cent, count=n_planes)
        return out
