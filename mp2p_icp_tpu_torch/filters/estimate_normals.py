"""Normal-estimation filter: per-point normals on a layer.

Port of ``mp2p_icp_tpu/filters/estimate_normals.py``, the pipeline form of
``ops.normals.estimate_point_normals`` (reference: the plane fits that
NearestPlaneCapable maps precompute, consumed by Matcher_Point2Plane with
``use_point_normals=True``). Its kNN is ``knn_bruteforce``: on a CUDA
tensor the K1 kernel with k = ``knn``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from mp2p_icp_tpu_torch.core.pointcloud import PointCloud
from mp2p_icp_tpu_torch.filters.base import FilterBase
from mp2p_icp_tpu_torch.ops.normals import estimate_point_normals


@dataclasses.dataclass(frozen=True)
class FilterEstimateNormals(FilterBase):
    input_pointcloud_layer: str = "decimated"
    # in place by default (the normals ride the same layer)
    output_pointcloud_layer: str = ""
    # an optional denser layer to take the neighbourhoods from
    source_pointcloud_layer: str = ""
    knn: int = 8
    max_radius: float = 2.0
    plane_eigen_threshold: float = 1e-2
    min_points_to_fit: int = 4

    def __call__(self, layers: Dict[str, PointCloud], variables=None):
        out = dict(layers)
        out[self.output_pointcloud_layer or self.input_pointcloud_layer] = estimate_point_normals(
            layers[self.input_pointcloud_layer],
            knn=self.knn,
            max_radius=self.max_radius,
            plane_eigen_threshold=self.plane_eigen_threshold,
            min_points_to_fit=self.min_points_to_fit,
            source=(layers[self.source_pointcloud_layer]
                    if self.source_pointcloud_layer else None),
        )
        return out
