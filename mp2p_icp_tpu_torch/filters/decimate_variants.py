"""Range-warped and target-count voxel decimation.

Port of ``mp2p_icp_tpu/filters/decimate_variants.py``:

- FilterDecimateVoxelsQuadratic (reference:
  FilterDecimateVoxelsQuadratic.cpp): the voxel size grows with the range,
  by voxelising the coordinates warped by s(r) = 1 / (1 + r / R_ref); each
  voxel keeps its first point, in its original coordinates.
- FilterDecimateAdaptive (reference: FilterDecimateAdaptive.cpp): the
  voxel size that gives about ``desired_output_point_count`` points over
  the cloud's bounding box, bounded by ``maximum_voxel_count_per_dimension``
  and rounded to 1 mm (one host read), then FirstPoint decimation.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from mp2p_icp_tpu_torch.core.pointcloud import PointCloud
from mp2p_icp_tpu_torch.filters.base import FilterBase
from mp2p_icp_tpu_torch.filters.decimate_voxels import DecimateMethod, FilterDecimateVoxels
from mp2p_icp_tpu_torch.ops.voxel_unique import segment_argmin, voxel_segments


@dataclasses.dataclass(frozen=True)
class FilterDecimateVoxelsQuadratic(FilterBase):
    input_pointcloud_layer: str = "raw"
    output_pointcloud_layer: str = "decimated"
    voxel_filter_resolution: float = 0.20
    quadratic_reference_radius: float = 20.0
    # kept for the YAML schema; as in the JAX package, each voxel keeps its
    # first point whatever the method
    decimate_method: DecimateMethod = DecimateMethod.FIRST_POINT

    def __call__(self, layers: Dict[str, PointCloud], variables=None):
        pc = layers[self.input_pointcloud_layer]
        x = pc.xyz
        r = torch.sqrt(x[:, 0] * x[:, 0] + x[:, 1] * x[:, 1] + x[:, 2] * x[:, 2])[:, None]
        s = 1.0 / (1.0 + r / self.quadratic_reference_radius)
        valid = pc.valid_mask()
        warped = torch.where(valid[:, None], x * s, x)
        segs = voxel_segments(warped, valid, self.voxel_filter_resolution)
        C = pc.capacity
        # the first row of each segment: the least original index
        src = segment_argmin(segs, segs.order.to(torch.float32), C)
        keep = torch.arange(C, device=x.device) < segs.n_voxels
        out = dict(layers)
        out[self.output_pointcloud_layer] = PointCloud(
            xyz=torch.where(keep[:, None], x[src], PointCloud.PAD_VALUE), count=segs.n_voxels)
        return out


@dataclasses.dataclass(frozen=True)
class FilterDecimateAdaptive(FilterBase):
    input_pointcloud_layer: str = "raw"
    output_pointcloud_layer: str = "decimated"
    desired_output_point_count: int = 1000
    assumed_minimum_pointcloud_bbox: float = 10.0
    maximum_voxel_count_per_dimension: int = 100

    def __call__(self, layers: Dict[str, PointCloud], variables=None):
        pc = layers[self.input_pointcloud_layer]
        m = pc.valid_mask()[:, None]
        mn = torch.amin(torch.where(m, pc.xyz, torch.inf), dim=0)
        mx = torch.amax(torch.where(m, pc.xyz, -torch.inf), dim=0)
        span = torch.clamp(mx - mn, min=self.assumed_minimum_pointcloud_bbox).cpu().numpy()
        volume = np.float32(span[0] * span[1] * span[2])
        res = np.cbrt(np.float32(volume / np.float32(max(self.desired_output_point_count, 1))))
        res = max(res, np.float32(span.max() / np.float32(self.maximum_voxel_count_per_dimension)))
        inner = FilterDecimateVoxels(
            input_pointcloud_layer=(self.input_pointcloud_layer,),
            output_pointcloud_layer=self.output_pointcloud_layer,
            voxel_filter_resolution=max(round(float(res), 3), 1e-3),
            decimate_method=DecimateMethod.FIRST_POINT,
        )
        return inner(layers, variables)
