"""Bounding-box split filter.

Port of ``mp2p_icp_tpu/filters/bounding_box.py`` (reference:
FilterBoundingBox.cpp): the points inside and outside an axis-aligned box.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from mp2p_icp_tpu_torch.core.pointcloud import PointCloud
from mp2p_icp_tpu_torch.filters.base import FilterBase
from mp2p_icp_tpu_torch.filters.common import compact


@dataclasses.dataclass(frozen=True)
class FilterBoundingBox(FilterBase):
    input_pointcloud_layer: str = "raw"
    inside_pointcloud_layer: Optional[str] = None
    outside_pointcloud_layer: Optional[str] = None
    bbox_min: Tuple[float, float, float] = (-1.0, -1.0, -1.0)
    bbox_max: Tuple[float, float, float] = (1.0, 1.0, 1.0)

    def __call__(self, layers: Dict[str, PointCloud], variables=None):
        pc = layers[self.input_pointcloud_layer]
        mn = torch.tensor(self.bbox_min, dtype=torch.float32, device=pc.device)
        mx = torch.tensor(self.bbox_max, dtype=torch.float32, device=pc.device)
        inside = torch.all((pc.xyz >= mn) & (pc.xyz <= mx), dim=-1)
        out = dict(layers)
        if self.inside_pointcloud_layer:
            out[self.inside_pointcloud_layer] = compact(pc, inside)
        if self.outside_pointcloud_layer:
            out[self.outside_pointcloud_layer] = compact(pc, ~inside)
        return out
