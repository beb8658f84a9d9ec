"""Range gate filter.

Port of ``mp2p_icp_tpu/filters/by_range.py`` (reference:
FilterByRange.cpp): keep or split the points by their range from a centre,
the robot position when the runtime variables give one.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from mp2p_icp_tpu_torch.core.pointcloud import PointCloud
from mp2p_icp_tpu_torch.filters.base import FilterBase
from mp2p_icp_tpu_torch.filters.common import compact, variables_point


@dataclasses.dataclass(frozen=True)
class FilterByRange(FilterBase):
    input_pointcloud_layer: str = "raw"
    output_layer_between: Optional[str] = None  # range in [min, max]
    output_layer_outside: Optional[str] = None  # range outside [min, max]
    range_min: float = 0.0
    range_max: float = 100.0
    center: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    def __call__(self, layers: Dict[str, PointCloud], variables=None):
        pc = layers[self.input_pointcloud_layer]
        center = torch.tensor(self.center, dtype=torch.float32, device=pc.device)
        if variables:
            center = variables_point(variables, ("robot_x", "robot_y", "robot_z"),
                                     self.center, pc.device)
        d = pc.xyz - center
        r = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2])
        between = (r >= self.range_min) & (r <= self.range_max)
        out = dict(layers)
        if self.output_layer_between:
            out[self.output_layer_between] = compact(pc, between)
        if self.output_layer_outside:
            out[self.output_layer_outside] = compact(pc, ~between)
        return out
