"""Intensity-band split and intensity normalisation filters.

Port of ``mp2p_icp_tpu/filters/by_intensity.py`` (reference:
FilterByIntensity.cpp, the low / mid / high split, and
FilterNormalizeIntensity.cpp, intensities mapped to [0, 1] by the minimum
and maximum of the call).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from mp2p_icp_tpu_torch.core.pointcloud import PointCloud
from mp2p_icp_tpu_torch.filters.base import FilterBase
from mp2p_icp_tpu_torch.filters.common import compact


@dataclasses.dataclass(frozen=True)
class FilterByIntensity(FilterBase):
    input_pointcloud_layer: str = "raw"
    output_layer_low_intensity: Optional[str] = None
    output_layer_mid_intensity: Optional[str] = None
    output_layer_high_intensity: Optional[str] = None
    low_threshold: float = 0.10
    high_threshold: float = 0.90

    def __call__(self, layers: Dict[str, PointCloud], variables=None):
        pc = layers[self.input_pointcloud_layer]
        if pc.intensity is None:
            raise ValueError(f"FilterByIntensity: layer '{self.input_pointcloud_layer}' "
                             "has no intensity channel")
        i = pc.intensity
        out = dict(layers)
        if self.output_layer_low_intensity:
            out[self.output_layer_low_intensity] = compact(pc, i < self.low_threshold)
        if self.output_layer_mid_intensity:
            out[self.output_layer_mid_intensity] = compact(
                pc, (i >= self.low_threshold) & (i <= self.high_threshold))
        if self.output_layer_high_intensity:
            out[self.output_layer_high_intensity] = compact(pc, i > self.high_threshold)
        return out


@dataclasses.dataclass(frozen=True)
class FilterNormalizeIntensity(FilterBase):
    pointcloud_layer: str = "raw"

    def __call__(self, layers: Dict[str, PointCloud], variables=None):
        pc = layers[self.pointcloud_layer]
        if pc.intensity is None:
            raise ValueError(f"FilterNormalizeIntensity: layer '{self.pointcloud_layer}' "
                             "has no intensity channel")
        m = pc.valid_mask()
        lo = torch.amin(torch.where(m, pc.intensity, torch.inf), dim=-1, keepdim=True)
        hi = torch.amax(torch.where(m, pc.intensity, -torch.inf), dim=-1, keepdim=True)
        span = torch.clamp(hi - lo, min=1e-12)
        out = dict(layers)
        out[self.pointcloud_layer] = dataclasses.replace(
            pc, intensity=torch.where(m, (pc.intensity - lo) / span, 0.0))
        return out
