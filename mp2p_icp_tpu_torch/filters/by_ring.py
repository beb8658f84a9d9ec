"""LiDAR ring selection filter.

Port of ``mp2p_icp_tpu/filters/by_ring.py`` (reference: FilterByRing.cpp):
the points of the selected ring ids and the others.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from mp2p_icp_tpu_torch.core.pointcloud import PointCloud
from mp2p_icp_tpu_torch.filters.base import FilterBase
from mp2p_icp_tpu_torch.filters.common import compact


@dataclasses.dataclass(frozen=True)
class FilterByRing(FilterBase):
    input_pointcloud_layer: str = "raw"
    output_layer_selected: Optional[str] = None
    output_layer_non_selected: Optional[str] = None
    selected_ring_ids: Tuple[int, ...] = ()

    def __call__(self, layers: Dict[str, PointCloud], variables=None):
        pc = layers[self.input_pointcloud_layer]
        if pc.ring is None:
            raise ValueError(
                f"FilterByRing: layer '{self.input_pointcloud_layer}' has no ring channel")
        ring = pc.ring.to(torch.int32)
        ids = torch.tensor(self.selected_ring_ids, dtype=torch.int32, device=pc.device)
        sel = torch.isin(ring, ids)
        out = dict(layers)
        if self.output_layer_selected:
            out[self.output_layer_selected] = compact(pc, sel)
        if self.output_layer_non_selected:
            out[self.output_layer_non_selected] = compact(pc, ~sel)
        return out
