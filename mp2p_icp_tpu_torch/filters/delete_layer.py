"""Layer removal filter.

Port of ``mp2p_icp_tpu/filters/delete_layer.py`` (reference:
FilterDeleteLayer.cpp).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from mp2p_icp_tpu_torch.core.pointcloud import PointCloud
from mp2p_icp_tpu_torch.filters.base import FilterBase


@dataclasses.dataclass(frozen=True)
class FilterDeleteLayer(FilterBase):
    pointcloud_layer_to_remove: Tuple[str, ...] = ()
    error_on_missing_input_layer: bool = True

    def __call__(self, layers: Dict[str, PointCloud], variables=None):
        out = dict(layers)
        for name in self.pointcloud_layer_to_remove:
            if name not in out:
                if self.error_on_missing_input_layer:
                    raise KeyError(f"FilterDeleteLayer: no such layer '{name}'")
                continue
            del out[name]
        return out
