"""Per-point timestamp normalisation filter.

Port of ``mp2p_icp_tpu/filters/adjust_timestamps.py`` (reference:
FilterAdjustTimestamps.cpp): EarliestIsZero / MiddleIsZero / Normalize,
then a fixed ``time_offset``.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict

import torch

from mp2p_icp_tpu_torch.core.pointcloud import PointCloud
from mp2p_icp_tpu_torch.filters.base import FilterBase


class TimestampAdjustMethod(enum.Enum):
    EARLIEST_IS_ZERO = "EarliestIsZero"
    MIDDLE_IS_ZERO = "MiddleIsZero"
    NORMALIZE = "Normalize"  # to [0, 1]

    @staticmethod
    def from_string(s: str) -> "TimestampAdjustMethod":
        s = s.split("::")[-1]
        for m in TimestampAdjustMethod:
            if m.value.lower() == s.lower():
                return m
        raise ValueError(f"Unknown timestamp adjust method: {s!r}")


@dataclasses.dataclass(frozen=True)
class FilterAdjustTimestamps(FilterBase):
    pointcloud_layer: str = "raw"
    method: TimestampAdjustMethod = TimestampAdjustMethod.MIDDLE_IS_ZERO
    time_offset: float = 0.0
    silently_ignore_no_timestamps: bool = False

    def __call__(self, layers: Dict[str, PointCloud], variables=None):
        pc = layers[self.pointcloud_layer]
        if pc.time is None:
            if self.silently_ignore_no_timestamps:
                return dict(layers)
            raise ValueError(
                f"FilterAdjustTimestamps: layer '{self.pointcloud_layer}' has no timestamps")
        m = pc.valid_mask()
        lo = torch.amin(torch.where(m, pc.time, torch.inf), dim=-1, keepdim=True)
        hi = torch.amax(torch.where(m, pc.time, -torch.inf), dim=-1, keepdim=True)
        if self.method == TimestampAdjustMethod.EARLIEST_IS_ZERO:
            t = pc.time - lo
        elif self.method == TimestampAdjustMethod.MIDDLE_IS_ZERO:
            t = pc.time - 0.5 * (lo + hi)
        else:
            t = (pc.time - lo) / torch.clamp(hi - lo, min=1e-12)
        out = dict(layers)
        out[self.pointcloud_layer] = dataclasses.replace(
            pc, time=torch.where(m, t + self.time_offset, 0.0))
        return out
