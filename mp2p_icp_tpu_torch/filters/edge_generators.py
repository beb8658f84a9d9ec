"""Edge-extraction generators for scan-ordered range data.

Port of ``mp2p_icp_tpu/filters/edge_generators.py``:

- GeneratorEdgesFromCurvature (reference:
  GeneratorEdgesFromCurvature.cpp:150-181): within a scan row, a point is
  an edge when the segments to its neighbours meet at
  |v1.v2| < max_cosine * |v1||v2| (segments shorter than
  ``min_point_clearance`` are skipped);
- GeneratorEdgesFromRangeImage (reference:
  GeneratorEdgesFromRangeImage.cpp:39-143): per range-image row, the range
  of each pixel scored against the statistics of the range differences in
  its window; a score above ``score_threshold`` marks an edge.

Rows are runs of equal ring ids in buffer order (raw LiDAR packets are in
scan order); the neighbour expressions are shifted rows with boundary
masks.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from mp2p_icp_tpu_torch.core.pointcloud import PointCloud
from mp2p_icp_tpu_torch.core.se3 import sum3
from mp2p_icp_tpu_torch.filters.base import FilterBase
from mp2p_icp_tpu_torch.filters.common import compact


@dataclasses.dataclass(frozen=True)
class GeneratorEdgesFromCurvature(FilterBase):
    """Params (reference: GeneratorEdgesFromCurvature.h:50-51)."""

    input_pointcloud_layer: str = "raw"
    target_layer: str = "edges"
    max_cosine: float = 0.5
    min_point_clearance: float = 0.10

    def __call__(self, layers: Dict[str, PointCloud], variables=None):
        pc = layers[self.input_pointcloud_layer]
        if pc.ring is None:
            raise ValueError("GeneratorEdgesFromCurvature needs a 'ring' channel")
        C, dev = pc.capacity, pc.device
        valid = pc.valid_mask()
        ring = pc.ring.to(torch.int64)
        link = (ring[1:] == ring[:-1]) & valid[1:] & valid[:-1]  # row i+1 follows row i
        no = torch.zeros(1, dtype=torch.bool, device=dev)
        same_prev = torch.cat([no, link])
        same_next = torch.cat([link, no])
        idx = torch.arange(C, device=dev)
        prev = torch.clamp(idx - 1, 0, C - 1)
        nxt = torch.clamp(idx + 1, 0, C - 1)
        v1 = pc.xyz - pc.xyz[prev]
        v2 = pc.xyz[nxt] - pc.xyz
        v1n = torch.sqrt(sum3(v1 * v1))
        v2n = torch.sqrt(sum3(v2 * v2))
        clearance_ok = (v1n >= self.min_point_clearance) & (v2n >= self.min_point_clearance)
        sharp = torch.abs(sum3(v1 * v2)) < self.max_cosine * v1n * v2n
        is_edge = valid & same_prev & same_next & clearance_ok & sharp
        out = dict(layers)
        out[self.target_layer] = compact(pc, is_edge)
        return out


@dataclasses.dataclass(frozen=True)
class GeneratorEdgesFromRangeImage(FilterBase):
    """Params (reference: GeneratorEdgesFromRangeImage.h:54)."""

    input_pointcloud_layer: str = "raw"
    target_layer: str = "edges"
    score_threshold: int = 10
    window: int = 8  # half-window W (reference: BLOCK_BITS = 3 -> W = 8)
    # metres per integer range unit: the reference scores the sensor's
    # integer range image; 1 cm is a typical LiDAR range quantisation
    range_resolution: float = 0.01

    def __call__(self, layers: Dict[str, PointCloud], variables=None):
        """The reference's scoring (GeneratorEdgesFromRangeImage.cpp:83-143,
        calcStats :39-60), as the JAX package writes it: per row, over the
        2W+1 integer range differences around i, mean = sum / (N-1) and
        var = sum of squared deviations / (N-1) (the reference's divisors);
        then score = (range_i - mean)^2 / var / 65536, an edge when
        score > score_threshold and var > 0. The reference compares the
        range itself against the window's difference statistics
        (:127-130), and an integer-flat window (var == 0) never fires; both
        kept. The full window must lie inside the row."""
        pc = layers[self.input_pointcloud_layer]
        if pc.ring is None:
            raise ValueError("GeneratorEdgesFromRangeImage needs a 'ring' channel")
        C, dev = pc.capacity, pc.device
        W = self.window
        n = 2 * W + 1
        valid = pc.valid_mask()
        ring = pc.ring.to(torch.int64)
        idx = torch.arange(C, device=dev)
        r_u = torch.round(torch.sqrt(sum3(pc.xyz * pc.xyz)) / self.range_resolution)
        prev = torch.clamp(idx - 1, 0, C - 1)
        d = r_u - r_u[prev]  # the difference at i (against the previous column)
        d_ok = (ring[prev] == ring) & valid[prev] & valid

        js = [torch.clamp(idx + s, 0, C - 1) for s in range(-W, W + 1)]
        sum_d = torch.zeros(C, device=dev)
        full = torch.ones(C, dtype=torch.bool, device=dev)
        for j in js:
            full = full & d_ok[j] & (ring[j] == ring)
            sum_d = sum_d + d[j]
        mean = sum_d / (n - 1)
        # two passes: an all-equal integer window gives var ~ 0, while the
        # smallest real integer variance is 1 / (n - 1)
        var = torch.zeros(C, device=dev)
        for j in js:
            var = var + (d[j] - mean) ** 2
        var = var / (n - 1)
        has_var = var > 0.03
        score = torch.where(has_var, (r_u - mean) ** 2 / torch.clamp(var, min=1e-9) / 65536.0,
                            0.0)
        is_edge = valid & full & has_var & (score > self.score_threshold)
        out = dict(layers)
        out[self.target_layer] = compact(pc, is_edge)
        return out
