"""Grid-based vertical-structure (pole) detector.

Port of ``mp2p_icp_tpu/filters/pole_detector.py`` (reference:
FilterPoleDetector.cpp:60-224): a 2-D grid of cell z statistics; a cell is
a pole when it has at least ``minimum_pole_points`` points and its mean z
exceeds the mean z of at least ``minimum_neighbors_checks_to_pass`` of its
8 neighbours by between ``minimum_relative_height`` and
``maximum_relative_height``. Member points go to ``output_layer_poles`` /
``output_layer_no_poles``.

The cells come from one stable sort of the packed 2-D cell key (int64
here, int32 in the JAX package: the keys are below 2^30 either way); each
cell's z is summed over its rows in sorted order (one value whatever the
device's order of atomics); the 8 neighbours are found by a sorted search
of the cell keys.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from mp2p_icp_tpu_torch.core.pointcloud import PointCloud
from mp2p_icp_tpu_torch.filters.base import FilterBase
from mp2p_icp_tpu_torch.filters.common import compact
from mp2p_icp_tpu_torch.ops.voxel_unique import VoxelSegments, segment_sums_in_order

_OFF = 1 << 14
_SENT = 2147483647  # the key of an invalid row (the JAX package's int32 max)


@dataclasses.dataclass(frozen=True)
class FilterPoleDetector(FilterBase):
    """Params (reference: FilterPoleDetector.h:53-67, defaults preserved)."""

    input_pointcloud_layer: str = "raw"
    output_layer_poles: Optional[str] = None
    output_layer_no_poles: Optional[str] = None
    grid_size: float = 2.0
    minimum_relative_height: float = 2.5
    maximum_relative_height: float = 25.0
    minimum_pole_points: int = 5
    minimum_neighbors_checks_to_pass: int = 3

    def __call__(self, layers: Dict[str, PointCloud], variables=None):
        if not (self.output_layer_poles or self.output_layer_no_poles):
            raise ValueError("FilterPoleDetector: need at least one output layer")
        pc = layers[self.input_pointcloud_layer]
        C, dev = pc.capacity, pc.device
        valid = pc.valid_mask()
        # clipped in float before the conversion, so padding rows stay defined
        cells = torch.clamp(torch.floor(pc.xyz[:, :2] / self.grid_size), -_OFF, _OFF - 1)
        cells = cells.to(torch.int64) + _OFF
        key = torch.where(valid, cells[:, 0] * (1 << 15) + cells[:, 1], _SENT)
        ks, order = torch.sort(key, stable=True)
        valid_s = ks != _SENT
        new = torch.ones(C, dtype=torch.bool, device=dev)
        new[1:] = ks[1:] != ks[:-1]
        segs = VoxelSegments(order=order, segment_id=torch.cumsum(new, dim=0) - 1,
                             valid=valid_s, n_voxels=torch.sum(new & valid_s, dtype=torch.int32),
                             first_in_segment=new & valid_s)
        w = valid_s.to(torch.float32)
        sums = segment_sums_in_order(torch.stack([w, pc.xyz[order, 2] * w], dim=1), segs, C)
        cnt = sums[:, 0]
        mean_z = sums[:, 1] / torch.clamp(cnt, min=1.0)
        # each cell's key; the rows past the cells hold the invalid key
        cell_key = torch.full((C,), _SENT, dtype=torch.int64, device=dev).scatter_reduce(
            0, segs.segment_id, ks, "amin")
        n_cells = segs.n_voxels

        checks = torch.zeros(C, dtype=torch.int32, device=dev)
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                if dx == 0 and dy == 0:
                    continue
                nk = cell_key + dx * (1 << 15) + dy
                pos = torch.clamp(torch.searchsorted(cell_key, nk), 0, C - 1)
                found = (cell_key[pos] == nk) & (pos < n_cells)
                nm = torch.where(found, mean_z[pos], 0.0)
                ok = (found & (mean_z > nm + self.minimum_relative_height)
                      & (mean_z < nm + self.maximum_relative_height))
                checks = checks + ok.to(torch.int32)

        is_pole_cell = ((cnt >= self.minimum_pole_points)
                        & (checks >= self.minimum_neighbors_checks_to_pass))
        pole_sorted = segs.valid & is_pole_cell[segs.segment_id]
        pole = torch.zeros(C, dtype=torch.bool, device=dev).scatter(0, segs.order, pole_sorted)

        out = dict(layers)
        if self.output_layer_poles:
            out[self.output_layer_poles] = compact(pc, pole)
        if self.output_layer_no_poles:
            out[self.output_layer_no_poles] = compact(pc, ~pole)
        return out
