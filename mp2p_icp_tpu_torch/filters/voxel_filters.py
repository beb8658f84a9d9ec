"""Filters over voxel occupancy layers: the static / dynamic split, 2-D
slices, and the voxel-map generator.

Port of ``mp2p_icp_tpu/filters/voxel_filters.py``:

- FilterRemoveByVoxelOccupancy (reference: FilterRemoveByVoxelOccupancy.cpp):
  points in voxels occupied above a threshold are static scene, the others
  dynamic;
- FilterVoxelSlice (reference: FilterVoxelSlice.cpp): a z-slice of a voxel
  map as a 2-D occupancy grid layer;
- GeneratorVoxelMap: the sm2mm voxel-map step, a point layer inserted into
  a VoxelGridLayer with free-space carving (``ops.voxel_occupancy``).

As in the JAX package, GeneratorVoxelMap inserts the input layer's points
as they are and casts its rays from the robot position of the runtime
variables (``robot_x..z``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from mp2p_icp_tpu_torch.core.metric_map import VoxelGridLayer
from mp2p_icp_tpu_torch.core.pointcloud import PointCloud
from mp2p_icp_tpu_torch.filters.base import FilterBase
from mp2p_icp_tpu_torch.filters.common import compact, variables_point
from mp2p_icp_tpu_torch.ops.voxel_occupancy import lookup_occupancy, update_voxel_map


@dataclasses.dataclass(frozen=True)
class FilterRemoveByVoxelOccupancy(FilterBase):
    """Params (reference: FilterRemoveByVoxelOccupancy.h:55-69)."""

    input_pointcloud_layer: str = "raw"
    input_voxel_layer: str = "voxelmap"
    output_layer_static_objects: Optional[str] = None
    output_layer_dynamic_objects: Optional[str] = None
    occupancy_threshold: float = 0.4

    def __call__(self, layers, variables=None):
        pc: PointCloud = layers[self.input_pointcloud_layer]
        occ = lookup_occupancy(layers[self.input_voxel_layer], pc.xyz)
        static = pc.valid_mask() & (occ > self.occupancy_threshold)
        out = dict(layers)
        if self.output_layer_static_objects:
            out[self.output_layer_static_objects] = compact(pc, static)
        if self.output_layer_dynamic_objects:
            out[self.output_layer_dynamic_objects] = compact(pc, ~static)
        return out


@dataclasses.dataclass(frozen=True)
class OccGrid2D:
    """Dense 2-D occupancy grid layer (reference: COccupancyGridMap2D)."""

    occupancy: torch.Tensor  # [H, W] in [0, 1]
    origin_xy: tuple  # world coordinates of cell (0, 0)
    resolution: float


@dataclasses.dataclass(frozen=True)
class FilterVoxelSlice(FilterBase):
    """Params (reference: FilterVoxelSlice.h)."""

    input_layer: str = "voxelmap"
    output_layer: str = "gridmap"
    slice_z_min: float = 0.0
    slice_z_max: float = 1.0
    grid_half_extent: float = 50.0  # metres each side of the origin

    def __call__(self, layers, variables=None):
        vg: VoxelGridLayer = layers[self.input_layer]
        res = vg.resolution
        n = int(round(2 * self.grid_half_extent / res))
        zc = vg.keys[:, 2].to(torch.float32) * res
        gx = vg.keys[:, 0] + n // 2
        gy = vg.keys[:, 1] + n // 2
        # voxels outside the grid are dropped, not clamped onto its border
        in_slice = (vg.valid & (gx >= 0) & (gx < n) & (gy >= 0) & (gy < n)
                    & (zc >= self.slice_z_min) & (zc < self.slice_z_max))
        flat = torch.where(in_slice, torch.clamp(gx, 0, n - 1) * n + torch.clamp(gy, 0, n - 1),
                           n * n).to(torch.int64)
        grid = torch.full((n * n + 1,), 0.5, device=vg.device).scatter_reduce(
            0, flat, torch.where(in_slice, vg.occupancy, 0.5), "amax")
        out = dict(layers)
        out[self.output_layer] = OccGrid2D(
            occupancy=grid[: n * n].reshape(n, n),
            origin_xy=(-self.grid_half_extent, -self.grid_half_extent),
            resolution=res,
        )
        return out


@dataclasses.dataclass(frozen=True)
class GeneratorVoxelMap(FilterBase):
    """A point layer accumulated into a voxel occupancy layer with
    free-space carving (the sm2mm voxel-map step)."""

    input_pointcloud_layer: str = "raw"
    output_voxel_layer: str = "voxelmap"
    resolution: float = 0.5
    capacity: int = 1 << 16
    ray_samples: int = 32
    carve_free_space: bool = True

    def __call__(self, layers, variables=None):
        pc: PointCloud = layers[self.input_pointcloud_layer]
        vg = layers.get(self.output_voxel_layer)
        if not isinstance(vg, VoxelGridLayer):
            vg = VoxelGridLayer.empty(self.capacity, self.resolution, device=pc.device)
        origin = torch.zeros(3, device=pc.device)
        if variables:
            origin = variables_point(variables, ("robot_x", "robot_y", "robot_z"),
                                     (0.0, 0.0, 0.0), pc.device)
        out = dict(layers)
        out[self.output_voxel_layer] = update_voxel_map(
            vg, pc.xyz, pc.valid_mask(), origin, ray_samples=self.ray_samples,
            carve_free_space=self.carve_free_space)
        return out
