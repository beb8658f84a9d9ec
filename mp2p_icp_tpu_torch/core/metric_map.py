"""Layered metric map container.

Port of ``mp2p_icp_tpu/core/metric_map.py`` (reference:
mp2p_icp_map/include/mp2p_icp/metricmap.h:64-258): ``layers`` maps layer
names to ``PointCloud`` or ``VoxelGridLayer`` layers; ``lines`` / ``planes``
are fixed-capacity masked sets; id, label and georeferencing are host-side
metadata. The three tensor containers are pytree nodes, so
``torch.func.vmap`` maps over them; their constructors take ``device=None``
as ``default_device()``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import numpy as np
import torch
import torch.utils._pytree as pytree

from mp2p_icp_tpu_torch.core.pointcloud import PointCloud, round_capacity
from mp2p_icp_tpu_torch.device import resolve

# Conventional layer names (reference: Generator inserts into "raw";
# decimation filters emit "decimated" — Generator.h:120, demo YAMLs).
LAYER_RAW = "raw"
LAYER_DECIMATED = "decimated"


@dataclasses.dataclass(frozen=True)
class LineSet:
    """Fixed-capacity 3D line set: point + unit direction per line
    (reference: metric_map_t::lines)."""

    point: torch.Tensor  # [L, 3]
    direction: torch.Tensor  # [L, 3]
    count: torch.Tensor  # scalar i32

    def valid_mask(self) -> torch.Tensor:
        return torch.arange(self.point.shape[0], device=self.point.device) < self.count

    @staticmethod
    def empty(capacity: int = 8, device=None) -> "LineSet":
        device = resolve(device)
        return LineSet(
            point=torch.zeros(capacity, 3, device=device),
            direction=torch.zeros(capacity, 3, device=device),
            count=torch.zeros((), dtype=torch.int32, device=device),
        )


@dataclasses.dataclass(frozen=True)
class PlaneSet:
    """Fixed-capacity plane patches: unit normal + centroid (reference:
    plane_patch_t, mp2p_icp_map/include/mp2p_icp/plane_patch.h:30-39)."""

    normal: torch.Tensor  # [P, 3]
    centroid: torch.Tensor  # [P, 3]
    count: torch.Tensor  # scalar i32

    def valid_mask(self) -> torch.Tensor:
        return torch.arange(self.normal.shape[0], device=self.normal.device) < self.count

    @staticmethod
    def empty(capacity: int = 8, device=None) -> "PlaneSet":
        device = resolve(device)
        return PlaneSet(
            normal=torch.zeros(capacity, 3, device=device),
            centroid=torch.zeros(capacity, 3, device=device),
            count=torch.zeros((), dtype=torch.int32, device=device),
        )


@dataclasses.dataclass
class Georeferencing:
    """WGS-84 anchor + ENU->map transform (reference: metricmap.h:134-150).
    Host-side metadata only."""

    latitude: float = 0.0
    longitude: float = 0.0
    height: float = 0.0
    t_enu_to_map_xyz: tuple = (0.0, 0.0, 0.0)
    t_enu_to_map_quat_wxyz: tuple = (1.0, 0.0, 0.0, 0.0)
    # 6x6 SE(3) covariance of T_enu_to_map as a nested 6-tuple; None = exact
    t_enu_to_map_cov: Optional[tuple] = None


@dataclasses.dataclass(frozen=True)
class VoxelGridLayer:
    """Sparse voxel occupancy layer (reference analogue: Bonxai CVoxelMap).

      keys:      [C, 3] int32 integer voxel coordinates
      occupancy: [C]    float32 in [0, 1] (0.5 = unknown prior)
      valid:     [C]    bool
      resolution: metres per voxel (static: not a pytree leaf)
    """

    keys: torch.Tensor
    occupancy: torch.Tensor
    valid: torch.Tensor
    resolution: float = 0.1

    @property
    def device(self) -> torch.device:
        return self.keys.device

    @staticmethod
    def empty(capacity: int, resolution: float, device=None) -> "VoxelGridLayer":
        device = resolve(device)
        return VoxelGridLayer(
            keys=torch.zeros(capacity, 3, dtype=torch.int32, device=device),
            occupancy=torch.full((capacity,), 0.5, device=device),
            valid=torch.zeros(capacity, dtype=torch.bool, device=device),
            resolution=resolution,
        )

    def centers(self) -> torch.Tensor:
        return (self.keys.to(torch.float32) + 0.5) * self.resolution


Layer = Union[PointCloud, VoxelGridLayer]


@dataclasses.dataclass
class MetricMap:
    """The layered map: a mutable host container of layers (reference:
    metricmap.h:64-258: layers, lines, planes, id/label, georeferencing,
    empty(), contents_summary(), merge_with())."""

    layers: Dict[str, Layer] = dataclasses.field(default_factory=dict)
    lines: Optional[LineSet] = None
    planes: Optional[PlaneSet] = None
    id: Optional[int] = None
    label: Optional[str] = None
    georeferencing: Optional[Georeferencing] = None

    def __post_init__(self):
        # the empty sets go where the layers are (the default device for a
        # map without layers)
        device = next((layer.device for layer in self.layers.values()), None)
        if self.lines is None:
            self.lines = LineSet.empty(device=device)
        if self.planes is None:
            self.planes = PlaneSet.empty(device=device)

    def empty(self) -> bool:
        if self.layers:
            return False
        return int(self.lines.count) == 0 and int(self.planes.count) == 0

    def point_layer(self, name: str) -> PointCloud:
        layer = self.layers[name]
        if not isinstance(layer, PointCloud):
            raise TypeError(f"layer '{name}' is not a point layer")
        return layer

    def size(self) -> int:
        return sum(int(layer.count) if isinstance(layer, PointCloud)
                   else int(torch.sum(layer.valid)) for layer in self.layers.values())

    def contents_summary(self) -> str:
        """Human-readable summary (reference: metricmap.cpp contents_summary)."""
        if not self.layers and self.empty():
            return "empty"
        parts = []
        if self.id is not None:
            parts.append(f"id={self.id}")
        if self.label is not None:
            parts.append(f"label='{self.label}'")
        for name, layer in self.layers.items():
            if isinstance(layer, PointCloud):
                parts.append(f"layer '{name}': {int(layer.count)} points "
                             f"(capacity {layer.capacity})")
            else:
                parts.append(f"layer '{name}': voxelgrid res={layer.resolution} "
                             f"({int(torch.sum(layer.valid))} occupied)")
        if int(self.lines.count):
            parts.append(f"{int(self.lines.count)} lines")
        if int(self.planes.count):
            parts.append(f"{int(self.planes.count)} planes")
        if self.georeferencing is not None:
            parts.append("georeferenced")
        return "; ".join(parts)

    def copy(self) -> "MetricMap":
        return dataclasses.replace(self, layers=dict(self.layers))

    def merge_with(self, other: "MetricMap", pose=None) -> None:
        """Merge other's layers into self, optionally transforming by pose
        (reference: metricmap.cpp:442-532 merge_with). Point channels
        present on either side survive, zero-filled where absent."""
        for name, layer in other.layers.items():
            if not isinstance(layer, PointCloud):
                if pose is not None:
                    raise NotImplementedError(
                        f"merge_with: transforming non-point layer '{name}' by a "
                        "pose is not supported: inserting it untransformed would "
                        "silently misplace the data"
                    )
                self.layers.setdefault(name, layer)
                continue
            src = layer.transformed(pose) if pose is not None else layer
            if name not in self.layers:
                self.layers[name] = src
                continue
            dst = self.point_layer(name)
            n_dst, n_src = int(dst.count), int(src.count)
            cap = round_capacity(n_dst + n_src)
            merged = np.full((cap, 3), PointCloud.PAD_VALUE, np.float32)
            merged[:n_dst] = dst.xyz[:n_dst].cpu().numpy()
            merged[n_dst:n_dst + n_src] = src.xyz[:n_src].cpu().numpy()

            def merge_ch(a, b):
                if a is None and b is None:
                    return None
                m = np.zeros((cap,), np.float32)
                if a is not None:
                    m[:n_dst] = a[:n_dst].cpu().numpy()
                if b is not None:
                    m[n_dst:n_dst + n_src] = b[:n_src].cpu().numpy()
                return torch.from_numpy(m).to(dst.device)

            self.layers[name] = PointCloud(
                xyz=torch.from_numpy(merged).to(dst.device),
                count=torch.tensor(n_dst + n_src, dtype=torch.int32, device=dst.device),
                intensity=merge_ch(dst.intensity, src.intensity),
                ring=merge_ch(dst.ring, src.ring),
                time=merge_ch(dst.time, src.time),
            )


for _cls in (LineSet, PlaneSet):
    pytree.register_dataclass(
        _cls, serialized_type_name=f"mp2p_icp_tpu_torch.{_cls.__name__}")
pytree.register_pytree_node(
    VoxelGridLayer,
    lambda v: ([v.keys, v.occupancy, v.valid], v.resolution),
    lambda leaves, res: VoxelGridLayer(*leaves, resolution=res),
    serialized_type_name="mp2p_icp_tpu_torch.VoxelGridLayer",
)
