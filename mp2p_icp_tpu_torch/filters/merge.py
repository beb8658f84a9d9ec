"""Layer-merge filter — the map-update step of sm2mm pipelines.

Port of ``mp2p_icp_tpu/filters/merge.py`` (reference: FilterMerge.cpp):
insert an input layer into a target layer, with an optional SE(3)
``robot_pose`` given by the robot_x..robot_roll variables. The target is a
fixed-capacity buffer; new points are written at ``count`` onward and
overflow is dropped.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from mp2p_icp_tpu_torch.core import se3
from mp2p_icp_tpu_torch.core.pointcloud import PointCloud, scatter_rows
from mp2p_icp_tpu_torch.filters.base import FilterBase

_POSE_NAMES = ("robot_x", "robot_y", "robot_z", "robot_yaw", "robot_pitch", "robot_roll")


@dataclasses.dataclass(frozen=True)
class FilterMerge(FilterBase):
    input_pointcloud_layer: str = "raw"
    target_layer: str = "map"
    target_capacity: int = 1 << 20  # used when the target doesn't exist yet
    # reference default: input_layer_in_local_coordinates = false
    # (FilterMerge.cpp:96-108): an input already in the world frame must not
    # be transformed by the robot pose; True only for vehicle-frame inputs
    use_robot_pose: bool = False

    def __call__(self, layers: Dict[str, PointCloud], variables=None):
        src = layers[self.input_pointcloud_layer]
        if self.use_robot_pose and variables:
            pose = se3.from_xyz_ypr(*(variables.get(n, 0.0) for n in _POSE_NAMES),
                                    device=src.device)
            src = src.transformed(pose)  # normals rotate with the pose

        if self.target_layer in layers:
            target = layers[self.target_layer]
        else:
            target = PointCloud(
                xyz=src.xyz.new_full(src.xyz.shape[:-2] + (self.target_capacity, 3),
                                     PointCloud.PAD_VALUE),
                count=torch.zeros_like(src.count),
            )
        C = target.capacity
        # the source's valid points go to target.count onward; invalid rows
        # and the overflow to slot C, which is cut off
        s_valid = src.valid_mask()
        rank = torch.cumsum(s_valid, dim=-1) - 1
        dest = torch.clamp(torch.where(s_valid, target.count[..., None] + rank, C), 0, C)

        # per-point channels ride the same scatter (the reference's
        # insertAnotherMap copies full point records): a channel present on
        # either side is kept, zero-filled where the other lacks it
        def merge_ch(t_ch, s_ch, width=()):
            if t_ch is None and s_ch is None:
                return None
            batch = src.xyz.shape[:-2]
            t = t_ch if t_ch is not None else src.xyz.new_zeros(batch + (C,) + width)
            s = s_ch if s_ch is not None else src.xyz.new_zeros(batch + (src.capacity,) + width)
            return scatter_rows(t, dest, s)

        out = dict(layers)
        out[self.target_layer] = PointCloud(
            xyz=scatter_rows(target.xyz, dest, src.xyz),
            count=torch.clamp(target.count + src.count, max=C),
            intensity=merge_ch(target.intensity, src.intensity),
            ring=merge_ch(target.ring, src.ring),
            time=merge_ch(target.time, src.time),
            normals=merge_ch(target.normals, src.normals, (3,)),
        )
        return out
