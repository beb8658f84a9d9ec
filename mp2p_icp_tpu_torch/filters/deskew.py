"""Motion-compensation (deskew) filter.

Port of ``mp2p_icp_tpu/filters/deskew.py`` (reference: FilterDeskew.cpp:
69-275): per-point timestamps times a constant twist, channels preserved.
A point at relative time t moves by exp(t * [vx vy vz wx wy wz]); the
correction brings every point to the reference timestamp (t = 0).

Ported: the constant-twist model, as the closed-form fixed-axis Rodrigues
rotation (the axis is the same for all points; only the angle t*|w| varies).
The precise mode (a trajectory of the local velocity buffer) raises
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from mp2p_icp_tpu_torch.core.pointcloud import PointCloud
from mp2p_icp_tpu_torch.filters.base import FilterBase

_TWIST_NAMES = ("vx", "vy", "vz", "wx", "wy", "wz")


@dataclasses.dataclass(frozen=True)
class FilterDeskew(FilterBase):
    input_pointcloud_layer: str = "raw"
    output_pointcloud_layer: str = "deskewed"
    # constant twist (vx, vy, vz, wx, wy, wz); overridden by the runtime
    # variables 'vx'...'wz' when present (the reference's Parameterizable
    # twist fields, FilterDeskew.h)
    twist: Tuple[float, float, float, float, float, float] = (0, 0, 0, 0, 0, 0)
    # skip deskew entirely (reference: silently_ignore_no_timestamps)
    silently_ignore_no_timestamps: bool = False
    # precise mode (reference: use_precise_local_velocities); its legacy
    # alias is method == "trajectory". Not ported: raises when its
    # trajectory variables are given.
    use_precise_local_velocities: bool = False
    method: str = "constant_twist"  # or "trajectory"

    def __call__(self, layers: Dict[str, PointCloud], variables=None):
        pc = layers[self.input_pointcloud_layer]
        if pc.time is None:
            if self.silently_ignore_no_timestamps:
                out = dict(layers)
                out[self.output_pointcloud_layer] = pc
                return out
            raise ValueError(
                f"FilterDeskew: layer '{self.input_pointcloud_layer}' has no "
                "per-point timestamps"
            )
        if (
            (self.use_precise_local_velocities or self.method == "trajectory")
            and variables is not None
            and "trajectory_times" in variables
        ):
            raise NotImplementedError(
                "FilterDeskew: the precise (trajectory) mode is not ported yet"
            )

        tw = list(self.twist)
        if variables:
            tw = [variables.get(n, d) for n, d in zip(_TWIST_NAMES, tw)]
        # variables arrive as tensors on the device (no host read): 0-d for
        # one cloud, [B] for a batch of clouds [B, C, 3], one twist each
        twist = torch.stack(torch.broadcast_tensors(*[
            torch.as_tensor(x, dtype=torch.float32, device=pc.device) for x in tw
        ]), dim=-1)
        v, w = twist[..., :3], twist[..., 3:]
        theta = torch.sqrt(torch.sum(w * w, dim=-1) + 1e-30)[..., None]  # [..., 1]
        n = w / theta
        small = (theta < 1e-8)[..., None]
        t = pc.time
        phi = t * theta  # [..., C]
        sin_p = torch.sin(phi)
        cos1_p = 1.0 - torch.cos(phi)
        # rotation: p + sin(phi) n x p + (1 - cos(phi)) n x (n x p)
        n_rows = n[..., None, :].expand_as(pc.xyz)
        nxp = torch.linalg.cross(n_rows, pc.xyz)
        nxnxp = torch.linalg.cross(n_rows, nxp)
        rot_p = pc.xyz + sin_p[..., None] * nxp + cos1_p[..., None] * nxnxp
        rot_p = torch.where(small, pc.xyz, rot_p)
        # translation: t v + t ((1 - cos phi) / phi) n x v
        #                  + t ((phi - sin phi) / phi) n x (n x v)
        nxv = torch.linalg.cross(n, v)
        nxnxv = torch.linalg.cross(n, nxv)
        tiny = torch.abs(phi) < 1e-8
        safe_phi = torch.where(tiny, 1.0, phi)
        c_a = torch.where(tiny, 0.5 * phi, cos1_p / safe_phi)
        c_b = torch.where(tiny, phi * phi / 6.0, (phi - sin_p) / safe_phi)
        v_rows = v[..., None, :]
        trans = t[..., None] * (v_rows + c_a[..., None] * nxv[..., None, :]
                                + c_b[..., None] * nxnxv[..., None, :])
        trans = torch.where(small, t[..., None] * v_rows, trans)
        new_xyz = torch.where(pc.valid_mask()[..., None], rot_p + trans, pc.xyz)
        out = dict(layers)
        out[self.output_pointcloud_layer] = dataclasses.replace(pc, xyz=new_xyz)
        return out
