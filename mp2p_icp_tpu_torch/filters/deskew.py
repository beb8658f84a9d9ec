"""Motion-compensation (deskew) filter.

Port of ``mp2p_icp_tpu/filters/deskew.py`` (reference: FilterDeskew.cpp:
69-275): per-point timestamps times a constant twist, channels preserved.
A point at relative time t moves by exp(t * [vx vy vz wx wy wz]); the
correction brings every point to the reference timestamp (t = 0).

The constant-twist model is the closed-form fixed-axis Rodrigues rotation
(the axis is the same for all points; only the angle t*|w| varies). The
precise mode (reference: use_precise_local_velocities,
FilterDeskew.cpp:162-240) takes the rotation from the trajectory that the
local velocity buffer reconstructs, interpolated at each point's time, and
the translation from the constant velocity, v*t, as the JAX package does
(its comment states the deviation from the reference). The trajectory
arrives in the variables ``trajectory_times`` [T] (seconds relative to
the scan's reference time) and ``trajectory_tangents`` [T, 6] (pose(t) =
exp(tangent)); it goes to the layer's device once per call. Without it
the precise mode falls back to the constant twist (reference:
FilterDeskew.cpp:178-184).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from mp2p_icp_tpu_torch.core import se3
from mp2p_icp_tpu_torch.core.pointcloud import PointCloud
from mp2p_icp_tpu_torch.filters.base import FilterBase
from mp2p_icp_tpu_torch.utils.profiler import spanned

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
    # alias is method == "trajectory"
    use_precise_local_velocities: bool = False
    method: str = "constant_twist"  # or "trajectory"

    @spanned("filters.deskew")
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
        use_traj = ((self.use_precise_local_velocities or self.method == "trajectory")
                    and variables is not None and "trajectory_times" in variables)
        tw = list(self.twist)
        if variables:
            tw = [variables.get(n, d) for n, d in zip(_TWIST_NAMES, tw)]
        # variables arrive as tensors on the device (no host read): 0-d for
        # one cloud, [B] for a batch of clouds [B, C, 3], one twist each
        twist = torch.stack(torch.broadcast_tensors(*[
            torch.as_tensor(x, dtype=torch.float32, device=pc.device) for x in tw
        ]), dim=-1)
        if use_traj:
            new_xyz = self._along_trajectory(pc, twist, variables)
            out = dict(layers)
            out[self.output_pointcloud_layer] = dataclasses.replace(pc, xyz=new_xyz)
            return out
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

    @staticmethod
    def _along_trajectory(pc: PointCloud, twist: torch.Tensor, variables) -> torch.Tensor:
        """The precise mode: the tangents interpolated linearly at each
        point's time, their rotation, and v*t. A batch of clouds [B, C, 3]
        (with a twist each, or one for all) shares the trajectory; every
        step is elementwise, so each cloud comes out as its own call gives
        it, to the bit."""
        times = torch.as_tensor(variables["trajectory_times"], dtype=torch.float32,
                                device=pc.device)
        tang = torch.as_tensor(variables["trajectory_tangents"], dtype=torch.float32,
                               device=pc.device)
        T = times.shape[0]
        i1 = torch.clamp(torch.searchsorted(times, pc.time), 1, T - 1)
        i0 = i1 - 1
        t0, t1 = times[i0], times[i1]
        a = torch.clamp((pc.time - t0) / torch.clamp(t1 - t0, min=1e-9), 0.0, 1.0)
        tangents = tang[i0] * (1 - a)[..., None] + tang[i1] * a[..., None]
        R = se3.exp(tangents).R
        new_xyz = (se3.matmul3(R, pc.xyz[..., :, None])[..., 0]
                   + pc.time[..., None] * twist[..., None, :3])
        return torch.where(pc.valid_mask()[..., None], new_xyz, pc.xyz)
