"""Time-windowed velocity buffer for the precise deskew.

Port of ``mp2p_icp_tpu/core/velocity_buffer.py`` (reference:
LocalVelocityBuffer.h:33-97): a window of timestamped linear and angular
velocities (IMU, odometry) and ``reconstruct_poses_around_reference_time``,
which integrates them forward and backward into a short trajectory
relative to a reference time. Host code: the samples live in dicts, and
the integration runs on the CPU in float32 through the port's se3, one
small product per step, as the JAX package's does.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from mp2p_icp_tpu_torch.core import se3


@dataclasses.dataclass
class LocalVelocityBuffer:
    max_time_window: float = 1.0  # seconds kept before the newest sample

    def __post_init__(self):
        self._lin: Dict[float, np.ndarray] = {}
        self._ang: Dict[float, np.ndarray] = {}

    def add_linear_velocity(self, t: float, v) -> None:
        self._lin[float(t)] = np.asarray(v, np.float64)
        self._trim()

    def add_angular_velocity(self, t: float, w) -> None:
        self._ang[float(t)] = np.asarray(w, np.float64)
        self._trim()

    def _trim(self):
        ts = list(self._lin) + list(self._ang)
        if not ts:
            return
        lo = max(ts) - self.max_time_window
        self._lin = {t: v for t, v in self._lin.items() if t >= lo}
        self._ang = {t: v for t, v in self._ang.items() if t >= lo}

    def empty(self) -> bool:
        return not self._lin and not self._ang

    def clear(self) -> None:
        self._lin.clear()
        self._ang.clear()

    def _twist_at(self, t: float) -> np.ndarray:
        """The nearest samples' twist [vx vy vz wx wy wz] at time t."""
        out = np.zeros(6)
        for src, sl in ((self._lin, slice(0, 3)), (self._ang, slice(3, 6))):
            if src:
                ts = sorted(src)
                i = bisect.bisect_left(ts, t)
                if i >= len(ts):
                    i = len(ts) - 1
                elif i > 0 and abs(ts[i - 1] - t) < abs(ts[i] - t):
                    i -= 1
                out[sl] = src[ts[i]]
        return out

    def reconstruct_poses_around_reference_time(
        self, reference_time: float, half_window: float, dt: float = 5e-3
    ) -> Tuple[np.ndarray, np.ndarray]:
        """The twist samples integrated into a relative trajectory: (times
        [T], tangents [T, 6]), pose(t) = exp(tangent[t]) the motion from the
        reference time to t (the identity there); forward integration after
        it, backward before it (reference: LocalVelocityBuffer.h:89)."""
        n_side = max(1, int(round(half_window / dt)))
        times = reference_time + dt * np.arange(-n_side, n_side + 1)
        T = len(times)
        eye = se3.identity(device="cpu")
        poses = [None] * T
        poses[n_side] = eye

        def step(tw):
            return se3.exp(torch.tensor(tw * dt, dtype=torch.float32))

        cur = eye
        for i in range(n_side + 1, T):
            cur = se3.compose(cur, step(self._twist_at(times[i - 1])))
            poses[i] = cur
        cur = eye
        for i in range(n_side - 1, -1, -1):
            cur = se3.compose(cur, se3.inverse(step(self._twist_at(times[i]))))
            poses[i] = cur
        return times, np.stack([se3.log(p).numpy() for p in poses])

    def to_yaml_dict(self) -> dict:
        return {
            "max_time_window": self.max_time_window,
            "linear": {str(t): v.tolist() for t, v in self._lin.items()},
            "angular": {str(t): v.tolist() for t, v in self._ang.items()},
        }

    @staticmethod
    def from_yaml_dict(d: dict) -> "LocalVelocityBuffer":
        buf = LocalVelocityBuffer(max_time_window=float(d.get("max_time_window", 1.0)))
        for t, v in (d.get("linear") or {}).items():
            buf.add_linear_velocity(float(t), v)
        for t, v in (d.get("angular") or {}).items():
            buf.add_angular_velocity(float(t), v)
        return buf
