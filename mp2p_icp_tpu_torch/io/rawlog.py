"""Rawlog: a flat, ordered stream of sensor observations.

Port of ``mp2p_icp_tpu/io/rawlog.py`` (reference analogue: mrpt CRawlog as
apps/rawlog-filter/main.cpp:92-245 and icp-run's ``.rawlog:N`` input,
apps/icp-run/main.cpp:117-178, use it). A ``.rawlog.npz`` holds the
observations as numpy arrays and one JSON metadata blob, the storage
pattern of ``SimpleMap`` but flat: a rawlog is a time-ordered sensor log, a
simple map a keyframe map. A sensory frame (the reference's CSensoryFrame)
is the set of observations that share a ``frame`` id. The keys are the JAX
package's, so either package reads the other's files.
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Optional

import numpy as np
import torch

from mp2p_icp_tpu_torch.core import se3
from mp2p_icp_tpu_torch.device import resolve
from mp2p_icp_tpu_torch.filters.generator import Observation
from mp2p_icp_tpu_torch.io.mm import to_numpy

_CHANNELS = ("xyz", "intensity", "ring", "time")


@dataclasses.dataclass
class Rawlog:
    """Ordered observation stream (reference analogue: mrpt CRawlog)."""

    observations: List[Observation] = dataclasses.field(default_factory=list)
    # the sensory-frame id of each observation (same id = same frame)
    frames: List[int] = dataclasses.field(default_factory=list)

    def __len__(self) -> int:
        return len(self.observations)

    def append(self, obs: Observation, frame: Optional[int] = None) -> None:
        if frame is None:
            frame = (max(self.frames) + 1) if self.frames else 0
        self.observations.append(obs)
        self.frames.append(int(frame))

    def save(self, path: str) -> None:
        arrays, meta = {}, []
        for i, o in enumerate(self.observations):
            entry = {
                "class_name": o.class_name,
                "sensor_label": o.sensor_label,
                "timestamp": float(o.timestamp),
                "frame": int(self.frames[i]) if i < len(self.frames) else i,
                "has": [c for c in _CHANNELS if getattr(o, c) is not None],
                "text": o.text,
                "angular_velocity": list(o.angular_velocity) if o.angular_velocity else None,
                "has_sensor_pose": o.sensor_pose is not None,
            }
            for c in entry["has"]:
                arrays[f"obs{i}/{c}"] = np.asarray(getattr(o, c))
            if o.sensor_pose is not None:
                arrays[f"obs{i}/R"] = to_numpy(o.sensor_pose.R)
                arrays[f"obs{i}/t"] = to_numpy(o.sensor_pose.t)
            meta.append(entry)
        arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
        np.savez_compressed(path, **arrays)

    @staticmethod
    def load(path: str, device=None) -> "Rawlog":
        """The stream of a saved rawlog; sensor poses on ``device`` (default:
        the package's default device), point channels as numpy arrays."""
        device = resolve(device)
        rl = Rawlog()
        with np.load(path) as data:
            meta = json.loads(bytes(data["__meta__"]).decode())
            for i, entry in enumerate(meta):
                kw = {c: data[f"obs{i}/{c}"] for c in entry["has"]}
                pose = None
                if entry.get("has_sensor_pose"):
                    pose = se3.Pose(torch.from_numpy(data[f"obs{i}/R"]).to(device),
                                    torch.from_numpy(data[f"obs{i}/t"]).to(device))
                av = entry.get("angular_velocity")
                rl.observations.append(Observation(
                    class_name=entry["class_name"], sensor_label=entry["sensor_label"],
                    timestamp=entry["timestamp"], sensor_pose=pose, text=entry.get("text"),
                    angular_velocity=tuple(av) if av else None, **kw))
                rl.frames.append(int(entry.get("frame", i)))
        return rl


def pointcloud_to_observation(pc, *, sensor_label: str = "",
                              timestamp: float = 0.0) -> Observation:
    """A point layer as a CObservationPointCloud-style record, cut to its
    valid rows (reference: apps/rawlog-filter/main.cpp:210-224)."""
    n = int(pc.count)

    def trim(ch):
        return None if ch is None else to_numpy(ch)[:n]

    return Observation(class_name="CObservationPointCloud", sensor_label=sensor_label,
                       timestamp=timestamp, xyz=to_numpy(pc.xyz)[:n],
                       intensity=trim(pc.intensity), ring=trim(pc.ring), time=trim(pc.time))
