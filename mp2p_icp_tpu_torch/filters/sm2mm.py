"""Simple map -> metric map (sm2mm).

Port of ``mp2p_icp_tpu/filters/sm2mm.py`` (reference: sm2mm.cpp:31-250):
for each keyframe of a simple map, set the keyframe's variables (the robot
pose ``robot_x..robot_roll`` and the twist ``vx..wz``), run the generators
over its observations, run the per-keyframe filters, then the
``final_filters``; an index range resumes a partial build; comment
observations may carry a local velocity buffer in YAML and IMU
observations feed it, and its trajectory goes to FilterDeskew's precise
mode.

The keyframe loop runs on the host; the layers stay on their device
(``default_device()`` for what the generators make). ``SimpleMap.save`` /
``load`` use the JAX package's ``.npz`` layout, so each package reads the
other's files.
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Optional, Tuple

import numpy as np
import torch
import yaml as _yaml

from mp2p_icp_tpu_torch.core import se3
from mp2p_icp_tpu_torch.core.metric_map import MetricMap
from mp2p_icp_tpu_torch.core.velocity_buffer import LocalVelocityBuffer
from mp2p_icp_tpu_torch.device import resolve
from mp2p_icp_tpu_torch.filters.base import apply_filter_pipeline
from mp2p_icp_tpu_torch.filters.generator import (
    Observation,
    apply_generators,
    generators_from_yaml,
)

_TWIST_NAMES = ("vx", "vy", "vz", "wx", "wy", "wz")
_CHANNELS = ("xyz", "intensity", "ring", "time")


@dataclasses.dataclass
class Keyframe:
    """One simple-map entry: the robot pose and its sensory frame
    (reference analogue: a CSimpleMap keyframe)."""

    pose: se3.Pose
    observations: List[Observation] = dataclasses.field(default_factory=list)
    twist: Optional[Tuple[float, ...]] = None  # (vx vy vz wx wy wz)


@dataclasses.dataclass
class SimpleMap:
    """Keyframe map (reference analogue: mrpt CSimpleMap)."""

    keyframes: List[Keyframe] = dataclasses.field(default_factory=list)

    def save(self, path: str) -> None:
        arrays, meta = {}, []
        for i, kf in enumerate(self.keyframes):
            arrays[f"kf{i}/R"] = kf.pose.R.detach().cpu().numpy()
            arrays[f"kf{i}/t"] = kf.pose.t.detach().cpu().numpy()
            kf_meta = {"twist": list(kf.twist) if kf.twist else None, "obs": []}
            for j, o in enumerate(kf.observations):
                ometa = {"class_name": o.class_name, "sensor_label": o.sensor_label,
                         "timestamp": o.timestamp,
                         "has": [ch for ch in _CHANNELS if getattr(o, ch) is not None]}
                if o.text is not None:
                    ometa["text"] = o.text
                for extra in ("angular_velocity", "linear_velocity"):
                    if getattr(o, extra) is not None:
                        ometa[extra] = [float(x) for x in getattr(o, extra)]
                kf_meta["obs"].append(ometa)
                for ch in ometa["has"]:
                    arrays[f"kf{i}/obs{j}/{ch}"] = np.asarray(getattr(o, ch))
            meta.append(kf_meta)
        arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
        np.savez_compressed(path, **arrays)

    @staticmethod
    def load(path: str, device=None) -> "SimpleMap":
        """The keyframes of a saved map, their poses on ``device`` (default:
        the package's default device)."""
        device = resolve(device)
        sm = SimpleMap()
        with np.load(path) as data:
            meta = json.loads(bytes(data["__meta__"]).decode())
            for i, kf_meta in enumerate(meta):
                kf = Keyframe(
                    pose=se3.Pose(torch.from_numpy(data[f"kf{i}/R"]).to(device),
                                  torch.from_numpy(data[f"kf{i}/t"]).to(device)),
                    twist=tuple(kf_meta["twist"]) if kf_meta["twist"] else None,
                )
                for j, ometa in enumerate(kf_meta["obs"]):
                    kw = {ch: data[f"kf{i}/obs{j}/{ch}"] for ch in ometa["has"]}
                    if ometa.get("text") is not None:
                        kw["text"] = ometa["text"]
                    for extra in ("angular_velocity", "linear_velocity"):
                        if ometa.get(extra) is not None:
                            kw[extra] = tuple(ometa[extra])
                    kf.observations.append(Observation(
                        class_name=ometa["class_name"], sensor_label=ometa["sensor_label"],
                        timestamp=ometa["timestamp"], **kw))
                sm.keyframes.append(kf)
        return sm


@dataclasses.dataclass
class Sm2MmOptions:
    """Reference: sm2mm_options_t (sm2mm.h:38)."""

    start_index: int = 0
    end_index: Optional[int] = None
    verbose: bool = False


def keyframe_variables(kf: Keyframe) -> dict:
    """The keyframe's variables (reference: sm2mm.cpp:162-184): the robot
    pose as x, y, z, yaw, pitch, roll and the twist, as Python floats."""
    R = kf.pose.R.detach().cpu().numpy()
    t = kf.pose.t.detach().cpu().numpy()
    variables = {
        "robot_x": float(t[0]), "robot_y": float(t[1]), "robot_z": float(t[2]),
        "robot_yaw": float(np.arctan2(R[1, 0], R[0, 0])),
        "robot_pitch": float(np.arctan2(-R[2, 0], np.hypot(R[2, 1], R[2, 2]))),
        "robot_roll": float(np.arctan2(R[2, 1], R[2, 2])),
    }
    for name, v in zip(_TWIST_NAMES, kf.twist or (0,) * 6):
        variables[name] = float(v)
    return variables


def simplemap_to_metricmap(sm: SimpleMap, pipeline_yaml: dict,
                           options: Sm2MmOptions = Sm2MmOptions()) -> MetricMap:
    """A metric map from a keyframe map (reference: sm2mm.cpp:31)."""
    from mp2p_icp_tpu_torch.pipeline.yaml_loader import filter_pipeline_from_yaml

    generators = generators_from_yaml(pipeline_yaml.get("generators"))
    filters = filter_pipeline_from_yaml(pipeline_yaml.get("filters"))
    final_filters = filter_pipeline_from_yaml(pipeline_yaml.get("final_filters"))

    mm = MetricMap()
    velocity_buffer = LocalVelocityBuffer()
    end = options.end_index if options.end_index is not None else len(sm.keyframes)
    for idx in range(options.start_index, min(end, len(sm.keyframes))):
        kf = sm.keyframes[idx]
        variables = keyframe_variables(kf)
        kf_mm = MetricMap(layers=dict(mm.layers))  # the map's layers carry over
        pc_timestamp = None  # the scan's reference time (Generator.cpp:432-440)
        scan_half_span = 0.1
        for obs in kf.observations:
            if obs.class_name == "CObservationComment" and obs.text:
                # a velocity buffer in YAML (sm2mm.cpp:95-137)
                d = _yaml.safe_load(obs.text)
                if isinstance(d, dict) and "local_velocity_buffer" in d:
                    velocity_buffer = LocalVelocityBuffer.from_yaml_dict(
                        d["local_velocity_buffer"])
                continue
            if obs.class_name.endswith("CObservationIMU"):
                # gyro samples feed the buffer (Generator.cpp:190-216)
                if obs.angular_velocity is not None:
                    w = obs.angular_velocity
                    if obs.sensor_pose is not None:
                        w = tuple(obs.sensor_pose.R.detach().cpu().numpy()
                                  @ np.asarray(w, np.float64))
                    velocity_buffer.add_angular_velocity(obs.timestamp, w)
                if obs.linear_velocity is not None:
                    velocity_buffer.add_linear_velocity(obs.timestamp, obs.linear_velocity)
                continue
            handled = apply_generators(generators, obs, kf_mm)
            if handled and pc_timestamp is None:
                pc_timestamp = obs.timestamp
                if obs.time is not None and len(obs.time):
                    scan_half_span = float(max(np.max(np.abs(obs.time)), 1e-3))
        # the relative trajectory around the scan's reference time goes to
        # FilterDeskew through the variables (sm2mm.cpp:95-137 ->
        # FilterDeskew.cpp:162-240)
        if not velocity_buffer.empty() and pc_timestamp is not None:
            times, tangents = velocity_buffer.reconstruct_poses_around_reference_time(
                pc_timestamp, scan_half_span)
            variables["trajectory_times"] = times - pc_timestamp
            variables["trajectory_tangents"] = tangents
        apply_filter_pipeline(filters, kf_mm, variables)
        mm.layers = kf_mm.layers
        if options.verbose:
            print(f"[sm2mm] kf {idx + 1}/{len(sm.keyframes)}: {mm.contents_summary()}")

    apply_filter_pipeline(final_filters, mm, None)
    return mm
