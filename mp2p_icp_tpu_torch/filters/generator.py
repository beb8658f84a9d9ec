"""Generators: sensor observations -> metric-map layers.

Port of ``mp2p_icp_tpu/filters/generator.py`` (reference: Generator.h:79-251,
Generator.cpp): regex gating on the observation's class name and sensor
label (Generator.cpp:381-393); the default path inserts the points into a
point layer (:447-487); the custom path builds the layer that a YAML
``metric_map_definition`` names (:492-612: point-map flavours and
CVoxelMap); ``apply_generators`` runs a list over one observation
(:276-305).

An ``Observation`` is a plain record of numpy arrays and metadata whose
class name mirrors MRPT's, so the same YAML regexes apply. Decoding (polar
to Cartesian, an organized range image to points) and the sensor pose run
on the host in numpy and float32, as in the JAX package; the layer that
comes out is a PointCloud (or a voxel layer) on the default device.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from mp2p_icp_tpu_torch.core import se3
from mp2p_icp_tpu_torch.core.metric_map import MetricMap, VoxelGridLayer
from mp2p_icp_tpu_torch.core.pointcloud import PointCloud
from mp2p_icp_tpu_torch.device import default_device
from mp2p_icp_tpu_torch.ops.voxel_occupancy import update_voxel_map


@dataclasses.dataclass
class Observation:
    """A sensor observation (reference analogue: mrpt::obs::CObservation*).

    class_name: e.g. 'CObservationPointCloud', 'CObservation2DRangeScan',
                'CObservationRotatingScan', 'CObservationVelodyneScan',
                'CObservationIMU', 'CObservationComment'.
    sensor_pose: the sensor on the robot, an se3.Pose on any device.
    """

    class_name: str = "CObservationPointCloud"
    sensor_label: str = ""
    timestamp: float = 0.0
    xyz: Optional[np.ndarray] = None  # [N, 3]
    intensity: Optional[np.ndarray] = None
    ring: Optional[np.ndarray] = None
    time: Optional[np.ndarray] = None  # per-point relative times
    sensor_pose: Optional[se3.Pose] = None
    # 2D range scan (CObservation2DRangeScan)
    scan_ranges: Optional[np.ndarray] = None  # [N] ranges (m)
    scan_valid: Optional[np.ndarray] = None  # [N] bool (None = all valid)
    aperture: float = np.pi  # total angular aperture (rad)
    right_to_left: bool = True  # CCW scan direction
    max_range: float = 80.0
    # organized rotating scan (CObservationRotatingScan): range image
    # [rows, cols] in metres (0 = no return), rows are rings
    range_image: Optional[np.ndarray] = None
    intensity_image: Optional[np.ndarray] = None
    azimuth_start: float = -np.pi  # azimuth of column 0
    azimuth_stop: float = np.pi  # azimuth past the last column
    elevation_angles: Optional[np.ndarray] = None  # [rows] rad
    sweep_duration: float = 0.0  # for per-point relative times
    # IMU (CObservationIMU)
    angular_velocity: Optional[Tuple[float, float, float]] = None
    linear_velocity: Optional[Tuple[float, float, float]] = None
    # a comment observation may carry YAML (sm2mm reads the local velocity
    # buffer from one)
    text: Optional[str] = None


# ------------------------------------------------------------ decoders
def decode_scan2d(obs: Observation):
    """CObservation2DRangeScan -> [N, 3] sensor-frame points: ranges at
    evenly spaced bearings over ``aperture`` centred on the sensor's x
    axis, z = 0 (what MRPT's insertObservationInto does for 2D scans,
    Generator.cpp:477)."""
    r = np.asarray(obs.scan_ranges, np.float32).reshape(-1)
    n = r.shape[0]
    valid = (np.asarray(obs.scan_valid, bool).reshape(-1) if obs.scan_valid is not None
             else np.ones((n,), bool))
    valid = valid & (r > 0) & (r < obs.max_range)
    if n > 1:
        a = (np.arange(n, dtype=np.float32) / (n - 1) - 0.5) * obs.aperture
    else:
        a = np.zeros((1,), np.float32)
    if not obs.right_to_left:
        a = -a
    pts = np.stack([r * np.cos(a), r * np.sin(a), np.zeros_like(r)], 1)
    return pts[valid].astype(np.float32), None, None, None


def decode_rotating_scan(obs: Observation):
    """CObservationRotatingScan -> sensor-frame points and their intensity,
    ring and time: column -> azimuth over [azimuth_start, azimuth_stop),
    row -> elevation; a zero range is no return; ring = row, time linear in
    the azimuth over ``sweep_duration``."""
    R = np.asarray(obs.range_image, np.float32)
    rows, cols = R.shape
    az = obs.azimuth_start + ((obs.azimuth_stop - obs.azimuth_start)
                              * (np.arange(cols, dtype=np.float32) + 0.5) / cols)
    el = (np.asarray(obs.elevation_angles, np.float32).reshape(rows)
          if obs.elevation_angles is not None else np.zeros((rows,), np.float32))
    ca, sa = np.cos(az)[None, :], np.sin(az)[None, :]
    ce, se_ = np.cos(el)[:, None], np.sin(el)[:, None]
    valid = (R > 0) & np.isfinite(R)
    pts = np.stack([(R * ce * ca)[valid], (R * ce * sa)[valid], (R * se_)[valid]],
                   1).astype(np.float32)
    ring = np.broadcast_to(np.arange(rows, dtype=np.float32)[:, None], R.shape)[valid]
    t = np.broadcast_to((np.arange(cols, dtype=np.float32) + 0.5) / cols * obs.sweep_duration,
                        R.shape)[valid]
    inten = (np.asarray(obs.intensity_image, np.float32)[valid]
             if obs.intensity_image is not None else None)
    return pts, inten, ring.astype(np.float32), t.astype(np.float32)


def _apply_on_host(pose: se3.Pose, xyz: np.ndarray) -> np.ndarray:
    cpu = se3.Pose(pose.R.detach().cpu().to(torch.float32), pose.t.detach().cpu().to(torch.float32))
    return se3.apply(cpu, torch.from_numpy(np.asarray(xyz, np.float32))).numpy()


# --------------------------------------------------------------- Generator
@dataclasses.dataclass(frozen=True)
class Generator:
    """Reference: Generator.h params (process_class_names_regex,
    process_sensor_labels_regex, target_layer, throw_on_unhandled,
    metric_map_definition...)."""

    target_layer: str = "raw"
    process_class_names_regex: str = ".*"
    process_sensor_labels_regex: str = ".*"
    throw_on_unhandled_observation_class: bool = False
    # merge new scans into the existing layer, or replace it
    accumulate: bool = False
    # the YAML metric_map_definition (Generator.cpp:492-612) as a tuple of
    # pairs, so that the dataclass stays hashable (generators_from_yaml
    # builds it from a dict)
    metric_map_definition: Tuple[Tuple[str, object], ...] = ()

    def handles(self, obs: Observation) -> bool:
        return bool(re.match(self.process_class_names_regex, obs.class_name)
                    and re.match(self.process_sensor_labels_regex, obs.sensor_label))

    def _decode(self, obs: Observation):
        """(xyz, intensity, ring, time) in the sensor frame, or None when the
        observation carries no points."""
        cn = obs.class_name.split("::")[-1]
        if cn == "CObservation2DRangeScan" and obs.scan_ranges is not None:
            return decode_scan2d(obs)
        if cn == "CObservationRotatingScan" and obs.range_image is not None:
            return decode_rotating_scan(obs)
        if obs.xyz is not None:
            return (np.asarray(obs.xyz, np.float32).reshape(-1, 3), obs.intensity, obs.ring,
                    obs.time)
        return None

    def process(self, obs: Observation, mm: MetricMap) -> bool:
        """Insert the observation into ``mm``; True when it was handled
        (reference: Generator::process, Generator.cpp:371-487)."""
        cn = obs.class_name.split("::")[-1]
        # types handled at the pipeline's level (Generator.cpp:381-387)
        if cn in ("CObservationComment", "CObservationGPS", "CObservationRobotPose",
                  "CObservationIMU"):
            return False
        if not self.handles(obs):
            return False
        decoded = self._decode(obs)
        if decoded is None:
            if self.throw_on_unhandled_observation_class:
                raise ValueError(
                    f"Generator: observation {obs.class_name} could not be converted into "
                    "a point cloud (reference: Generator.cpp:479-486)")
            return False
        xyz, intensity, ring, time = decoded
        if obs.sensor_pose is not None:
            xyz = _apply_on_host(obs.sensor_pose, xyz)
        if self.metric_map_definition:
            return self._insert_custom(xyz, mm, obs.sensor_pose, intensity=intensity,
                                       ring=ring, time=time)
        self._insert_points(mm, PointCloud.from_numpy(xyz, intensity=intensity, ring=ring,
                                                      time=time),
                            self.accumulate)
        return True

    def _insert_points(self, mm: MetricMap, pc: PointCloud, merge: bool) -> None:
        if merge and self.target_layer in mm.layers:
            mm.merge_with(MetricMap(layers={self.target_layer: pc}))
        else:
            mm.layers[self.target_layer] = pc

    def _insert_custom(self, xyz: np.ndarray, mm: MetricMap, sensor_pose=None,
                       intensity=None, ring=None, time=None) -> bool:
        """Create-if-new and insert for a YAML-defined layer class
        (reference: implProcessCustomMap, Generator.cpp:492-612): the point
        map flavours (CSimplePointsMap, CPointsMapXYZI, CPointsMapXYZIRT,
        with the channels each carries) and CVoxelMap (an occupancy layer
        with free-space carving from the sensor's position)."""
        spec = dict(self.metric_map_definition)
        cls = str(spec.get("class", "CSimplePointsMap")).split("::")[-1]
        if cls in ("CSimplePointsMap", "CPointsMapXYZI", "CPointsMapXYZIRT"):
            pc = PointCloud.from_numpy(
                xyz,
                intensity=intensity if cls != "CSimplePointsMap" else None,
                ring=ring if cls == "CPointsMapXYZIRT" else None,
                time=time if cls == "CPointsMapXYZIRT" else None,
            )
            self._insert_points(mm, pc, True)
            return True
        if cls == "CVoxelMap":
            copts = dict(spec.get("creationOpts", ()) or ())
            iopts = dict(spec.get("insertOpts", ()) or ())
            device = default_device()
            vg = mm.layers.get(self.target_layer)
            if not isinstance(vg, VoxelGridLayer):
                vg = VoxelGridLayer.empty(int(copts.get("capacity", 1 << 16)),
                                          float(copts.get("resolution", 0.5)), device=device)
            pts = torch.from_numpy(np.asarray(xyz, np.float32)).to(vg.device)
            # the rays start at the sensor (the points are in the vehicle
            # frame already)
            origin = (sensor_pose.t.detach().to(vg.device, torch.float32)
                      if sensor_pose is not None else torch.zeros(3, device=vg.device))
            mm.layers[self.target_layer] = update_voxel_map(
                vg, pts, torch.ones(pts.shape[0], dtype=torch.bool, device=vg.device), origin,
                carve_free_space=bool(iopts.get("ray_trace", True)))
            return True
        if self.throw_on_unhandled_observation_class:
            raise ValueError(f"metric_map_definition: unknown class {cls}")
        return False


def apply_generators(generators: Sequence[Generator], obs: Observation, mm: MetricMap) -> bool:
    """Run the generators in order (reference: apply_generators,
    Generator.cpp:276-305); True when any handled the observation."""
    handled = False
    for g in generators:
        handled = g.process(obs, mm) or handled
    return handled


def _freeze(v):
    if isinstance(v, dict):
        return tuple((k, _freeze(x)) for k, x in v.items())
    if isinstance(v, list):
        return tuple(_freeze(x) for x in v)
    return v


def generators_from_yaml(entries) -> list:
    """Reference: generators_from_yaml (Generator.cpp:328); one default
    Generator when the list is empty."""
    out = []
    for entry in entries or []:
        cls = str(entry.get("class_name", "Generator")).split("::")[-1]
        if cls != "Generator":
            raise ValueError(f"Unknown generator class: {cls}")
        p = entry.get("params", {}) or {}
        out.append(Generator(
            target_layer=p.get("target_layer", "raw"),
            process_class_names_regex=p.get("process_class_names_regex", ".*"),
            process_sensor_labels_regex=p.get("process_sensor_labels_regex", ".*"),
            throw_on_unhandled_observation_class=bool(
                p.get("throw_on_unhandled_observation_class", False)),
            metric_map_definition=_freeze(p.get("metric_map_definition", {}) or {}),
        ))
    return out or [Generator()]
