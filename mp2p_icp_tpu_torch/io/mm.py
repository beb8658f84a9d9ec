"""Metric-map files: the ``.mm.npz`` container, and the reference's binary ``.mm``.

Port of ``mp2p_icp_tpu/io/mm.py`` (reference: metricmap.cpp:48-178 and
:651-677): a compressed npz of the layers' arrays and a JSON header for the
metadata and georeferencing, versioned. The keys are the JAX package's, so
either package reads the other's files. ``load_mm_file`` sends a file that
is not a zip (a gzipped MRPT archive, or a raw one) to ``io.mrpt_mm``.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from mp2p_icp_tpu_torch.core.metric_map import (
    Georeferencing,
    LineSet,
    MetricMap,
    PlaneSet,
    VoxelGridLayer,
)
from mp2p_icp_tpu_torch.core.pointcloud import PointCloud
from mp2p_icp_tpu_torch.device import resolve

FORMAT_VERSION = 1
_CHANNELS = ("intensity", "ring", "time")


def to_numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_mm_file(path: str, mm: MetricMap) -> None:
    arrays = {}
    meta = {"version": FORMAT_VERSION, "id": mm.id, "label": mm.label, "layers": {}}
    for name, layer in mm.layers.items():
        if isinstance(layer, PointCloud):
            meta["layers"][name] = {"type": "points"}
            arrays[f"layer/{name}/xyz"] = to_numpy(layer.xyz)
            arrays[f"layer/{name}/count"] = to_numpy(layer.count)
            for ch in _CHANNELS:
                v = getattr(layer, ch)
                if v is not None:
                    arrays[f"layer/{name}/{ch}"] = to_numpy(v)
        elif isinstance(layer, VoxelGridLayer):
            meta["layers"][name] = {"type": "voxelgrid", "resolution": layer.resolution}
            for f in ("keys", "occupancy", "valid"):
                arrays[f"layer/{name}/{f}"] = to_numpy(getattr(layer, f))
    for set_name, s in (("lines", mm.lines), ("planes", mm.planes)):
        if int(s.count):
            for f in dataclasses.fields(s):
                arrays[f"{set_name}/{f.name}"] = to_numpy(getattr(s, f.name))
    g = mm.georeferencing
    if g is not None:
        meta["georeferencing"] = {
            "latitude": g.latitude, "longitude": g.longitude, "height": g.height,
            "t_enu_to_map_xyz": list(g.t_enu_to_map_xyz),
            "t_enu_to_map_quat_wxyz": list(g.t_enu_to_map_quat_wxyz),
        }
        if g.t_enu_to_map_cov is not None:
            meta["georeferencing"]["t_enu_to_map_cov"] = [list(r) for r in g.t_enu_to_map_cov]
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_mm_file(path: str, device=None) -> MetricMap:
    """The map of an ``.mm.npz`` (or a binary ``.mm``) file, its tensors on
    ``device`` (default: the package's default device)."""
    device = resolve(device)
    with open(path, "rb") as f:
        head = f.read(2)
    if head != b"PK":  # not a zip, so not an npz: the reference's binary format
        from mp2p_icp_tpu_torch.io.mrpt_mm import load_mrpt_mm

        return load_mrpt_mm(path, device=device)

    def t(a):
        return torch.from_numpy(np.asarray(a)).to(device)

    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        if meta["version"] > FORMAT_VERSION:
            raise ValueError(f"mm file version {meta['version']} newer than supported "
                             f"{FORMAT_VERSION}")
        layers = {}
        for name, info in meta["layers"].items():
            if info["type"] == "points":
                kw = {ch: t(data[f"layer/{name}/{ch}"]) for ch in _CHANNELS
                      if f"layer/{name}/{ch}" in data}
                layers[name] = PointCloud(xyz=t(data[f"layer/{name}/xyz"]),
                                          count=t(data[f"layer/{name}/count"]), **kw)
            elif info["type"] == "voxelgrid":
                layers[name] = VoxelGridLayer(
                    keys=t(data[f"layer/{name}/keys"]),
                    occupancy=t(data[f"layer/{name}/occupancy"]),
                    valid=t(data[f"layer/{name}/valid"]), resolution=info["resolution"])
        mm = MetricMap(layers=layers, id=meta.get("id"), label=meta.get("label"),
                       lines=LineSet.empty(device=device), planes=PlaneSet.empty(device=device))
        if "lines/point" in data:
            mm.lines = LineSet(point=t(data["lines/point"]), direction=t(data["lines/direction"]),
                               count=t(data["lines/count"]))
        if "planes/normal" in data:
            mm.planes = PlaneSet(normal=t(data["planes/normal"]),
                                 centroid=t(data["planes/centroid"]),
                                 count=t(data["planes/count"]))
        if "georeferencing" in meta:
            g = meta["georeferencing"]
            cov = g.get("t_enu_to_map_cov")
            mm.georeferencing = Georeferencing(
                latitude=g["latitude"], longitude=g["longitude"], height=g["height"],
                t_enu_to_map_xyz=tuple(g["t_enu_to_map_xyz"]),
                t_enu_to_map_quat_wxyz=tuple(g["t_enu_to_map_quat_wxyz"]),
                t_enu_to_map_cov=None if cov is None else tuple(tuple(r) for r in cov))
    return mm
