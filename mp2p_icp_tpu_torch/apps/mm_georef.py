"""mm-georef: extract / inject a metric map's georeferencing, convert
between WGS-84 fixes and map coordinates, rewrite a map in its ENU frame.

Port of ``mp2p_icp_tpu/apps/mm_georef.py`` (reference: apps/mm-georef/main.cpp:197;
the geodesy of core/geodesy.py). ``--to-enu`` rewrites each point layer on
the device that holds it: map_to_enu's R and t come from the host, the
rows are transformed in float64 and rounded to float32 once, as the JAX
package's numpy float64 does.

Usage:
  python -m mp2p_icp_tpu_torch.apps.mm_georef map.mm.npz [--extract georef.yaml |
      --inject georef.yaml -o out.mm.npz | --to-enu -o out.mm.npz |
      --geodetic-to-map LAT,LON,H | --map-to-geodetic X,Y,Z] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch
import yaml

from mp2p_icp_tpu_torch.apps import add_device_argument, on_device


def main(argv=None):
    ap = argparse.ArgumentParser(prog="mm-georef")
    ap.add_argument("input", help=".mm.npz metric map")
    ap.add_argument("--extract", default=None, help="write georef YAML here")
    ap.add_argument("--inject", default=None, help="read georef YAML from here")
    ap.add_argument("-o", "--output", default=None,
                    help="output map (required with --inject/--to-enu)")
    ap.add_argument("--to-enu", action="store_true",
                    help="transform all point layers into the map's ENU frame by applying "
                         "T_enu_to_map^-1 (WGS-84 geodesy: core/geodesy.py)")
    ap.add_argument("--geodetic-to-map", default=None, metavar="LAT,LON,H",
                    help="convert a WGS-84 geodetic fix to map coordinates via the stored "
                         "anchor + T_enu_to_map (prints x y z)")
    ap.add_argument("--map-to-geodetic", default=None, metavar="X,Y,Z",
                    help="convert a map point to a WGS-84 geodetic fix (prints lat lon h)")
    add_device_argument(ap)
    args = ap.parse_args(argv)

    from mp2p_icp_tpu_torch.io.mm import load_mm_file

    with on_device(args.device) as device:
        return _run(args, load_mm_file(args.input, device=device))


def _run(args, mm) -> int:
    from mp2p_icp_tpu_torch.core import geodesy
    from mp2p_icp_tpu_torch.core.metric_map import Georeferencing
    from mp2p_icp_tpu_torch.core.pointcloud import PointCloud
    from mp2p_icp_tpu_torch.io.mm import save_mm_file

    if args.extract:
        if mm.georeferencing is None:
            print("map has no georeferencing")
            return 1
        g = mm.georeferencing
        with open(args.extract, "w") as f:
            yaml.safe_dump({"georeferencing": {
                "latitude": g.latitude,
                "longitude": g.longitude,
                "height": g.height,
                "t_enu_to_map": {
                    "translation": list(g.t_enu_to_map_xyz),
                    "quaternion_wxyz": list(g.t_enu_to_map_quat_wxyz),
                },
            }}, f)
        print(f"georeferencing written to {args.extract}")
        return 0

    if args.inject:
        if not args.output:
            raise SystemExit("error: --inject requires -o/--output")
        with open(args.inject) as f:
            d = yaml.safe_load(f)["georeferencing"]
        tf = d.get("t_enu_to_map", {})
        mm.georeferencing = Georeferencing(
            latitude=float(d["latitude"]),
            longitude=float(d["longitude"]),
            height=float(d.get("height", 0.0)),
            t_enu_to_map_xyz=tuple(tf.get("translation", (0, 0, 0))),
            t_enu_to_map_quat_wxyz=tuple(tf.get("quaternion_wxyz", (1, 0, 0, 0))),
        )
        save_mm_file(args.output, mm)
        print(f"georeferencing injected; wrote {args.output}")
        return 0

    if args.geodetic_to_map or args.map_to_geodetic or args.to_enu:
        if mm.georeferencing is None:
            print("map has no georeferencing")
            return 1
        g = mm.georeferencing
        if args.geodetic_to_map:
            lat, lon, h = (float(v) for v in args.geodetic_to_map.split(","))
            p = geodesy.geodetic_to_map(lat, lon, h, g)
            print(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}")
            return 0
        if args.map_to_geodetic:
            xyz = [float(v) for v in args.map_to_geodetic.split(",")]
            lat, lon, h = geodesy.map_to_geodetic(np.asarray(xyz, np.float64), g)
            print(f"{float(lat):.8f} {float(lon):.8f} {float(h):.3f}")
            return 0
        # --to-enu: rewrite every point layer in the ENU frame
        if not args.output:
            raise SystemExit("error: --to-enu requires -o/--output")
        for name, layer in list(mm.layers.items()):
            if isinstance(layer, PointCloud):
                mm.layers[name] = dataclasses.replace(layer, xyz=map_to_enu_rows(layer, g))
        # the rewritten map IS the ENU frame: identity transform
        mm.georeferencing = dataclasses.replace(
            g, t_enu_to_map_xyz=(0.0, 0.0, 0.0), t_enu_to_map_quat_wxyz=(1.0, 0.0, 0.0, 0.0))
        save_mm_file(args.output, mm)
        print(f"point layers rewritten in ENU frame; wrote {args.output}")
        return 0

    # default: print
    if mm.georeferencing is None:
        print("map has no georeferencing")
    else:
        g = mm.georeferencing
        print(f"lat={g.latitude} lon={g.longitude} h={g.height} "
              f"t_enu_to_map={g.t_enu_to_map_xyz}")
    return 0


def map_to_enu_rows(layer, georef) -> torch.Tensor:
    """The layer's valid rows in the ENU frame, (p - t) @ R in float64 on
    the layer's device (geodesy.map_to_enu's R and t), rounded to float32;
    the padding rows as they were."""
    from mp2p_icp_tpu_torch.core import geodesy
    from mp2p_icp_tpu_torch.core.se3 import matmul3

    dev = layer.xyz.device
    R = torch.from_numpy(geodesy._quat_to_rot(georef.t_enu_to_map_quat_wxyz)).to(dev)
    t = torch.tensor(georef.t_enu_to_map_xyz, dtype=torch.float64, device=dev)
    enu = matmul3(layer.xyz.to(torch.float64) - t, R).to(torch.float32)
    return torch.where(layer.valid_mask()[:, None], enu, layer.xyz)


if __name__ == "__main__":
    sys.exit(main())
