"""txt2mm: a CSV/TXT point cloud to a metric map.

Port of ``mp2p_icp_tpu/apps/txt2mm.py`` (reference: apps/txt2mm/main.cpp):
formats xyz / xyzi / xyzirt / xyzrgb (rgb folded into the intensity as
luminance, 0.299 r + 0.587 g + 0.114 b).

Usage:
  python -m mp2p_icp_tpu_torch.apps.txt2mm -i points.txt -o map.mm.npz \\
      [-f xyz|xyzi|xyzirt|xyzrgb] [--layer raw] [--label TEXT] [--id N] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from mp2p_icp_tpu_torch.apps import add_device_argument, on_device


def main(argv=None):
    ap = argparse.ArgumentParser(prog="txt2mm")
    ap.add_argument("-i", "--input", required=True)
    ap.add_argument("-o", "--output", required=True, help=".mm.npz output")
    ap.add_argument("-f", "--format", default="xyz", choices=["xyz", "xyzi", "xyzirt", "xyzrgb"])
    ap.add_argument("--layer", default="raw")
    ap.add_argument("--label", default=None)
    ap.add_argument("--id", type=int, default=None)
    add_device_argument(ap)
    args = ap.parse_args(argv)

    from mp2p_icp_tpu_torch.core.metric_map import MetricMap
    from mp2p_icp_tpu_torch.core.pointcloud import PointCloud
    from mp2p_icp_tpu_torch.io.mm import save_mm_file

    data = np.loadtxt(args.input, dtype=np.float32, ndmin=2)
    cols = {"xyz": 3, "xyzi": 4, "xyzirt": 6, "xyzrgb": 6}[args.format]
    if data.shape[1] < cols:
        raise SystemExit(f"error: format {args.format} needs {cols} columns, "
                         f"file has {data.shape[1]}")
    kw = {}
    if args.format == "xyzi":
        kw["intensity"] = data[:, 3]
    elif args.format == "xyzirt":
        kw["intensity"] = data[:, 3]
        kw["ring"] = data[:, 4]
        kw["time"] = data[:, 5]
    elif args.format == "xyzrgb":
        kw["intensity"] = 0.299 * data[:, 3] + 0.587 * data[:, 4] + 0.114 * data[:, 5]
    with on_device(args.device) as device:
        mm = MetricMap(id=args.id, label=args.label)
        mm.layers[args.layer] = PointCloud.from_numpy(data[:, :3], device=device, **kw)
        save_mm_file(args.output, mm)
        print(f"wrote {args.output}: {mm.contents_summary()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
