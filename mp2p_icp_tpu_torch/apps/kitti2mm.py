"""kitti2mm: a KITTI velodyne .bin scan to a metric map.

Port of ``mp2p_icp_tpu/apps/kitti2mm.py`` (reference: apps/kitti2mm/main.cpp:46-77).

Usage:
  python -m mp2p_icp_tpu_torch.apps.kitti2mm -i 000000.bin -o scan.mm.npz \\
      [--layer raw] [--id N] [--label TEXT] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

from mp2p_icp_tpu_torch.apps import add_device_argument, on_device


def main(argv=None):
    ap = argparse.ArgumentParser(prog="kitti2mm")
    ap.add_argument("-i", "--input", required=True, help="KITTI .bin file")
    ap.add_argument("-o", "--output", required=True, help=".mm.npz output")
    ap.add_argument("--layer", default="raw")
    ap.add_argument("--id", type=int, default=None)
    ap.add_argument("--label", default=None)
    add_device_argument(ap)
    args = ap.parse_args(argv)

    from mp2p_icp_tpu_torch.core.metric_map import MetricMap
    from mp2p_icp_tpu_torch.io.kitti import load_kitti_bin
    from mp2p_icp_tpu_torch.io.mm import save_mm_file

    with on_device(args.device) as device:
        mm = MetricMap(id=args.id, label=args.label)
        mm.layers[args.layer] = load_kitti_bin(args.input, device=device)
        save_mm_file(args.output, mm)
        print(f"wrote {args.output}: {mm.contents_summary()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
