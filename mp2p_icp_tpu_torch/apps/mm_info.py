"""mm-info: print a metric map's contents summary.

Port of ``mp2p_icp_tpu/apps/mm_info.py`` (reference: apps/mm-info/main.cpp:36-48).

Usage:
  python -m mp2p_icp_tpu_torch.apps.mm_info map.mm.npz [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

from mp2p_icp_tpu_torch.apps import add_device_argument, on_device


def main(argv=None):
    ap = argparse.ArgumentParser(prog="mm-info")
    ap.add_argument("input", help=".mm.npz metric map file")
    add_device_argument(ap)
    args = ap.parse_args(argv)

    from mp2p_icp_tpu_torch.io.mm import load_mm_file

    with on_device(args.device) as device:
        print(load_mm_file(args.input, device=device).contents_summary())
    return 0


if __name__ == "__main__":
    sys.exit(main())
