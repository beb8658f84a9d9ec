"""sm2mm: build a metric map from a simple (keyframe) map file.

Port of ``mp2p_icp_tpu/apps/sm2mm_app.py`` (reference: apps/sm2mm/main.cpp:153):
the YAML pipeline (generators, filters, final_filters) over the keyframes
of an .sm.npz, an index range to resume from, the map written as .mm.npz.

Usage:
  python -m mp2p_icp_tpu_torch.apps.sm2mm_app -i map.sm.npz -o map.mm.npz -p pipeline.yaml \\
      [--from-index I] [--to-index J] [-v] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import yaml

from mp2p_icp_tpu_torch.apps import add_device_argument, on_device


def main(argv=None):
    ap = argparse.ArgumentParser(prog="sm2mm")
    ap.add_argument("-i", "--input", required=True, help=".sm.npz simple map")
    ap.add_argument("-o", "--output", required=True, help=".mm.npz output")
    ap.add_argument("-p", "--pipeline", required=True, help="YAML pipeline")
    ap.add_argument("--from-index", type=int, default=0)
    ap.add_argument("--to-index", type=int, default=None)
    ap.add_argument("-v", "--verbose", action="store_true")
    add_device_argument(ap)
    args = ap.parse_args(argv)

    from mp2p_icp_tpu_torch.filters.sm2mm import SimpleMap, Sm2MmOptions, simplemap_to_metricmap
    from mp2p_icp_tpu_torch.io.mm import save_mm_file

    with on_device(args.device) as device:
        sm = SimpleMap.load(args.input, device=device)
        with open(args.pipeline) as f:
            cfg = yaml.safe_load(f)
        mm = simplemap_to_metricmap(sm, cfg, Sm2MmOptions(
            start_index=args.from_index, end_index=args.to_index, verbose=args.verbose))
        save_mm_file(args.output, mm)
        print(f"wrote {args.output}: {mm.contents_summary()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
