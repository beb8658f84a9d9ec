"""mm-filter: apply a YAML filter pipeline to a metric map file.

Port of ``mp2p_icp_tpu/apps/mm_filter.py`` (reference:
apps/mm-filter/main.cpp:165, with its --rename-layer mode). Reads .mm.npz
or a binary .mm, writes .mm.npz.

Usage:
  python -m mp2p_icp_tpu_torch.apps.mm_filter -i in.mm -o out.mm.npz -p filters.yaml \\
      [--rename-layer OLD=NEW] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import yaml

from mp2p_icp_tpu_torch.apps import add_device_argument, on_device


def main(argv=None):
    ap = argparse.ArgumentParser(prog="mm-filter")
    ap.add_argument("-i", "--input", required=True)
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument("-p", "--pipeline", default=None, help="YAML filter file")
    ap.add_argument("--rename-layer", default=None, help="OLD=NEW")
    add_device_argument(ap)
    args = ap.parse_args(argv)

    from mp2p_icp_tpu_torch.filters import apply_filter_pipeline
    from mp2p_icp_tpu_torch.io.mm import load_mm_file, save_mm_file
    from mp2p_icp_tpu_torch.pipeline import filter_pipeline_from_yaml

    with on_device(args.device) as device:
        mm = load_mm_file(args.input, device=device)
        if args.rename_layer:
            old, new = args.rename_layer.split("=")
            if old not in mm.layers:
                raise SystemExit(f"error: no layer '{old}'")
            mm.layers[new] = mm.layers.pop(old)
        if args.pipeline:
            with open(args.pipeline) as f:
                cfg = yaml.safe_load(f)
            apply_filter_pipeline(filter_pipeline_from_yaml(
                cfg.get("filters", cfg) if isinstance(cfg, dict) else cfg), mm)
        save_mm_file(args.output, mm)
        print(f"wrote {args.output}: {mm.contents_summary()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
