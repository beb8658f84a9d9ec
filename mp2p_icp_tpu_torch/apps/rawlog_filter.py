"""rawlog-filter: apply generators + a filter pipeline to an observation
stream, writing a processed stream.

Port of ``mp2p_icp_tpu/apps/rawlog_filter.py`` (reference:
apps/rawlog-filter/main.cpp:36-245): for each observation in [--from,
--to], the generators fill a fresh metric map (an observation no generator
handles is skipped), the filter pipeline runs on it (on the device), and
one sensory frame is written: the ORIGINAL observation plus one point-cloud
observation per output point layer, labelled ``out_<layer>``, in sorted
layer order, each cut to its valid rows. The twist and robot-pose
variables are zero, declared before the pipeline is parsed
(main.cpp:141-152), so ``$f{}`` parameters may name them. The container
is the ``.rawlog.npz`` of io/rawlog.py.

Usage:
  python -m mp2p_icp_tpu_torch.apps.rawlog_filter -i in.rawlog.npz -o out.rawlog.npz \\
      -p pipeline.yaml [--from I] [--to J] [-v QUIET] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import yaml

from mp2p_icp_tpu_torch.apps import add_device_argument, on_device

ZERO_VARIABLES = ("vx", "vy", "vz", "wx", "wy", "wz", "robot_x", "robot_y", "robot_z",
                  "robot_yaw", "robot_pitch", "robot_roll")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="rawlog-filter")
    ap.add_argument("-i", "--input", required=True, help=".rawlog.npz input")
    ap.add_argument("-o", "--output", required=True, help=".rawlog.npz output")
    ap.add_argument("-p", "--pipeline", required=True,
                    help="YAML with generators:/filters: sections")
    ap.add_argument("--from", dest="from_index", type=int, default=0,
                    help="first observation index to process")
    ap.add_argument("--to", dest="to_index", type=int, default=None,
                    help="last observation index to process")
    ap.add_argument("-v", "--verbosity", default="INFO")
    add_device_argument(ap)
    args = ap.parse_args(argv)

    from mp2p_icp_tpu_torch.core.metric_map import MetricMap
    from mp2p_icp_tpu_torch.core.pointcloud import PointCloud
    from mp2p_icp_tpu_torch.filters import apply_filter_pipeline
    from mp2p_icp_tpu_torch.filters.generator import apply_generators, generators_from_yaml
    from mp2p_icp_tpu_torch.io.rawlog import Rawlog, pointcloud_to_observation
    from mp2p_icp_tpu_torch.pipeline import filter_pipeline_from_yaml

    with open(args.pipeline) as f:
        cfg = yaml.safe_load(f) or {}
    if "generators" not in cfg:
        print("[rawlog-filter] Warning: no generators defined in the pipeline, using "
              "default generator.")
    generators = generators_from_yaml(cfg.get("generators"))
    if "filters" not in cfg:
        print("[rawlog-filter] Warning: no filters defined in the pipeline.")
    variables = {v: 0.0 for v in ZERO_VARIABLES}
    filters = filter_pipeline_from_yaml(cfg.get("filters"), variables)

    print(f"[rawlog-filter] Reading input rawlog from: '{args.input}'...")
    with on_device(args.device) as device:
        rl = Rawlog.load(args.input, device=device)
        print(f"[rawlog-filter] Done read dataset ({len(rl)} entries)")
        n = len(rl)
        last = min(n - 1, args.to_index) if args.to_index is not None else n - 1
        out = Rawlog()
        t0 = time.time()
        frame_id = 0
        for i in range(max(0, args.from_index), last + 1):
            obs = rl.observations[i]
            mm = MetricMap()
            if not apply_generators(generators, obs, mm):
                continue
            apply_filter_pipeline(filters, mm, variables)
            out.append(obs, frame=frame_id)
            for name in sorted(mm.layers):
                layer = mm.layers[name]
                if isinstance(layer, PointCloud):
                    out.append(pointcloud_to_observation(
                        layer, sensor_label=f"out_{name}", timestamp=obs.timestamp),
                        frame=frame_id)
            frame_id += 1
            if args.verbosity != "QUIET":
                pc = (i + 1 - args.from_index) / max(1, last + 1 - args.from_index)
                eta = (time.time() - t0) * (1 / pc - 1) if pc > 0 else 0.0
                print(f"\r{i + 1}/{last + 1} ({100 * pc:.1f}%) ETA={eta:.0f}s", end="",
                      flush=True)
        print()
    out.save(args.output)
    print(f"[rawlog-filter] Wrote '{args.output}' ({len(out)} entries)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
