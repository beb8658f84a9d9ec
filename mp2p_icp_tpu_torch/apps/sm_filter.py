"""sm-filter: apply generators + filters to every keyframe of a simple map,
writing a processed simple map.

Port of ``mp2p_icp_tpu/apps/sm_filter.py`` (reference analogue:
apps/rawlog-filter over a keyframe map). Each point observation of each
keyframe goes through the generators and the filter pipeline (on the
device); the chosen output layer, cut to its valid rows, replaces the
observation. An observation without points, or whose pipeline leaves no
such layer, stays as it was.

Usage:
  python -m mp2p_icp_tpu_torch.apps.sm_filter -i in.sm.npz -o out.sm.npz -p pipeline.yaml \\
      [--output-layer raw] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import yaml

from mp2p_icp_tpu_torch.apps import add_device_argument, on_device


def main(argv=None):
    ap = argparse.ArgumentParser(prog="sm-filter")
    ap.add_argument("-i", "--input", required=True, help=".sm.npz input")
    ap.add_argument("-o", "--output", required=True, help=".sm.npz output")
    ap.add_argument("-p", "--pipeline", required=True,
                    help="YAML with generators/filters sections")
    ap.add_argument("--output-layer", default="raw",
                    help="layer written back as the processed observation")
    add_device_argument(ap)
    args = ap.parse_args(argv)

    from mp2p_icp_tpu_torch.core.metric_map import MetricMap
    from mp2p_icp_tpu_torch.filters import apply_filter_pipeline
    from mp2p_icp_tpu_torch.filters.generator import (
        Observation,
        apply_generators,
        generators_from_yaml,
    )
    from mp2p_icp_tpu_torch.filters.sm2mm import SimpleMap
    from mp2p_icp_tpu_torch.io.mm import to_numpy
    from mp2p_icp_tpu_torch.pipeline import filter_pipeline_from_yaml

    with open(args.pipeline) as f:
        cfg = yaml.safe_load(f)
    generators = generators_from_yaml(cfg.get("generators"))
    filters = filter_pipeline_from_yaml(cfg.get("filters"))

    with on_device(args.device) as device:
        sm = SimpleMap.load(args.input, device=device)
        n_pts_in = n_pts_out = 0
        for kf in sm.keyframes:
            new_obs = []
            for obs in kf.observations:
                if obs.xyz is None:
                    new_obs.append(obs)
                    continue
                n_pts_in += obs.xyz.shape[0]
                mm = MetricMap()
                apply_generators(generators, obs, mm)
                apply_filter_pipeline(filters, mm)
                layer = mm.layers.get(args.output_layer)
                if layer is None:
                    new_obs.append(obs)
                    continue
                n = int(layer.count)
                n_pts_out += n

                def trim(ch):
                    return None if ch is None else to_numpy(ch[:n])

                new_obs.append(Observation(
                    class_name=obs.class_name, sensor_label=obs.sensor_label,
                    timestamp=obs.timestamp, xyz=layer.to_numpy(),
                    intensity=trim(layer.intensity), ring=trim(layer.ring),
                    time=trim(layer.time)))
            kf.observations = new_obs
        sm.save(args.output)
    print(f"wrote {args.output}: {len(sm.keyframes)} keyframes, "
          f"{n_pts_in} -> {n_pts_out} points")
    return 0


if __name__ == "__main__":
    sys.exit(main())
