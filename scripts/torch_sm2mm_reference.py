#!/usr/bin/env python3
"""The JAX package's results for the sm2mm and YAML phases of chip_smoke.py, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/torch_sm2mm_reference.py [--keyframes N]
        [--rings R --azimuths A] [--port] [--only sm2mm|yaml] [--write FILE]

Runs the JAX package on the inputs of chip_smoke.py's two phases and
prints one JSON object with the constants that chip_smoke.py holds the
port against; ``--write`` also writes it to a file, and chip_smoke.py reads
``scripts/torch_sm2mm_reference.json``, written so with the defaults:

- "sm2mm": the first ``chip_smoke.SM2MM_KEYFRAMES`` frames of the street
  drive with their moving boxes (``chip_smoke.sm2mm_inputs``) through
  demos/sm2mm_voxelmap_static_dynamic.yaml, "pass 1" as the file stands and
  "pass 2" with the precise deskew (``chip_smoke.sm2mm_config(True)``) on
  keyframes that carry IMU samples and a velocity buffer; each summarised
  by ``chip_smoke.sm2mm_summary``;
- "yaml": the bench street pair through icp-settings-kitti.yaml (its
  FirstPoint section on both scans, from the identity) and
  icp-settings-example1.yaml (its two ClosestToAverage sections, on
  ``chip_smoke.example1_pair``, from the identity), the 9 planar range
  scans (``chip_smoke.planar_range_pairs``) decoded by the 2D demo's
  generators and aligned by its ICP, and frame 0 of the drive through
  ``chip_smoke.ALL_FILTERS_YAML`` (``chip_smoke.layer_summary`` per layer).

``--port`` also runs the port on the CPU on the same inputs and prints its
results in the same form (a preview of the chip's run; its plain kNN and
float arithmetic). Smaller drives (``--keyframes``, ``--rings``,
``--azimuths``) are for trying the script; chip_smoke.py's constants come
from the defaults. The JAX package's voxel lookup compares every map row
with every voxel record, so each sm2mm pass spends ~3 min of a CPU in its
final filter (2^20 rows x 65536 records).

This script is not part of the port: it imports both packages. JAX runs on
the CPU (set JAX_PLATFORMS=cpu).
"""

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import yaml  # noqa: E402

import chip_smoke  # noqa: E402
import mp2p_icp_tpu_torch  # noqa: E402
from mp2p_icp_tpu.core import se3 as jse3  # noqa: E402
from mp2p_icp_tpu.core.metric_map import MetricMap as JMetricMap  # noqa: E402
from mp2p_icp_tpu.core.pointcloud import PointCloud as JPointCloud  # noqa: E402
from mp2p_icp_tpu.filters import apply_filter_pipeline as japply  # noqa: E402
from mp2p_icp_tpu.filters.generator import Observation as JObservation  # noqa: E402
from mp2p_icp_tpu.filters.generator import apply_generators as japply_generators  # noqa: E402
from mp2p_icp_tpu.filters.sm2mm import Keyframe as JKeyframe  # noqa: E402
from mp2p_icp_tpu.filters.sm2mm import SimpleMap as JSimpleMap  # noqa: E402
from mp2p_icp_tpu.filters.sm2mm import simplemap_to_metricmap as jsm2mm  # noqa: E402
from mp2p_icp_tpu.pipeline.yaml_loader import filter_pipeline_from_yaml as jfilters  # noqa: E402
from mp2p_icp_tpu.pipeline.yaml_loader import load_icp_config_file as jload  # noqa: E402
from mp2p_icp_tpu_torch.eval.lidar_sim import make_scene, make_street_sequence  # noqa: E402

DEMOS = chip_smoke.DEMOS


def summary(termination, iterations, quality, log):
    return {"termination": chip_smoke.IterTermReason(int(termination)).name,
            "iterations": int(iterations), "quality": float(quality),
            "log": [float(x) for x in np.asarray(log)]}


def drive(args):
    """chip_smoke.py's street drive (its frames draw on one generator in
    turn, so the first keyframes depend on the drive's length)."""
    return make_street_sequence(max(args.keyframes, chip_smoke.ODO_FRAMES), n_rings=args.rings,
                                n_azimuth=args.azimuths)


def run_sm2mm(args, port=False):
    gt, twists, scans = drive(args)
    out = {}
    for label, precise in (("pass 1", False), ("pass 2", True)):
        inputs = chip_smoke.sm2mm_inputs(gt, twists, scans, precise=precise,
                                         n_keyframes=args.keyframes)
        t0 = time.perf_counter()
        if port:
            sm, cfg = chip_smoke.sm2mm_build(inputs, precise)
            from mp2p_icp_tpu_torch.filters.sm2mm import simplemap_to_metricmap

            layers = simplemap_to_metricmap(sm, cfg).layers
        else:
            sm = JSimpleMap([JKeyframe(
                pose=jse3.Pose(jnp.asarray(T[:3, :3], jnp.float32),
                               jnp.asarray(T[:3, 3], jnp.float32)),
                twist=tw, observations=[JObservation(**o) for o in obs])
                for T, tw, obs in inputs])
            layers = jsm2mm(sm, chip_smoke.sm2mm_config(precise)).layers
        out[label] = chip_smoke.sm2mm_summary(chip_smoke.sm2mm_numpy(layers))
        out[label]["seconds"] = time.perf_counter() - t0
        print(f"[sm2mm] {label}: {out[label]['seconds']:.1f} s", file=sys.stderr)
    return out


def run_yaml(args, port=False):
    if port:
        from mp2p_icp_tpu_torch.core import se3
        from mp2p_icp_tpu_torch.core.metric_map import MetricMap
        from mp2p_icp_tpu_torch.core.pointcloud import PointCloud
        from mp2p_icp_tpu_torch.filters import apply_filter_pipeline as apply
        from mp2p_icp_tpu_torch.filters.generator import Observation, apply_generators
        from mp2p_icp_tpu_torch.pipeline import filter_pipeline_from_yaml as filters_of
        from mp2p_icp_tpu_torch.pipeline import load_icp_config_file as load

        cloud = PointCloud.from_numpy
    else:
        se3, MetricMap, apply, filters_of, load = jse3, JMetricMap, japply, jfilters, jload
        Observation, apply_generators = JObservation, japply_generators

        cloud = JPointCloud.from_numpy

    def result(res):
        return summary(res.termination_reason, res.n_iterations, res.quality,
                       se3.log(res.optimal_tf))

    loc, glob = chip_smoke.street_pair(make_scene(np.random.RandomState(0)), 1, 2)
    loc = {"raw": cloud(loc["raw"].xyz.numpy())}
    glob = {"raw": cloud(glob["raw"].xyz.numpy())}
    out = {}
    icp, params, sections = load(str(DEMOS / "icp-settings-kitti.yaml"))
    out["kitti"] = result(icp.align(apply(sections["filters"], loc),
                                    apply(sections["filters"], glob), se3.identity(), params))
    icp, params, sections = load(str(DEMOS / "icp-settings-example1.yaml"))
    l1, g1 = chip_smoke.example1_pair(make_scene(np.random.RandomState(0)))
    fl = apply(sections["filters_local_map"], {"raw": cloud(l1)})
    fg = apply(sections["filters_global_map"], {"raw": cloud(g1)})
    out["example1"] = dict(result(icp.align(fl, fg, se3.identity(), params)),
                           local_decimated=int(fl["decimated"].count),
                           global_decimated=int(fg["decimated"].count))
    icp, params, sections = load(str(DEMOS / "icp-settings-2d-lidar-point2line.yaml"))
    out["planar"] = []
    for g, l, rel in chip_smoke.planar_range_pairs():
        maps = []
        for ranges in (l, g):
            mm = MetricMap()
            apply_generators(sections["generators"],
                             Observation(**chip_smoke.planar_observation(ranges)), mm)
            maps.append(mm.layers)
        out["planar"].append(result(icp.align(maps[0], maps[1], se3.from_xyz_ypr(
            *chip_smoke.planar_guess(rel)), params)))
    _, _, scans = drive(args)
    v = scans[0]["valid"]
    frame = {"raw": cloud(scans[0]["xyz"][v], capacity=1 << 16,
                          **{ch: scans[0][ch][v] for ch in ("intensity", "ring", "time")})}
    layers = apply(filters_of(yaml.safe_load(chip_smoke.ALL_FILTERS_YAML)["filters"]), frame)
    out["filters"] = {name: chip_smoke.layer_summary(ly) for name, ly in
                      chip_smoke.layers_numpy(layers).items() if name != "voxelmap"}
    out["filters"]["voxelmap"] = None
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--keyframes", type=int, default=chip_smoke.SM2MM_KEYFRAMES)
    ap.add_argument("--rings", type=int, default=48)
    ap.add_argument("--azimuths", type=int, default=768)
    ap.add_argument("--port", action="store_true", help="also run the port on the CPU")
    ap.add_argument("--only", choices=("sm2mm", "yaml"))
    ap.add_argument("--write", help="also write the JAX package's JSON object to this file")
    args = ap.parse_args()
    mp2p_icp_tpu_torch.set_default_device("cpu")  # the port prepares the inputs
    for port in (False, True) if args.port else (False,):
        t0 = time.perf_counter()
        out = {"package": ("mp2p_icp_tpu_torch on the CPU (plain kNN)" if port
                           else "mp2p_icp_tpu (JAX) on the CPU")}
        if args.only != "yaml":
            out["sm2mm"] = run_sm2mm(args, port)
        if args.only != "sm2mm":
            out["yaml"] = run_yaml(args, port)
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out))
        if args.write and not port:
            pathlib.Path(args.write).write_text(json.dumps(out, indent=1) + "\n")


if __name__ == "__main__":
    main()
