#!/usr/bin/env python3
"""The JAX package's result for the odometry run of chip_smoke.py, on the CPU.

    python3 scripts/torch_odometry_reference.py [--frames N] [--port] [--fleet]

Builds the street drive with the port's simulator
(``mp2p_icp_tpu_torch.eval.lidar_sim.make_street_sequence``: the frames
chip_smoke.py feeds the port), runs the JAX package's ``OdometryMapper`` on
them in the configuration of bench.py:621-683 (48 rings x 768 azimuths, raw
capacity 2^16, FirstPoint at 0.5 m into 6144 rows, a 2^15-row voxel-hash map
cropped to 2^14, stored-normal point-to-plane + Gauss-Newton, k=8 normals
fit of the new voxels, motion-model guess at dt = 0.1), and prints the
constants that chip_smoke.py holds the port against: ATE, map points, ICP
iterations per frame. ``--port`` also runs the port on the CPU (its plain
kNN) on the same frames, for a preview of the comparison. ``--fleet`` runs,
instead of the whole drive, the 8 streams of the fleet phase (stream b =
frames [2b, 2b + 20) of the drive, bench.py:738-752) one after another
through the JAX package's ``OdometryMapper.run`` and prints the constants
``FLEET_JAX`` (per stream: ATE, map points, mean iterations); the JAX
package's own test holds its batched run to these sequential runs.

This script is not part of the port: it imports both packages. JAX runs on
the CPU (set JAX_PLATFORMS=cpu).
"""

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from mp2p_icp_tpu.core import se3 as jse3  # noqa: E402
from mp2p_icp_tpu.core.pointcloud import PointCloud as JPointCloud  # noqa: E402
from mp2p_icp_tpu.filters.decimate_voxels import FilterDecimateVoxels as JDecimate  # noqa: E402
from mp2p_icp_tpu.filters.deskew import FilterDeskew as JDeskew  # noqa: E402
from mp2p_icp_tpu.icp import ICP as JICP  # noqa: E402
from mp2p_icp_tpu.icp import ICPParameters as JICPParameters  # noqa: E402
from mp2p_icp_tpu.matchers.base import LayerMatch as JLayerMatch  # noqa: E402
from mp2p_icp_tpu.matchers.point2plane import MatcherPoint2Plane as JPoint2Plane  # noqa: E402
from mp2p_icp_tpu.odometry import OdometryMapper as JOdometryMapper  # noqa: E402
from mp2p_icp_tpu.solvers.gauss_newton import GNParams as JGNParams  # noqa: E402
from mp2p_icp_tpu.solvers.solver import SolverGaussNewton as JGaussNewton  # noqa: E402
from mp2p_icp_tpu_torch.eval.lidar_sim import make_street_sequence  # noqa: E402
from mp2p_icp_tpu_torch.eval.trajectory import ate_rmse  # noqa: E402

DT = 0.1
FLEET_B, FLEET_STRIDE = 8, 2  # bench.py:738-745: stream b starts at frame 2 b


def jax_mapper(iterations):
    """bench.py:621-683 with its defaults; ``iterations`` collects the ICP
    iteration count of every align through a host callback."""
    icp = JICP(
        matchers=[JPoint2Plane(distance_threshold=1.5, use_point_normals=True,
                               layer_matches=(JLayerMatch(global_layer="map",
                                                          local_layer="decimated"),))],
        solvers=[JGaussNewton(gn_params=JGNParams(max_iterations=3))],
    )
    align_core = icp._align_core

    def counted(*args, **kwargs):
        res = align_core(*args, **kwargs)
        jax.debug.callback(lambda n: iterations.append(int(n)), res.n_iterations)
        return res

    icp._align_core = counted
    return JOdometryMapper(
        icp=icp,
        params=JICPParameters(max_iterations=30, crop_capacity=1 << 14, crop_extra_margin=3.0),
        filters=[
            JDeskew(input_pointcloud_layer="raw", output_pointcloud_layer="deskewed"),
            JDecimate(input_pointcloud_layer=("deskewed",), output_pointcloud_layer="decimated",
                      voxel_filter_resolution=0.5, output_capacity=6144),
        ],
        incremental_map_resolution=0.5,
        normals_knn=8, normals_radius=1.5, normals_query_capacity=2048,
        local_layer="decimated", map_layer="map", map_capacity=1 << 15,
    )


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=36)
    ap.add_argument("--port", action="store_true", help="also run the port on the CPU")
    ap.add_argument("--fleet", action="store_true",
                    help="run the fleet phase's 8 streams instead of the whole drive")
    args = ap.parse_args()

    gt, twists, scans = make_street_sequence(args.frames)
    frames = [{"raw": JPointCloud.from_numpy(
        s["xyz"][s["valid"]], capacity=1 << 16, intensity=s["intensity"][s["valid"]],
        ring=s["ring"][s["valid"]], time=s["time"][s["valid"]])} for s in scans]
    pose0 = jse3.Pose(jnp.asarray(gt[0, :3, :3], jnp.float32),
                      jnp.asarray(gt[0, :3, 3], jnp.float32))
    iterations = []
    if args.fleet:
        n = args.frames - FLEET_B * FLEET_STRIDE
        mapper, streams = jax_mapper(iterations), []
        for b in range(FLEET_B):
            o = FLEET_STRIDE * b
            del iterations[:]
            t0 = time.perf_counter()
            run = mapper.run(frames[o:o + n], twists=twists[o:o + n], dt=DT,
                             initial_pose=jse3.Pose(jnp.asarray(gt[o, :3, :3], jnp.float32),
                                                    jnp.asarray(gt[o, :3, 3], jnp.float32)))
            jax.effects_barrier()
            streams.append({
                "ate_m": ate_rmse(run["poses"], gt[o:o + n]),
                "map_points": int(run["map"].count),
                "iterations_mean": float(np.mean(iterations)),
                "iterations_per_frame": list(iterations),
                "seconds": time.perf_counter() - t0,
            })
        print(json.dumps({"package": "mp2p_icp_tpu (JAX) on " + jax.devices()[0].platform,
                          "frames_per_stream": n, "streams": streams}))
        return
    t0 = time.perf_counter()
    run = jax_mapper(iterations).run(frames, twists=twists, dt=DT, initial_pose=pose0)
    jax.effects_barrier()
    out = {
        "package": "mp2p_icp_tpu (JAX) on " + jax.devices()[0].platform,
        "frames": args.frames,
        "ate_m": ate_rmse(run["poses"], gt),
        "map_points": int(run["map"].count),
        "iterations_per_frame": iterations,
        "iterations_mean": float(np.mean(iterations)),
        "quality_min": float(run["qualities"].min()),
        "seconds": time.perf_counter() - t0,
    }
    print(json.dumps(out))

    if args.port:
        import mp2p_icp_tpu_torch
        import chip_smoke

        mp2p_icp_tpu_torch.set_default_device("cpu")
        frames_t = chip_smoke.odometry_frames(scans)
        t0 = time.perf_counter()
        run_t = chip_smoke.odometry_mapper().run(
            frames_t, twists=twists, dt=DT, initial_pose=chip_smoke.pose_of(gt[0]))
        print(json.dumps({
            "package": "mp2p_icp_tpu_torch on the CPU (plain kNN)",
            "ate_m": ate_rmse(run_t["poses"], gt),
            "map_points": int(run_t["map"].count),
            "iterations_per_frame": run_t["iterations"].tolist(),
            "pose_gap_to_jax_m": float(np.abs(run_t["poses"][:, :3, 3]
                                              - run["poses"][:, :3, 3]).max()),
            "seconds": time.perf_counter() - t0,
        }))


if __name__ == "__main__":
    main()
