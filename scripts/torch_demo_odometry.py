#!/usr/bin/env python3
"""End-to-end demo of the port: spinning-LiDAR odometry -> interactive HTML map.

    python3 scripts/torch_demo_odometry.py [out.html] [--frames N] [--device cuda|cpu]

The twin of ``scripts/demo_odometry.py`` over the PyTorch port: a synthetic
spinning-scanner street sequence (``eval/lidar_sim``) through
``odometry.OdometryMapper`` (deskew with IMU-grade twists, voxel
decimation, scan-to-map point-to-plane align against the accumulated map,
the merge and the map's FirstPoint maintenance), then the final map and
the estimated trajectory as one standalone WebGL page
(``apps/html_viewer.export_map_html``) that any browser opens.

``--device`` as the apps have it: the card unless ``cpu`` is asked for (the
plain kNN, slow at the 32 x 768 rays of a sweep). Imports torch, numpy and
the port; nothing of JAX.
"""

import argparse
import pathlib
import sys
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from mp2p_icp_tpu_torch.apps.html_viewer import export_map_html  # noqa: E402
from mp2p_icp_tpu_torch.core import se3  # noqa: E402
from mp2p_icp_tpu_torch.core.metric_map import MetricMap  # noqa: E402
from mp2p_icp_tpu_torch.device import resolve  # noqa: E402
from mp2p_icp_tpu_torch.eval.lidar_sim import (  # noqa: E402
    make_street_scene,
    render_spinning_scan,
    scan_to_pointcloud,
)
from mp2p_icp_tpu_torch.eval.trajectory import ate_rmse  # noqa: E402
from mp2p_icp_tpu_torch.filters import FilterDecimateVoxels, FilterDeskew  # noqa: E402
from mp2p_icp_tpu_torch.icp import ICP, ICPParameters  # noqa: E402
from mp2p_icp_tpu_torch.matchers import LayerMatch, MatcherPoint2Plane  # noqa: E402
from mp2p_icp_tpu_torch.odometry import OdometryMapper  # noqa: E402
from mp2p_icp_tpu_torch.solvers.gauss_newton import GNParams  # noqa: E402
from mp2p_icp_tpu_torch.solvers.solver import SolverGaussNewton  # noqa: E402

DT = 0.1
RINGS, AZIMUTHS = 32, 768  # rays of a sweep, as scripts/demo_odometry.py renders them


def street_sequence(n, n_rings, n_azimuth, device):
    """``scripts/demo_odometry.py``'s drive: poses [n, 4, 4], twists with 3%
    noise, frames {"raw": PointCloud} on ``device``."""
    rng = np.random.RandomState(7)
    scene = make_street_scene(rng, length=200.0, n_pillars=50)
    poses = [se3.from_xyz_ypr(12.0 + 8.0 * DT * i, 0.5 * np.sin(0.15 * i), 1.7,
                              0.05 * np.sin(0.2 * i), 0.0, 0.0, device="cpu") for i in range(n)]
    twists, frames = [], []
    for i in range(n):
        j = min(i + 1, n - 1)
        rel = se3.compose(se3.inverse(poses[i]), poses[j])
        tw = se3.log(rel).numpy().astype(np.float64) / DT if i < n - 1 else twists[-1]
        twists.append(np.asarray(tw * (1 + 0.03 * rng.randn(6)), np.float32))
        scan = render_spinning_scan(scene, poses[i], twists[i], rng, n_rings=n_rings,
                                    n_azimuth=n_azimuth)
        frames.append({"raw": scan_to_pointcloud(scan, capacity=1 << 16, device=device)})
    gt = np.tile(np.eye(4), (n, 1, 1))
    for i, p in enumerate(poses):
        gt[i, :3, :3] = p.R.numpy()
        gt[i, :3, 3] = p.t.numpy()
    return gt, twists, frames


def demo_mapper() -> OdometryMapper:
    """``scripts/demo_odometry.py``'s mapper."""
    return OdometryMapper(
        icp=ICP(matchers=[MatcherPoint2Plane(
            distance_threshold=1.5, knn=6,
            layer_matches=(LayerMatch(global_layer="map", local_layer="decimated"),))],
            solvers=[SolverGaussNewton(gn_params=GNParams(max_iterations=3))]),
        params=ICPParameters(max_iterations=30, crop_capacity=1 << 14, crop_extra_margin=3.0),
        filters=[FilterDeskew(input_pointcloud_layer="raw", output_pointcloud_layer="deskewed"),
                 FilterDecimateVoxels(input_pointcloud_layer=("deskewed",),
                                      output_pointcloud_layer="decimated",
                                      voxel_filter_resolution=0.5, output_capacity=6144)],
        map_filters=[FilterDecimateVoxels(input_pointcloud_layer=("map",),
                                          output_pointcloud_layer="map",
                                          voxel_filter_resolution=0.5,
                                          output_capacity=1 << 15)],
        map_capacity=1 << 15,
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", nargs="?", default="odometry_demo.html")
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the card (default) or the CPU")
    args = ap.parse_args(argv)
    device = resolve(args.device)
    n = args.frames
    print(f"rendering {n} spinning sweeps of {RINGS} x {AZIMUTHS} rays...", flush=True)
    gt, twists, frames = street_sequence(n, RINGS, AZIMUTHS, device)
    pose0 = se3.from_matrix(torch.as_tensor(gt[0], dtype=torch.float32, device=device))
    print(f"running the odometry loop on {device}...", flush=True)
    t0 = time.perf_counter()
    out = demo_mapper().run(frames, twists=twists, dt=DT, initial_pose=pose0)
    ate = ate_rmse(out["poses"], gt)
    n_map = int(out["map"].count)
    print(f"{n} frames in {time.perf_counter() - t0:.1f}s ({out['scans_per_s']:.1f} scans/s "
          f"steady), ATE {ate:.3f} m, map {n_map} points", flush=True)
    export_map_html(MetricMap(layers={"map": out["map"]}), args.out,
                    trajectory=out["poses"][:, :3, 3],
                    title=f"odometry demo — {n} frames, ATE {ate:.3f} m")
    print(f"wrote {args.out} — open in any browser")
    return 0


if __name__ == "__main__":
    sys.exit(main())
