#!/usr/bin/env python3
"""The JAX package's results for the engine phase of chip_smoke.py, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/torch_engine_reference.py [--points N] [--rays N] [--port]

Runs the JAX package on the inputs of chip_smoke.py's engine phase and
prints one JSON object with the constants that chip_smoke.py holds the
port against (``ENGINE_JAX``, ``PLANAR_JAX``):

- "engine": the bench street pair (``chip_smoke.street_pair``: 8192
  points, the local scan moved by the inverse of GT) with voxel grids of
  each scan at 0.2 m from its sensor, through the engine configuration
  (InlierRatio + OLAE, then Adaptive with planes + Gauss-Newton; the paired
  ratio, voxel and range-image qualities; the optimal scale of a Horn
  solver that never solves), without a hook and with a hook that stops at
  iteration 4;
- "planar": the 9 planar scan pairs of ``chip_smoke.planar_pairs`` (1081
  rays) through the 2D demo configuration, each from the motion-model
  guess ``chip_smoke.planar_guess``.

Per align: termination, iterations, quality, the SE(3) log of the pose (to
rebuild it) and, for the engine, the optimal scale.

The JAX package cannot run the engine configuration's quality in the
align: with a voxel layer in a dict map, its initial pairings build a
MatchState of every layer (mp2p_icp_tpu/icp.py:673-680 runs all matchers
in ``jax.eval_shape``), and a voxel layer has no capacity; a MetricMap
drops the voxel layer, and QualityVoxels then raises. So the align runs on
the point layers, and the three evaluators are applied to its final
pairings and pose after it, weighted alike, as ``ICP._quality_stack``
combines them. ``--port`` also runs
the port on the CPU (its plain kNN) on the same inputs and prints its
results beside them. ``jax_engine_icp`` / ``jax_point2line_icp`` are the
configurations of chip_smoke.py in the JAX package;
tests/test_torch_icp.py checks that convert builds chip_smoke.py's from
them.

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

import chip_smoke  # noqa: E402
import mp2p_icp_tpu_torch  # noqa: E402
from mp2p_icp_tpu.core import se3 as jse3  # noqa: E402
from mp2p_icp_tpu.core.metric_map import VoxelGridLayer as JVoxelGridLayer  # noqa: E402
from mp2p_icp_tpu.core.params import Expression as JExpression  # noqa: E402
from mp2p_icp_tpu.core.pointcloud import PointCloud as JPointCloud  # noqa: E402
from mp2p_icp_tpu.icp import ICP as JICP  # noqa: E402
from mp2p_icp_tpu.icp import ICPParameters as JICPParameters  # noqa: E402
from mp2p_icp_tpu.matchers import LayerMatch as JLayerMatch  # noqa: E402
from mp2p_icp_tpu.matchers import MatchContext as JMatchContext  # noqa: E402
from mp2p_icp_tpu.matchers import MatcherAdaptive as JAdaptive  # noqa: E402
from mp2p_icp_tpu.matchers import MatcherPointsDistanceThreshold as JDistance  # noqa: E402
from mp2p_icp_tpu.matchers.inlier_ratio import MatcherPointsInlierRatio as JInlier  # noqa: E402
from mp2p_icp_tpu.matchers.point2line import MatcherPoint2Line as JPoint2Line  # noqa: E402
from mp2p_icp_tpu.ops.voxel_occupancy import update_voxel_map as jupdate  # noqa: E402
from mp2p_icp_tpu.quality.paired_ratio import QualityPairedRatio as JPairedRatio  # noqa: E402
from mp2p_icp_tpu.quality.range_image import QualityRangeImageSimilarity as JRange  # noqa: E402
from mp2p_icp_tpu.quality.voxels import QualityVoxels as JVoxels  # noqa: E402
from mp2p_icp_tpu.solvers.gauss_newton import GNParams as JGNParams  # noqa: E402
from mp2p_icp_tpu.solvers.robust import RobustKernel as JRobustKernel  # noqa: E402
from mp2p_icp_tpu.solvers.solver import SolverGaussNewton as JGN  # noqa: E402
from mp2p_icp_tpu.solvers.solver import SolverHorn as JHorn  # noqa: E402
from mp2p_icp_tpu.solvers.solver import SolverOLAE as JOLAE  # noqa: E402


def jax_engine_icp():
    """chip_smoke.engine_icp in the JAX package."""
    return JICP(
        matchers=[
            JInlier(inliers_ratio=0.8, run_up_to_iteration=5),
            JAdaptive(enable_detect_planes=True, plane_search_points=8, confidence_interval=0.75,
                      first_to_second_distance_max=1.2,
                      absolute_max_search_distance=JExpression(chip_smoke.ENGINE_AMSD),
                      run_from_iteration=6),
        ],
        solvers=[
            JOLAE(run_up_to_iteration=5),
            JGN(run_from_iteration=6, gn_params=JGNParams(
                max_iterations=3, kernel=JRobustKernel.GEMAN_MCCLURE, kernel_param=0.15)),
            JHorn(estimate_scale=True, run_from_iteration=1000),
        ],
        quality_evaluators=[JPairedRatio(), JVoxels(), JRange()],
    )


def jax_point2line_icp():
    """chip_smoke.point2line_icp in the JAX package."""
    lm = (JLayerMatch(global_layer="2d_lidar", local_layer="2d_lidar"),)
    return JICP(
        matchers=[JPoint2Line(distance_threshold=0.25, knn=5, min_points_to_fit=4,
                              line_eigen_threshold=1e-2, layer_matches=lm),
                  JDistance(threshold=0.15, layer_matches=lm)],
        solvers=[JGN(gn_params=JGNParams(max_iterations=3))],
        quality_evaluators=[JPairedRatio()],
    )


def stop_hook(iteration, R, t, n_pairings):
    return iteration >= chip_smoke.ENGINE_HOOK_STOP


def jax_layers(xyz, capacity, voxel_capacity=None):
    """{"raw": cloud[, "voxelmap": grid from the sensor at the origin]}."""
    pc = JPointCloud.from_numpy(xyz, capacity=capacity)
    if voxel_capacity is None:
        return {"raw": pc}
    grid = jupdate(JVoxelGridLayer.empty(voxel_capacity, chip_smoke.ENGINE_VOXEL), pc.xyz,
                   pc.valid_mask(), jnp.zeros(3))
    return {"raw": pc, "voxelmap": grid}


def engine_inputs(n_points):
    """The engine phase's (local, global) numpy scans."""
    loc, glob = chip_smoke.street_pair(chip_smoke.make_scene(np.random.RandomState(0)), 1, 2,
                                       n=n_points)
    return loc["raw"].xyz.numpy(), glob["raw"].xyz.numpy()


def summary(res, scale=True):
    out = {
        "termination": chip_smoke.IterTermReason(int(res.termination_reason)).name,
        "iterations": int(res.n_iterations),
        "quality": float(res.quality),
        "log": [float(x) for x in np.asarray(jse3.log(res.optimal_tf))],
    }
    if scale:
        out["scale"] = float(res.optimal_scale)
    return out


def run_engine(n_points, voxel_capacity):
    loc, glob = engine_inputs(n_points)
    l_j = jax_layers(loc, n_points, voxel_capacity)
    g_j = jax_layers(glob, n_points, voxel_capacity)
    full = jax_engine_icp()
    # the align on the point layers; the quality stack after it (see above)
    icp = JICP(matchers=full.matchers, solvers=full.solvers)
    out = {}
    for label, hook in (("no hook", None), ("stopping hook", stop_hook)):
        res = icp.align({"raw": l_j["raw"]}, {"raw": g_j["raw"]}, jse3.identity(),
                        JICPParameters(max_iterations=40, record_iterations=True,
                                       record_pairings=True, iteration_hook=hook))
        ctx = JMatchContext(icp_iteration=res.n_iterations)
        q = [float(ev.evaluate(res.final_pairings, grids={}, global_map=g_j, local_map=l_j,
                               pose=res.optimal_tf, ctx=ctx).quality)
             for ev in full.quality_evaluators]
        out[label] = dict(summary(res), quality=float(np.mean(q)), qualities=q)
    return out


def run_planar(n_rays):
    icp = jax_point2line_icp()
    params = JICPParameters(max_iterations=100, min_abs_step_trans=1e-4, min_abs_step_rot=1e-4)
    out = []
    for g, loc, rel in chip_smoke.planar_pairs(n_rays):
        guess = jse3.from_xyz_ypr(*chip_smoke.planar_guess(rel))
        res = icp.align({"2d_lidar": JPointCloud.from_numpy(loc, capacity=n_rays)},
                        {"2d_lidar": JPointCloud.from_numpy(g, capacity=n_rays)}, guess, params)
        out.append(summary(res, scale=False))
    return out


def run_port_engine(n_points, voxel_capacity):
    """The port on the CPU on the engine inputs (a preview of chip_smoke.py's
    comparison)."""
    from mp2p_icp_tpu_torch.core import se3
    from mp2p_icp_tpu_torch.core.pointcloud import PointCloud

    loc, glob = engine_inputs(n_points)

    def layers(x):
        return chip_smoke.with_voxel_grid({"raw": PointCloud.from_numpy(x, capacity=n_points)},
                                          voxel_capacity)

    return {label: port_summary(chip_smoke.engine_icp().align(
        layers(loc), layers(glob), se3.identity(), chip_smoke.engine_params(None, hook)), se3)
        for label, hook in (("no hook", None), ("stopping hook", stop_hook))}


def run_port_planar(n_rays):
    """The port on the CPU on the planar pairs."""
    from mp2p_icp_tpu_torch.core import se3

    return [port_summary(chip_smoke.point2line_icp().align(
        chip_smoke.planar_layers(loc, n_rays), chip_smoke.planar_layers(g, n_rays),
        se3.from_xyz_ypr(*chip_smoke.planar_guess(rel)), chip_smoke.point2line_params()),
        se3, scale=False) for g, loc, rel in chip_smoke.planar_pairs(n_rays)]


def port_summary(res, se3, scale=True):
    out = {"termination": res.termination_reason.name, "iterations": res.n_iterations,
           "quality": float(res.quality), "log": se3.log(res.optimal_tf).tolist()}
    if scale:
        out["scale"] = float(res.optimal_scale)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--points", type=int, default=chip_smoke.N_POINTS)
    ap.add_argument("--voxel-capacity", type=int, default=chip_smoke.ENGINE_VOXEL_CAPACITY)
    ap.add_argument("--rays", type=int, default=chip_smoke.PLANAR_RAYS)
    ap.add_argument("--port", action="store_true", help="also run the port on the CPU")
    args = ap.parse_args()
    mp2p_icp_tpu_torch.set_default_device("cpu")  # the port prepares the inputs
    t0 = time.perf_counter()
    out = {"package": "mp2p_icp_tpu (JAX) on the CPU",
           "engine": run_engine(args.points, args.voxel_capacity),
           "planar": run_planar(args.rays)}
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out))
    if args.port:
        t0 = time.perf_counter()
        port = {"package": "mp2p_icp_tpu_torch on the CPU (plain kNN)",
                "engine": run_port_engine(args.points, args.voxel_capacity),
                "planar": run_port_planar(args.rays)}
        port["seconds"] = time.perf_counter() - t0
        print(json.dumps(port))


if __name__ == "__main__":
    main()
