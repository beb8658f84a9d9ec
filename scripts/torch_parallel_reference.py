#!/usr/bin/env python3
"""The JAX package's results for the parallel phases of chip_smoke.py, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/torch_parallel_reference.py [--write FILE]

Feeds the JAX package the inputs chip_smoke.py gives the port and prints
one JSON object of the constants chip_smoke.py holds the port against;
``--write`` also writes it to a file, and chip_smoke.py reads
``scripts/torch_parallel_reference.json``, written so with the defaults:

- "pose_graph": the lapping graph of ``chip_smoke.lap_graph`` (4,541 nodes,
  KITTI 00's length, 8 laps of a 75 m circle, 4,540 odometry and 398 loop
  edges): ``optimize_pose_graph_cg`` with ``chip_smoke.POSE_GRAPH_CG``
  ("cg": chi² before and after, every node's translation after), and
  ``optimize_pose_graph`` (``PoseGraphParams()``) on the 1,000-node graph
  of the same kind ("dense_small": the same values), both float32 as the
  JAX package computes;
- "loop_closure": kitti-odometry --mapping --loop-closure on
  ``chip_smoke.write_loop_sequence`` (48 frames of the out-and-back drive
  at 64 rings x 2048 azimuths) with ``chip_smoke.ground_cropped_yaml``,
  --map-capacity 2^18, --loop-min-gap 20, --loop-max-distance 5: the
  candidates (the JAX package's ``propose_loop_candidates`` on the
  odometry poses), the accepted loops (i, j, quality) and their measured
  relative poses (i, j, R row-major, t, quality), ATE and RPE before and
  after the closure, the odometry and the corrected poses;
- "spatial_mapper": ``SpatialOdometryMapper`` over 2 virtual CPU devices
  on the 36-frame street drive of chip_smoke.py's odometry phase, in its
  incremental configuration (``scripts/torch_odometry_reference.jax_mapper``):
  ATE, map points per shard and the union's voxel count;
- "data_space": the JAX package's multi-chip dry run
  (``__graft_entry__.dryrun_multichip(8)``'s first part): its 8 problems of
  256 points (``_make_problem``, seeds 0-7) through ``make_batched_align``
  with ``_make_icp`` and ``max_iterations=5``, every array of two or more
  axes placed with ``P("data", "space")`` on a 4 x 2 mesh of 8 virtual CPU
  devices, as ``__graft_entry__.py:94-118`` places them: each problem's R,
  t, iterations and termination. ``jax_data_space`` also runs other
  problems so (the CPU tests' shared map).

One substitution, as in scripts/torch_apps_reference.py: the cropped
YAML's decimated layer would keep the raw capacity of its input (131072
rows), and each of the JAX package's kNN sweeps at 131072^2 takes ~55 s
on a CPU; here its capacity is the next power of two above the largest
voxel count of the sequence's returns above the crop. The padding rows
take part in no pairing.

This script is not part of the port: it imports both packages. JAX runs on
the CPU (set JAX_PLATFORMS=cpu).
"""

import os

# eight virtual CPU devices for the data x space mesh (the sharded mapper
# takes two of them), before JAX starts
if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8").strip()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))
sys.path.insert(0, str(HERE))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402
from mp2p_icp_tpu_torch.core.pointcloud import round_capacity  # noqa: E402
from mp2p_icp_tpu_torch.eval.trajectory import load_kitti_poses  # noqa: E402

def log(msg):
    print(f"[reference] {msg}", file=sys.stderr, flush=True)


def jax_graph(n):
    from mp2p_icp_tpu.core.se3 import Pose
    from mp2p_icp_tpu.parallel.pose_graph import PoseGraphEdges

    gt, init, e = chip_smoke.lap_graph(n)
    poses = Pose(jnp.asarray(init[:, :3, :3], jnp.float32), jnp.asarray(init[:, :3, 3], jnp.float32))
    edges = PoseGraphEdges(i=jnp.asarray(e["i"], jnp.int32), j=jnp.asarray(e["j"], jnp.int32),
                           z=Pose(jnp.asarray(e["z_R"]), jnp.asarray(e["z_t"])),
                           information=jnp.asarray(e["information"]),
                           valid=jnp.asarray(e["valid"]))
    return gt, poses, edges


def chi2_of(poses, edges):
    from mp2p_icp_tpu.parallel.pose_graph import edge_residuals

    r = edge_residuals(poses, edges)[0]
    return float(jnp.sum(edges.valid * jnp.einsum("ea,eab,eb->e", r, edges.information, r)))


def run_pose_graph():
    from mp2p_icp_tpu.parallel.pose_graph import (
        PoseGraphCGParams,
        PoseGraphParams,
        optimize_pose_graph,
        optimize_pose_graph_cg,
    )

    out = {}
    cg = chip_smoke.POSE_GRAPH_CG
    for key, n in (("cg", chip_smoke.POSE_GRAPH_NODES), ("dense_small", chip_smoke.POSE_GRAPH_SMALL)):
        gt, poses, edges = jax_graph(n)
        t0 = time.perf_counter()
        if key == "cg":
            opt, chi2 = optimize_pose_graph_cg(poses, edges, PoseGraphCGParams(**cg))
        else:
            opt, chi2 = optimize_pose_graph(poses, edges, PoseGraphParams())
        t = np.asarray(opt.t)
        out[key] = {"nodes": n, "edges": int(edges.i.shape[0]),
                    "chi2_before": chi2_of(poses, edges), "chi2": float(chi2),
                    "mean_error_to_truth_m": float(np.linalg.norm(t - gt[:, :3, 3], axis=1).mean()),
                    "t": np.round(t.astype(np.float64), 6).tolist(),
                    "seconds": time.perf_counter() - t0}
        log(f"pose graph {key}: chi2 {out[key]['chi2_before']} -> {out[key]['chi2']}, "
            f"{out[key]['seconds']:.1f} s")
    return out


def run_loop_closure():
    from mp2p_icp_tpu import loop_closure
    from mp2p_icp_tpu.apps import kitti_odometry
    from mp2p_icp_tpu.loop_closure import propose_loop_candidates
    from torch_apps_reference import decimation_capacity, largest_voxel_count

    # the accepted loop measurements Z_ij, which close_and_optimize keeps to
    # itself: recorded on their way to optimize_trajectory
    measured, close_loops = [], loop_closure.close_loops

    def recorded_close_loops(*a, **kw):
        loops = close_loops(*a, **kw)
        measured.extend(loops)
        return loops

    with tempfile.TemporaryDirectory() as tmp:
        bin_dir, gt_path, _ = chip_smoke.write_loop_sequence(
            tmp, chip_smoke.LOOP_FRAMES, chip_smoke.APPS_RINGS, chip_smoke.APPS_AZIMUTHS)
        config = pathlib.Path(tmp) / "cropped.yaml"
        config.write_text(chip_smoke.ground_cropped_yaml())
        paths = sorted(bin_dir.glob("*.bin"))
        gt = load_kitti_poses(str(gt_path))
        voxels = largest_voxel_count(bin_dir, chip_smoke.CROPPED_RESOLUTION,
                                     chip_smoke.GROUND_CROP_Z - 0.01)
        t0 = time.perf_counter()
        buf = io.StringIO()
        loop_closure.close_loops = recorded_close_loops
        try:
            with decimation_capacity(round_capacity(voxels + 1)), contextlib.redirect_stdout(buf):
                r = kitti_odometry.run_sequence_mapping(
                    paths, str(config), gt_poses=gt, map_capacity=chip_smoke.APPS_MAP_CAPACITY,
                    loop_closure=True, loop_min_gap=chip_smoke.LOOP_MIN_GAP,
                    loop_max_distance=chip_smoke.LOOP_MAX_DISTANCE)
        finally:
            loop_closure.close_loops = close_loops
        seconds = time.perf_counter() - t0
    before = chip_smoke.trajectory_errors(r["poses_odometry"], gt)
    after = chip_smoke.trajectory_errors(r["poses"], gt)
    out = {"frames": len(paths), "decimated_capacity": round_capacity(voxels + 1),
           "printed": [ln for ln in buf.getvalue().splitlines() if ln.startswith("[loop-closure]")],
           "candidates": [list(c) for c in propose_loop_candidates(
               r["poses_odometry"], min_frame_gap=chip_smoke.LOOP_MIN_GAP,
               max_distance=chip_smoke.LOOP_MAX_DISTANCE)],
           "loops": [[int(i), int(j), float(q)] for i, j, q in r["loop_closures"]],
           "loop_measurements": [
               [int(i), int(j), np.asarray(z.R, np.float64).ravel().tolist(),
                np.asarray(z.t, np.float64).tolist(), float(q)] for i, j, z, q in measured],
           "ate_before_m": before[0], "rpe_before": before[1:],
           "ate_m": after[0], "rpe": after[1:],
           "poses": np.asarray(r["poses"])[:, :3, :].reshape(-1, 12).tolist(),
           "poses_odometry": np.asarray(r["poses_odometry"])[:, :3, :].reshape(-1, 12).tolist(),
           "seconds": seconds}
    log(f"loop closure: {len(out['candidates'])} candidates, {len(out['loops'])} accepted, ATE "
        f"{out['ate_before_m']} -> {out['ate_m']}, {seconds:.1f} s")
    return out


def run_spatial_mapper():
    from jax.sharding import Mesh

    from mp2p_icp_tpu.core import se3 as jse3
    from mp2p_icp_tpu.core.pointcloud import PointCloud as JPointCloud
    from mp2p_icp_tpu.odometry import SpatialOdometryMapper
    from mp2p_icp_tpu_torch.eval.lidar_sim import make_street_sequence
    from mp2p_icp_tpu_torch.eval.trajectory import ate_rmse
    from torch_odometry_reference import jax_mapper

    gt, twists, scans = make_street_sequence(chip_smoke.ODO_FRAMES)
    frames = [{"raw": JPointCloud.from_numpy(
        s["xyz"][s["valid"]], capacity=1 << 16, intensity=s["intensity"][s["valid"]],
        ring=s["ring"][s["valid"]], time=s["time"][s["valid"]])} for s in scans]
    pose0 = jse3.Pose(jnp.asarray(gt[0, :3, :3], jnp.float32), jnp.asarray(gt[0, :3, 3], jnp.float32))
    n = chip_smoke.SPATIAL_RANKS
    mesh = Mesh(np.array(jax.devices()[:n]), ("space",))
    t0 = time.perf_counter()
    run = SpatialOdometryMapper(mapper=jax_mapper([]), mesh=mesh,
                                ownership_resolution=chip_smoke.ODO_RESOLUTION).run(
        frames, twists=twists, dt=chip_smoke.ODO_DT, initial_pose=pose0)
    counts = np.asarray(run["map"].count)
    cells = set()
    for s in range(n):
        xyz = np.asarray(run["map"].xyz[s])[: counts[s]]
        cells |= {tuple(c) for c in np.floor(xyz / chip_smoke.ODO_RESOLUTION).astype(np.int64)}
    out = {"ranks": n, "ate_m": ate_rmse(run["poses"], gt), "map_points": counts.tolist(),
           "union_voxels": len(cells), "seconds": time.perf_counter() - t0}
    log(f"spatial mapper: ATE {out['ate_m']}, {out['map_points']} points, {out['seconds']:.1f} s")
    return out


def jax_data_space_batch(icp, params, globs, locals_, guesses, shared=False):
    """The JAX package's ``make_batched_align`` on a 4 x 2 (data, space) mesh
    of 8 devices, inputs placed as ``__graft_entry__.py:94-118`` places
    them: arrays of two or more axes with P("data", "space") (the batch over
    ``data``, each problem's points over ``space``), one axis with
    P("data"). ``globs`` is a list of B layer dicts ({name: {field:
    array}}), or one shared map with ``shared`` (its rows over ``space``).
    Returns {"R", "t", "iterations", "termination"} as lists."""
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from mp2p_icp_tpu.core.pointcloud import PointCloud as JPointCloud
    from mp2p_icp_tpu.core.se3 import Pose as JPose
    from mp2p_icp_tpu.parallel.batch import make_batched_align, stack_pytrees
    from mp2p_icp_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(n_data=4, n_space=2)

    def layers(d):
        return {k: JPointCloud(**{f: jnp.asarray(a) for f, a in v.items()}) for k, v in d.items()}

    def place(spec_2d, spec_1d):
        def put(x):
            if hasattr(x, "ndim") and x.ndim >= 1:
                return jax.device_put(x, NamedSharding(mesh, spec_2d if x.ndim >= 2 else spec_1d))
            return x
        return lambda tree: jax.tree_util.tree_map(put, tree)

    batched, shared_map = place(P("data", "space"), P("data")), place(P("space"), P("space"))
    l_b = batched(stack_pytrees([layers(x) for x in locals_]))
    g_b = shared_map(layers(globs)) if shared else batched(stack_pytrees([layers(g) for g in globs]))
    u_b = jax.tree_util.tree_map(
        lambda x: jax.device_put(x, NamedSharding(mesh, P("data"))),
        stack_pytrees([JPose(jnp.asarray(R), jnp.asarray(t)) for R, t in guesses]))
    with mesh:
        res = make_batched_align(icp, params, broadcast_globals=shared)(l_b, g_b, u_b)
        jax.block_until_ready(res.optimal_tf.t)
    return {"R": np.asarray(res.optimal_tf.R).tolist(), "t": np.asarray(res.optimal_tf.t).tolist(),
            "iterations": np.asarray(res.n_iterations).tolist(),
            "termination": np.asarray(res.termination_reason).tolist()}


def run_data_space():
    import __graft_entry__ as graft
    from mp2p_icp_tpu.icp import ICPParameters

    t0 = time.perf_counter()
    globs, locals_ = [], []
    for seed in range(8):
        g, loc = graft._make_problem(n_points=256, seed=seed)
        globs.append({k: {"xyz": np.asarray(v.xyz), "count": np.asarray(v.count)}
                      for k, v in g.items()})
        locals_.append({k: {"xyz": np.asarray(v.xyz), "count": np.asarray(v.count)}
                        for k, v in loc.items()})
    eye = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    out = jax_data_space_batch(graft._make_icp(), ICPParameters(max_iterations=5), globs,
                               locals_, [eye] * 8)
    out.update(mesh={"data": 4, "space": 2}, points=256, seeds=list(range(8)),
               seconds=time.perf_counter() - t0)
    log(f"data x space dry run: iterations {out['iterations']}, {out['seconds']:.1f} s")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--write", default=None, help="also write the JSON here")
    args = ap.parse_args()
    t0 = time.perf_counter()
    out = {"package": "mp2p_icp_tpu (JAX) on " + jax.devices()[0].platform}
    out["pose_graph"] = run_pose_graph()
    out["loop_closure"] = run_loop_closure()
    out["spatial_mapper"] = run_spatial_mapper()
    out["data_space"] = run_data_space()
    out["seconds"] = time.perf_counter() - t0
    text = json.dumps(out)
    print(text)
    if args.write:
        pathlib.Path(args.write).write_text(text + "\n")


if __name__ == "__main__":
    main()
