#!/usr/bin/env python3
"""The port's multi-rank dry run on tiny shapes: the twin of the JAX
package's ``__graft_entry__.dryrun_multichip`` and
``scripts/multihost_dryrun.py``.

    python3 scripts/torch_multichip_dryrun.py N [--device cuda|cpu]

Spawns N ranks (``parallel/launch.spawn_ranks``) and checks, on the JAX dry
run's problems (uniform +-10 m clouds, ground truth
``from_xyz_ypr(0.3, -0.2, 0.1, 0.05, -0.03, 0.02)``, Horn up to iteration
5, then Gauss-Newton with 3 inner iterations, DistanceThreshold 1.0):

1. ``make_batched_align`` on a ``make_mesh(N // n_space, n_space)`` mesh,
   n_space = 2 when N is even and >= 4 (else 1): B = 2 x n_data problems
   of 256 points, the batch split over ``data`` and every problem's map over
   ``space``, ``max_iterations=5``: translation errors < 1e-3, and R, t,
   iterations and terminations equal to the one-process batch to the bit;
2. ``make_spatial_align`` with one 1024-point map over N shards: error
   < 1e-3;
3. ``SpatialOdometryMapper`` over 4 space ranks (2 when N is not a multiple
   of 4) on the 5-frame street drive, with Point2Plane knn=6 and FirstPoint
   map filters, and with the incremental map and stored normals: drift
   < 0.3 m, the first within 0.02 m of the unsharded mapper, nothing
   dropped;
4. two processes started by ``multihost.init_from_env`` from the MP2P_*
   variables, each with its host-local half of an 8-pair batch (512
   points, ``max_iterations=12``): both fetch all 8 poses, equal to one
   process to the bit.

The two spawns run side by side, and this process computes the
one-process references meanwhile: most of a spawn's time is its ranks'
start-up.

The second-last line has the JAX dry run's form; the last names the
backend. Any failed check exits non-zero.

``--device`` as the apps have it: the card unless ``cpu`` is asked for.
The backend is NCCL when the device is the card and
``torch.cuda.device_count() >= N`` (a card per rank), else gloo (the CPU,
or every rank on card 0, collectives staged through the host). The choice
is printed; nothing falls back to another backend or device.

Imports torch, numpy and the port; nothing of JAX.
"""

import argparse
import concurrent.futures
import pathlib
import sys
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from mp2p_icp_tpu_torch.convert import pointcloud_to_numpy  # noqa: E402
from mp2p_icp_tpu_torch.core import se3  # noqa: E402
from mp2p_icp_tpu_torch.device import set_default_device  # noqa: E402
from mp2p_icp_tpu_torch.eval.lidar_sim import (  # noqa: E402
    make_street_scene,
    render_spinning_scan,
    scan_to_pointcloud,
)
from mp2p_icp_tpu_torch.filters import FilterDecimateVoxels, FilterDeskew  # noqa: E402
from mp2p_icp_tpu_torch.icp import ICP, ICPParameters  # noqa: E402
from mp2p_icp_tpu_torch.matchers import (  # noqa: E402
    LayerMatch,
    MatcherPoint2Plane,
    MatcherPointsDistanceThreshold,
)
from mp2p_icp_tpu_torch.odometry import OdometryMapper  # noqa: E402
from mp2p_icp_tpu_torch.parallel import ranks  # noqa: E402
from mp2p_icp_tpu_torch.parallel.launch import spawn_ranks  # noqa: E402
from mp2p_icp_tpu_torch.solvers.gauss_newton import GNParams  # noqa: E402
from mp2p_icp_tpu_torch.solvers.solver import SolverGaussNewton, SolverHorn  # noqa: E402

GT = (0.3, -0.2, 0.1, 0.05, -0.03, 0.02)
ODO_FRAMES, ODO_DT, ODO_RES = 5, 0.1, 0.5
MULTIHOST_BATCH, MULTIHOST_POINTS = 8, 512
TIMEOUT = 900.0  # seconds a spawn may take before its ranks are killed


def make_problem(n_points=2048, seed=0):
    """(global layers, local layers) as {name: {field: array}}: a uniform
    +-10 m cloud and the same cloud seen from the ground truth (the JAX dry
    run's ``_make_problem``)."""
    xyz = np.random.RandomState(seed).uniform(-10, 10, (n_points, 3)).astype(np.float32)
    gt = se3.from_xyz_ypr(*GT, device="cpu")
    local = se3.apply(se3.inverse(gt), torch.from_numpy(xyz)).numpy()
    n = np.int32(n_points)
    return {"raw": {"xyz": xyz, "count": n}}, {"raw": {"xyz": local, "count": n}}


def make_icp():
    """The JAX dry run's ``_make_icp``."""
    return ICP(matchers=[MatcherPointsDistanceThreshold(threshold=1.0)],
               solvers=[SolverHorn(run_up_to_iteration=5),
                        SolverGaussNewton(run_from_iteration=6,
                                          gn_params=GNParams(max_iterations=3))])


def identity():
    return np.eye(3, dtype=np.float32), np.zeros(3, np.float32)


def mesh_shape(n: int):
    """(n_data, n_space) of the batch check: the JAX dry run's rule."""
    n_space = 2 if n % 2 == 0 and n >= 4 else 1
    return n // n_space, n_space


def batch_problems(n_data: int, n_points: int = 256):
    """The batch check's B = 2 n_data problems (seeds 0..B-1):
    (globals, locals, guesses)."""
    probs = [make_problem(n_points, seed=s) for s in range(2 * n_data)]
    return [g for g, _ in probs], [loc for _, loc in probs], [identity()] * len(probs)


def multihost_problems():
    """``scripts/multihost_dryrun.py``'s 8 pairs (seeds 1000 + b, 512
    points) and its ICP (``max_iterations=12``)."""
    probs = [make_problem(MULTIHOST_POINTS, seed=1000 + b) for b in range(MULTIHOST_BATCH)]
    return ([g for g, _ in probs], [loc for _, loc in probs], [identity()] * len(probs),
            make_icp(), ICPParameters(max_iterations=12))


def odometry_drive():
    """The JAX dry run's 5-frame street drive (16 rings x 256 azimuths):
    (frames as numpy layer dicts, twists, ground-truth translations, the
    first pose as (R, t))."""
    rng = np.random.RandomState(3)
    scene = make_street_scene(rng, length=60.0, n_pillars=16)
    poses = [se3.from_xyz_ypr(10.0 + 0.5 * i, 0.0, 1.6, 0.0, 0.0, 0.0, device="cpu")
             for i in range(ODO_FRAMES)]
    frames, twists = [], []
    for i in range(ODO_FRAMES):
        if i < ODO_FRAMES - 1:
            rel = se3.compose(se3.inverse(poses[i]), poses[i + 1])
            tw = se3.log(rel).numpy().astype(np.float32) / ODO_DT
        else:
            tw = twists[-1]
        twists.append(np.asarray(tw, np.float32))
        scan = render_spinning_scan(scene, poses[i], twists[i], rng, n_rings=16, n_azimuth=256)
        frames.append({"raw": pointcloud_to_numpy(
            scan_to_pointcloud(scan, capacity=4096, device="cpu"))})
    gt_t = np.stack([p.t.numpy() for p in poses])
    return frames, twists, gt_t, (poses[0].R.numpy(), poses[0].t.numpy())


def odometry_mapper(incremental: bool) -> OdometryMapper:
    """The JAX dry run's two mappers: Point2Plane knn=6 with FirstPoint map
    filters, or the incremental voxel map with stored normals."""
    matcher = dict(use_point_normals=True) if incremental else dict(knn=6)
    common = dict(
        icp=ICP(matchers=[MatcherPoint2Plane(
            distance_threshold=1.5,
            layer_matches=(LayerMatch(global_layer="map", local_layer="decimated"),), **matcher)],
            solvers=[SolverGaussNewton(gn_params=GNParams(max_iterations=3))]),
        params=ICPParameters(max_iterations=15, crop_to_local_bbox=False),
        filters=[FilterDeskew(input_pointcloud_layer="raw", output_pointcloud_layer="deskewed"),
                 FilterDecimateVoxels(input_pointcloud_layer=("deskewed",),
                                      output_pointcloud_layer="decimated",
                                      voxel_filter_resolution=ODO_RES, output_capacity=2048)],
        map_capacity=1 << 13)
    if incremental:
        return OdometryMapper(incremental_map_resolution=ODO_RES, normals_knn=8,
                              normals_radius=1.5, **common)
    return OdometryMapper(map_filters=[FilterDecimateVoxels(
        input_pointcloud_layer=("map",), output_pointcloud_layer="map",
        voxel_filter_resolution=ODO_RES, output_capacity=1 << 13)], **common)


def choose_backend(n: int, device: str):
    """(backend, the ranks' device) for n ranks: NCCL with a card per rank,
    else gloo (every rank on card 0, or on the CPU)."""
    if device == "cpu":
        return "gloo", "cpu"
    if not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device (pass --device cpu for the CPU)")
    if torch.cuda.device_count() >= n:
        return "nccl", "cuda"
    return "gloo", "cuda:0"


def one_process_batch(icp, params, globs, locals_, guesses, device):
    """The unsharded batch in this process: (R, t, iterations, terminations)."""
    from mp2p_icp_tpu_torch.parallel.batch import make_batched_align, stack_pytrees

    dev = torch.device(device)

    def layers(d):
        return {k: ranks._cloud(dict(v, device=dev)) for k, v in d.items()}

    def pose(Rt):
        return se3.Pose(torch.from_numpy(Rt[0]).to(dev), torch.from_numpy(Rt[1]).to(dev))

    res = make_batched_align(icp, params)(stack_pytrees([layers(x) for x in locals_]),
                                          stack_pytrees([layers(g) for g in globs]),
                                          stack_pytrees([pose(g) for g in guesses]))
    return (res.optimal_tf.R.cpu().numpy(), res.optimal_tf.t.cpu().numpy(),
            res.n_iterations.cpu().numpy(), res.termination_reason.cpu().numpy())


def same_batch(got: dict, ref) -> bool:
    R, t, its, term = ref
    return all(np.array_equal(a, b) for a, b in (
        (got["R"], R), (got["t"], t), (got["iterations"], its), (got["termination"], term)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, help="ranks")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the card (default) or the CPU")
    args = ap.parse_args(argv)
    n = args.n
    backend, rank_device = choose_backend(n, args.device)
    device = "cpu" if rank_device == "cpu" else "cuda:0"  # this process's
    set_default_device(device)
    backend2, rank_device2 = choose_backend(2, args.device)
    where = "on the CPU" if rank_device == "cpu" else (
        "a card per rank" if rank_device == "cuda" else
        f"all on card 0 of {torch.cuda.device_count()}, collectives through the host")
    print(f"[dryrun] {n} ranks, backend {backend} ({where}); the 2-process start: {backend2}",
          flush=True)
    failed = []

    def check(ok, what):
        if not ok:
            failed.append(what)
            print(f"[dryrun] FAILED: {what}", flush=True)

    n_data, n_space = mesh_shape(n)
    icp, params = make_icp(), ICPParameters(max_iterations=5)
    globs, locals_, guesses = batch_problems(n_data)
    g1, l1 = make_problem(1024, seed=100)
    frames, twists, gt_t, pose0 = odometry_drive()
    n_odo = 4 if n % 4 == 0 else (2 if n % 2 == 0 else n)
    mappers = [odometry_mapper(False), odometry_mapper(True)]
    tasks = [(ranks.data_parallel_batch, (icp, params, locals_, globs, guesses, 0, n_space)),
             (ranks.spatial_align, (icp, params, l1, g1, identity()))]
    tasks += [(ranks.spatial_mapper, (m, frames, twists, pose0, ODO_DT, ODO_RES, n_odo))
              for m in mappers]
    mh_globs, mh_locals, mh_guesses, mh_icp, mh_params = multihost_problems()
    dev_ = torch.device(device)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        runs = pool.submit(spawn_ranks, ranks.sequence, n, backend, args=(tasks,),
                           device=rank_device, timeout=TIMEOUT)
        mh_run = pool.submit(spawn_ranks, ranks.data_parallel_batch, 2, backend2,
                             device=rank_device2, init="env", timeout=TIMEOUT,
                             args=(mh_icp, mh_params, mh_locals, mh_globs, mh_guesses))
        ref = one_process_batch(icp, params, globs, locals_, guesses, device)
        one = mappers[0].run([{k: ranks._cloud(dict(v, device=dev_)) for k, v in f.items()}
                              for f in frames], twists=twists, dt=ODO_DT,
                             initial_pose=se3.Pose(torch.from_numpy(pose0[0]).to(dev_),
                                                   torch.from_numpy(pose0[1]).to(dev_)))
        mh_ref = one_process_batch(mh_icp, mh_params, mh_globs, mh_locals, mh_guesses, device)
        out, mh = runs.result(), mh_run.result()
    print(f"[dryrun] {n} ranks ran {len(tasks)} paths and 2 processes the host-local batch, "
          f"side by side, in {time.perf_counter() - t0:.1f} s, start-up included", flush=True)
    batch, spatial, sharded, inc = (list(r) for r in zip(*out))

    # 1. the batch over the data x space mesh
    gt = se3.from_xyz_ypr(*GT, device="cpu")
    errs = np.linalg.norm(batch[0]["t"] - gt.t.numpy()[None], axis=-1)
    same = all(same_batch(r, ref) for r in batch)
    print(f"[dryrun] batched align on the mesh {batch[0]['mesh']}: B={len(guesses)}, "
          f"{batch[0]['rows']} rows per rank, translation errors {errs.tolist()}, iterations "
          f"{batch[0]['iterations'].tolist()}; every rank's fetched poses, iterations and "
          f"terminations equal to one process to the bit: {same}; all_gathers per rank "
          f"{[r['gathers'] for r in batch]}", flush=True)
    check(np.isfinite(errs).all() and (errs < 1e-3).all(), f"batch translation errors {errs}")
    check(same, "the batch on the mesh differs from one process")

    # 2. the spatial align over every rank
    sp_err = float(np.linalg.norm(spatial[0]["pose"][1] - gt.t.numpy()))
    alike = all(np.array_equal(r["pose"][1], spatial[0]["pose"][1]) for r in spatial)
    print(f"[dryrun] make_spatial_align over {n} shards: error {sp_err:.3g}, "
          f"{spatial[0]['iterations']} iterations, every rank the same pose: {alike}", flush=True)
    check(np.isfinite(sp_err) and sp_err < 1e-3 and alike, f"spatial align error {sp_err}")

    # 3. the sharded mapper in both modes, the first against the unsharded one
    o_errs = np.linalg.norm(sharded[0]["poses"][:, :3, 3] - gt_t, axis=1)
    inc_errs = np.linalg.norm(inc[0]["poses"][:, :3, 3] - gt_t, axis=1)
    o_dev = np.linalg.norm(sharded[0]["poses"][:, :3, 3] - one["poses"][:, :3, 3], axis=1)
    dropped = [r["dropped"] for r in sharded + inc]
    print(f"[dryrun] SpatialOdometryMapper over {n_odo} space ranks, {ODO_FRAMES} frames: "
          f"FirstPoint map terr {o_errs.max():.4f} m, {o_dev.max():.4f} m from the unsharded "
          f"mapper; incremental map + stored normals terr {inc_errs.max():.4f} m; dropped "
          f"{dropped}", flush=True)
    check(o_errs.max() < 0.3, f"sharded odometry drifted: {o_errs}")
    check(o_dev.max() < 0.02, f"sharded odometry deviates from unsharded: {o_dev}")
    check(inc_errs.max() < 0.3, f"incremental sharded odometry drifted: {inc_errs}")
    check(sum(dropped) == 0, f"dropped inserts {dropped}")

    # 4. two processes from the MP2P_* variables, host-local halves
    mh_ok = all(same_batch(r, mh_ref) for r in mh)
    print(f"[dryrun] 2 processes by init_from_env ({backend2}), {mh[0]['rows']} of "
          f"{MULTIHOST_BATCH} pairs each: both fetch all {MULTIHOST_BATCH} poses equal to one "
          f"process to the bit: {mh_ok}", flush=True)
    check(mh_ok, "the 2-process batch differs from one process")

    if failed:
        print(f"[dryrun] {len(failed)} check(s) failed: {failed}")
        return 1
    print(f"dryrun_multichip OK: mesh data={n_data} space={n_space}, B={len(guesses)}, "
          f"translation errors={errs.round(3).tolist()}; spatial-sharded align over {n} shards "
          f"err={sp_err:.4f}; sharded-odometry max terr={o_errs.max():.4f} (vs-unsharded "
          f"dev={o_dev.max():.4f}, incremental+normals terr={inc_errs.max():.4f}); multihost "
          f"2-process dryrun ok={mh_ok}")
    print(f"backend: {backend} ({n} ranks, {where})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
