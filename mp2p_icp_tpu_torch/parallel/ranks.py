"""Per-rank runs of the sharded paths, for ``launch.spawn_ranks``.

Each function runs on every rank of a fresh process group. It builds its
inputs from numpy on this rank's device, drives one sharded entry point
the way a user calls it, and returns numpy results with this rank's kNN
kernel launches of the counted run (the counters set to 0 just before it
and read just after it) and the milliseconds of ``reps`` further timed runs
(host clock, the device synchronised around each). ``chip_smoke.py``
drives them on the card; the CPU tests on gloo ranks.

Layers travel as {name: {field: array}} (``convert.pointcloud_to_numpy``),
poses as (R, t) arrays.
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from mp2p_icp_tpu_torch.core.pointcloud import PointCloud
from mp2p_icp_tpu_torch.core.se3 import Pose
from mp2p_icp_tpu_torch.device import default_device
from mp2p_icp_tpu_torch.ops import nn_bruteforce as nnb
from mp2p_icp_tpu_torch.parallel.mesh import make_mesh, shard_batch, world

SWEEPS = ("knn_sweep", "knn_sweep_streamed", "knn_sweep_batched")


def _sync():
    if default_device().type == "cuda":
        torch.cuda.synchronize()


def _reset():
    _sync()
    for name in SWEEPS:
        getattr(nnb, name).launches = 0


def _counts() -> dict:
    _sync()
    return {name: getattr(nnb, name).launches for name in SWEEPS}


def _ms(fn, reps: int):
    """Median host milliseconds of ``reps`` synchronised calls (None for 0)."""
    times = []
    for _ in range(reps):
        _sync()
        t0 = time.perf_counter()
        fn()
        _sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times) if times else None


def _cloud(fields: dict) -> PointCloud:
    from mp2p_icp_tpu_torch.convert import pointcloud_from_numpy

    fields = dict(fields)
    return pointcloud_from_numpy(fields.pop("xyz"), fields.pop("count"), **fields)


def _layers(np_layers: dict) -> dict:
    return {name: _cloud(f) for name, f in np_layers.items()}


def _pose(Rt) -> Pose:
    dev = default_device()
    return Pose(torch.as_tensor(np.asarray(Rt[0], np.float32), device=dev),
                torch.as_tensor(np.asarray(Rt[1], np.float32), device=dev))


def _np_pose(p: Pose):
    return p.R.cpu().numpy(), p.t.cpu().numpy()


def _space_mesh():
    """Every rank on the ``space`` axis."""
    return make_mesh(n_data=1, n_space=world()[0])


def sequence(tasks):
    """Run [(fn, args), ...] one after another on this rank (one start-up
    for several paths); returns their results in order, each with the host
    seconds of its task under "seconds"."""
    out = []
    for fn, args in tasks:
        t0 = time.perf_counter()
        res = fn(*args)
        _sync()
        res["seconds"] = time.perf_counter() - t0
        out.append(res)
    return out


def sharded_knn(queries: np.ndarray, points: np.ndarray, ks=(1, 8), reps: int = 0):
    """knn_bruteforce of queries [Q, 3] over the map points [C, 3] split
    over every rank (``shard_global_layers``; each rank sweeps its shard:
    K1, or K3 above 131072 rows). Returns per k: idx, dist_sq, xyz, the
    launches and the ms of one call."""
    from mp2p_icp_tpu_torch.parallel.spatial import shard_global_layers

    mesh = _space_mesh()
    dev = default_device()
    q = torch.from_numpy(np.asarray(queries, np.float32)).to(dev)
    qv = torch.ones(q.shape[0], dtype=torch.bool, device=dev)
    whole = PointCloud(xyz=torch.from_numpy(np.asarray(points, np.float32)).to(dev),
                       count=torch.tensor(points.shape[0], dtype=torch.int32, device=dev))
    shard = shard_global_layers({"map": whole}, mesh.space.size)["map"]
    p, pv = shard.xyz[mesh.space.rank], shard.valid_mask()[mesh.space.rank]
    del whole, shard

    def call(k):
        return nnb.knn_bruteforce(q, qv, p, pv, k=k, spatial_axis=mesh.space)

    out = {"shard_rows": int(p.shape[0])}
    for k in ks:
        _reset()
        res = call(k)
        out[k] = {"launches": _counts(), "idx": res.idx.cpu().numpy(),
                  "dist_sq": res.dist_sq.cpu().numpy(), "xyz": res.xyz.cpu().numpy(),
                  "ms": _ms(lambda: call(k), reps)}
    return out


def spatial_align(icp, params, local: dict, glob: dict, guess, reps: int = 0):
    """``make_spatial_align`` of the local layers against the global layers
    split over every rank, from ``guess`` (R, t). Returns the pose,
    iterations, termination, quality, pairings, the launches of one align,
    the ms of one align, and this rank's shard rows inside the crop's box
    beside ``params.crop_capacity`` (more: the crop strides)."""
    from mp2p_icp_tpu_torch.parallel.spatial import make_spatial_align, shard_global_layers

    mesh = _space_mesh()
    l_layers, g_sharded = _layers(local), shard_global_layers(_layers(glob), mesh.space.size)
    pose = _pose(guess)
    fn = make_spatial_align(icp, params, mesh)
    _reset()
    res = fn(l_layers, g_sharded, pose)
    launches = _counts()
    in_box = {name: int(icp.in_crop_box(params, PointCloud(xyz=pc.xyz[mesh.space.rank],
                                                           count=pc.count[mesh.space.rank]),
                                        l_layers, pose).sum())
              for name, pc in g_sharded.items()}
    return {"pose": _np_pose(res.optimal_tf), "iterations": int(res.n_iterations),
            "termination": res.termination_reason.name, "quality": float(res.quality),
            "pairings": int(res.final_pairings.size()), "launches": launches,
            "in_box": in_box, "ms": _ms(lambda: fn(l_layers, g_sharded, pose), reps)}


def spatial_mapper(mapper, frames: list, twists, pose0, dt, ownership_resolution: float):
    """``SpatialOdometryMapper.run`` over every rank (the map split over
    the ``space`` axis). Returns the poses, iterations and frame seconds,
    the launches of the run, this rank's dropped inserts, and on rank 0
    the stacked map of all shards ({field: [n, shard capacity, ...]})."""
    from mp2p_icp_tpu_torch.convert import pointcloud_to_numpy
    from mp2p_icp_tpu_torch.odometry import SpatialOdometryMapper

    mesh = _space_mesh()
    sm = SpatialOdometryMapper(mapper=mapper, mesh=mesh,
                               ownership_resolution=ownership_resolution)
    frames_t = [_layers(f) for f in frames]
    _reset()
    r = sm.run(frames_t, twists=twists, dt=dt, initial_pose=_pose(pose0))
    launches = _counts()
    state = r["map_state"]
    return {"poses": r["poses"], "iterations": r["iterations"],
            "frame_seconds": r["frame_seconds"], "launches": launches,
            "dropped": int(getattr(state, "n_dropped", 0)),
            "map": pointcloud_to_numpy(r["map"]) if mesh.space.rank == 0 else None}


def data_parallel_batch(icp, params, locals_: list, glob: dict, guesses: list, reps: int = 0):
    """B problems against one shared map, split over the ``data`` axis of
    every rank: each rank keeps its rows (``shard_batch``) and aligns them
    with ``make_batched_align`` (one K2 launch per matcher call);
    ``fetch_replicated`` brings every rank's poses and iterations together.
    Returns them (all B, in order), the launches of one call and its ms."""
    from mp2p_icp_tpu_torch.parallel.batch import make_batched_align, stack_pytrees
    from mp2p_icp_tpu_torch.parallel.multihost import (
        fetch_replicated,
        host_local_batch,
        make_global_mesh,
    )

    mesh = make_global_mesh(n_space=1)
    l_b = host_local_batch(mesh, shard_batch(mesh, stack_pytrees([_layers(x) for x in locals_])))
    g_b = host_local_batch(mesh, shard_batch(mesh, stack_pytrees([_pose(g) for g in guesses])))
    gmap = _layers(glob)
    fn = make_batched_align(icp, params, broadcast_globals=True)
    _reset()
    res = fn(l_b, gmap, g_b)
    launches = _counts()
    return {"R": fetch_replicated(res.optimal_tf.R, mesh),
            "t": fetch_replicated(res.optimal_tf.t, mesh),
            "iterations": fetch_replicated(res.n_iterations, mesh),
            "termination": fetch_replicated(res.termination_reason, mesh),
            "launches": launches, "rows": int(g_b.t.shape[0]),
            "ms": _ms(lambda: fn(l_b, gmap, g_b), reps)}


def pose_graph(poses, edges: dict, solver: str, params, reps: int = 0):
    """The pose graph (R [N, 3, 3], t [N, 3]) with its edges
    ({i, j, z_R, z_t, information, valid}) split over the ``data`` axis of
    every rank: ``optimize_pose_graph_sharded`` (solver "dense") or
    ``optimize_pose_graph_cg`` with the mesh ("cg"). Returns the poses,
    chi² and the ms of one solve."""
    from mp2p_icp_tpu_torch.convert import pose_graph_edges_from_numpy
    from mp2p_icp_tpu_torch.parallel import pose_graph as pg

    mesh = make_mesh(n_space=1)
    p0, e = _pose(poses), pose_graph_edges_from_numpy(**edges)
    if solver == "dense":
        def run():
            return pg.optimize_pose_graph_sharded(p0, e, mesh, params)
    elif solver == "cg":
        def run():
            return pg.optimize_pose_graph_cg(p0, e, params, mesh=mesh)
    else:
        raise ValueError(f"solver is 'dense' or 'cg', not {solver!r}")
    _sync()
    t0 = time.perf_counter()
    opt, chi2 = run()
    chi2 = float(chi2)
    return {"pose": _np_pose(opt), "chi2": chi2, "solve_ms": (time.perf_counter() - t0) * 1e3,
            "ms": _ms(run, reps)}
