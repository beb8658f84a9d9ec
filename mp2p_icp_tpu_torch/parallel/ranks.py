"""Per-rank runs of the sharded paths, for ``launch.spawn_ranks``.

Each function runs on every rank of a fresh process group. It builds its
inputs from numpy on this rank's device, drives one sharded entry point
the way a user calls it, and returns numpy results with this rank's kernel
launches of the counted run (the kNN sweeps' and the Gauss-Newton solve's;
the counters set to 0 just before it and read just after it) and the
milliseconds of ``reps`` further timed runs (host clock, the device
synchronised around each). ``chip_smoke.py``
drives them on the card; the CPU tests on gloo ranks.

Layers travel as {name: {field: array}} (``convert.pointcloud_to_numpy``),
poses as (R, t) arrays.
"""

from __future__ import annotations

import functools
import statistics
import time

import numpy as np
import torch

from mp2p_icp_tpu_torch.core.pointcloud import PointCloud
from mp2p_icp_tpu_torch.core.se3 import Pose
from mp2p_icp_tpu_torch.device import default_device
from mp2p_icp_tpu_torch.ops import icp_terminate
from mp2p_icp_tpu_torch.ops import nn_bruteforce as nnb
from mp2p_icp_tpu_torch.parallel.mesh import make_mesh, shard_batch, world
from mp2p_icp_tpu_torch.solvers import gauss_newton

# the kernels whose launches a run counts: name -> the wrapper that counts them
COUNTED = {"knn_sweep": nnb.knn_sweep, "knn_sweep_streamed": nnb.knn_sweep_streamed,
           "knn_sweep_batched": nnb.knn_sweep_batched, "gn_solve": gauss_newton.gn_solve_fused,
           "icp_terminate": icp_terminate.terminate_fused}


def _sync():
    if default_device().type == "cuda":
        torch.cuda.synchronize()


def _reset():
    _sync()
    for wrapper in COUNTED.values():
        wrapper.launches = 0
    nnb.knn_sharded.gathers = 0


def _counts() -> dict:
    _sync()
    return {name: wrapper.launches for name, wrapper in COUNTED.items()}


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


def batched_sharded_knn(queries: np.ndarray, points: np.ndarray, ks=(1, 8),
                        radius_sq: np.ndarray = None, payload: np.ndarray = None,
                        n_space: int = None):
    """``knn_bruteforce(spatial_axis=...)`` under ``torch.func.vmap`` over B
    problems: queries [B, Q, 3] against points [B, C, 3] (each problem's
    map) or [C, 3] (one shared map), split over the ``space`` axis of a
    mesh of ``n_space`` (default: every rank), optionally with a per-query
    ``radius_sq`` [B, Q] and ``point_payload`` rows ([B,] C, P) split like
    the points. Returns per k the vmapped result (idx, dist_sq, xyz,
    payload), the same from a loop of unbatched calls, and the launches
    and all_gathers of the vmapped call."""
    from torch.func import vmap

    from mp2p_icp_tpu_torch.parallel.spatial import own_shard

    mesh = make_mesh(n_space=n_space or world()[0])
    dev = default_device()
    q = torch.from_numpy(np.asarray(queries, np.float32)).to(dev)
    qv = torch.ones(q.shape[:2], dtype=torch.bool, device=dev)
    shared = points.ndim == 2
    fields = {"xyz": np.asarray(points, np.float32)}
    if payload is not None:  # the payload rides the shard as the normals field
        fields["normals"] = np.asarray(payload, np.float32)
    count = np.full(() if shared else points.shape[:1], points.shape[-2], np.int32)
    whole = {"map": _cloud(dict(fields, count=count))}
    shard = own_shard(whole, mesh.space, batched=not shared)["map"]
    p, pv = shard.xyz, shard.valid_mask()
    pl = shard.normals if payload is not None else None
    r = None if radius_sq is None else torch.from_numpy(
        np.asarray(radius_sq, np.float32)).to(dev)
    p_dim = None if shared else 0

    def one(k, qb, pb, pvb, rb, plb):
        return nnb.knn_bruteforce(qb, qv[0], pb, pvb, k=k, max_radius_sq=rb,
                                  spatial_axis=mesh.space, point_payload=plb)

    def fields(k, *args):  # vmap returns tensors only: no payload, no field
        res = one(k, *args)
        return tuple(res) if res.payload is not None else tuple(res)[:-1]

    def as_np(res):
        return {"idx": res.idx.cpu().numpy(), "dist_sq": res.dist_sq.cpu().numpy(),
                "xyz": res.xyz.cpu().numpy(),
                "payload": None if res.payload is None else res.payload.cpu().numpy()}

    out = {"shard_rows": int(p.shape[-2])}
    for k in ks:
        _reset()
        got = vmap(functools.partial(fields, k),
                   in_dims=(0, p_dim, p_dim, None if r is None else 0,
                            None if pl is None else p_dim))(q, p, pv, r, pl)
        launches, gathers = _counts(), nnb.knn_sharded.gathers
        loop = [one(k, q[b], p if shared else p[b], pv if shared else pv[b],
                    None if r is None else r[b],
                    None if pl is None else (pl if shared else pl[b]))
                for b in range(q.shape[0])]
        stacked = nnb.ShardedNNResult(*(
            None if parts[0] is None else torch.stack(parts) for parts in zip(*loop)))
        out[k] = {"vmapped": as_np(nnb.ShardedNNResult(*got)), "loop": as_np(stacked),
                  "launches": launches, "gathers": gathers}
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


def spatial_mapper(mapper, frames: list, twists, pose0, dt, ownership_resolution: float,
                   n_space: int = None):
    """``SpatialOdometryMapper.run`` with the map split over the ``space``
    axis of a mesh of ``n_space`` ranks (default: every rank; more ranks
    form ``data`` rows that each run the same drive). Returns the poses,
    iterations and frame seconds, the launches of the run, this rank's
    dropped inserts, and on the first rank of each space group the stacked
    map of its shards ({field: [n, shard capacity, ...]})."""
    from mp2p_icp_tpu_torch.convert import pointcloud_to_numpy
    from mp2p_icp_tpu_torch.odometry import SpatialOdometryMapper

    mesh = make_mesh(n_space=n_space or world()[0])
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


def data_parallel_batch(icp, params, locals_: list, glob, guesses: list, reps: int = 0,
                        n_space: int = 1):
    """B problems split over the ``data`` axis of a [world / n_space,
    n_space] mesh (``multihost.make_global_mesh``): each rank keeps its rows
    (``shard_batch``, ``host_local_batch``) and aligns them with
    ``make_batched_align`` (one K2 launch per matcher call);
    ``fetch_replicated`` brings every rank's poses and iterations together.
    ``glob`` is one shared map (a layer dict) or each problem's own (a list
    of B). With ``n_space`` > 1 every map is split over the ``space`` axis
    too: each rank passes its own shard (``spatial.own_shard``) and the
    matchers merge the shards' k-lists with one all_gather per call.
    Returns the poses, iterations, terminations and qualities (all B, in
    order), the launches and all_gathers of one call, its ms and this rank's rows in
    each map's crop box beside ``params.crop_capacity`` (more: the crop
    strides)."""
    from mp2p_icp_tpu_torch.parallel.batch import make_batched_align, stack_pytrees
    from mp2p_icp_tpu_torch.parallel.multihost import (
        fetch_replicated,
        host_local_batch,
        make_global_mesh,
    )
    from mp2p_icp_tpu_torch.parallel.spatial import own_shard

    mesh = make_global_mesh(n_space=n_space)
    shared = isinstance(glob, dict)
    l_b = host_local_batch(mesh, shard_batch(mesh, stack_pytrees([_layers(x) for x in locals_])))
    g_b = host_local_batch(mesh, shard_batch(mesh, stack_pytrees([_pose(g) for g in guesses])))
    if shared:
        gmap = _layers(glob)
    else:  # this rank's rows only: each problem's map is built where it is used
        mine = shard_batch(mesh, torch.arange(len(glob))).tolist()
        gmap = stack_pytrees([_layers(glob[i]) for i in mine])
    if n_space > 1:
        gmap = own_shard(gmap, mesh.space, batched=not shared)
    fn = make_batched_align(icp, params, broadcast_globals=shared, space=mesh.space)
    _reset()
    res = fn(l_b, gmap, g_b)
    launches, gathers = _counts(), nnb.knn_sharded.gathers
    in_box = {}
    for name, pc in gmap.items():
        per = [icp.in_crop_box(params, pc if shared else PointCloud(xyz=pc.xyz[b],
                                                                    count=pc.count[b]),
                               {k: PointCloud(xyz=v.xyz[b], count=v.count[b])
                                for k, v in l_b.items()}, Pose(g_b.R[b], g_b.t[b]))
               for b in range(g_b.t.shape[0])]
        in_box[name] = [int(x.sum()) for x in per]
    return {"R": fetch_replicated(res.optimal_tf.R, mesh),
            "t": fetch_replicated(res.optimal_tf.t, mesh),
            "iterations": fetch_replicated(res.n_iterations, mesh),
            "termination": fetch_replicated(res.termination_reason, mesh),
            "quality": fetch_replicated(res.quality, mesh),
            "launches": launches, "gathers": gathers, "rows": int(g_b.t.shape[0]),
            "mesh": mesh.shape, "in_box": in_box,
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
