"""Scan-to-map LiDAR odometry with a rolling map on the device.

Port of ``OdometryMapper`` of ``mp2p_icp_tpu/odometry.py`` (the reference
feeds mola_lidar_odometry the same way: per frame, generator -> deskew ->
decimate -> align against the accumulated map -> map update; its map update
is the sm2mm filter pipeline, sm2mm.cpp:159-249, whose insert step is
FilterMerge). One frame is:

1. the local filter pipeline (FilterDeskew with the frame's twist
   variables, FilterDecimateVoxels, ...);
2. the crop of the map to the box around the scan at the guess, and the
   ICP align against it;
3. the map update by the solved pose: either a FilterMerge plus the
   ``map_filters`` (sort-maintenance mode), or an insert into an
   incremental voxel hash map (``incremental_map_resolution``,
   ops/voxel_hash_map.py) with normals fitted only for the points that
   entered the map, which ``MatcherPoint2Plane(use_point_normals=True)``
   reads.

The JAX package compiles the frame into one program and donates the map to
it. Here the frame is plain calls on the device of the frames' tensors;
whether a frame merges is known on the host (``merge_every``), so a frame
that does not merge skips the map update. The pose chain stays on the
device; the ICP loop reads its termination flags once per iteration.

One step serves one stream and a fleet. Every stage of the frame takes
leading batch axes (filters, transform, map insert, compaction, normals
fit), so ``BatchedOdometryMapper`` hands the same ``_step`` stacked inputs:
B streams with their own maps, poses and twists advance one frame index at
a time, each ICP iteration and each normals fit is one launch of the
batched kNN sweep for all streams, and the host reads one flag per
iteration (and per probe round of the map insert) for the whole fleet. A
fleet frame runs as many ICP iterations as its slowest stream; a stream
that has stopped keeps its pose.

``run_offline`` (both classes) is ``run`` on inputs staged once: the frames
stacked into one pytree on the device, the twists in one tensor. In the JAX
package its point is one dispatch for the whole sequence; here the frame
loop stays on the host either way (the ICP loop reads its flag every
iteration), so the mode saves only the per-call staging of ``run`` and
changes no result.

Equality contracts (tests/test_torch_odometry.py, tests/test_torch_fleet.py):
both map modes keep the same FirstPoint winner per voxel on the same poses,
the port tracks the JAX package on the same frames, a fleet's streams equal
their sequential runs, and ``run_offline`` equals ``run``.

``SpatialOdometryMapper`` runs the same step with the map split over the
ranks of the mesh's ``space`` axis: each rank keeps the voxels that hash to
it, sweeps only its shard in the align, and the k-lists are merged after
one all_gather per kNN (``parallel/spatial.py``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.utils._pytree as pytree

from mp2p_icp_tpu_torch.core import se3
from mp2p_icp_tpu_torch.core.pointcloud import PointCloud, scatter_rows
from mp2p_icp_tpu_torch.core.se3 import Pose
from mp2p_icp_tpu_torch.filters import FilterMerge, apply_filter_pipeline
from mp2p_icp_tpu_torch.filters.common import compact
from mp2p_icp_tpu_torch.ops.normals import estimate_point_normals
from mp2p_icp_tpu_torch.ops.voxel_hash_map import empty_voxel_hash_map, hash_map_insert
from mp2p_icp_tpu_torch.parallel.batch import _align_batched, crop_batched, stack_pytrees
from mp2p_icp_tpu_torch.parallel.mesh import all_gather
from mp2p_icp_tpu_torch.parallel.spatial import spatial_icp
from mp2p_icp_tpu_torch.utils.profiler import profile_scope, spanned

_TWIST_NAMES = ("vx", "vy", "vz", "wx", "wy", "wz")


@dataclasses.dataclass
class OdometryMapper:
    """Drives the frame step over a scan stream.

    icp/params: the ICP modules + ICPParameters (the crop path is
      recommended: params.crop_capacity < map_capacity).
    filters: per-frame local filter pipeline (deskew/decimate/...); its
      output must contain ``local_layer``.
    local_layer: the filtered layer registered against the map and merged
      into it (the sm2mm pattern: the decimated deskewed cloud).
    map_layer: the global map layer name the matchers reference.
    map_capacity: fixed rolling-map buffer size (overflow points drop,
      FilterMerge semantics).
    """

    icp: object
    params: object
    filters: Sequence = ()
    local_layer: str = "decimated"
    map_layer: str = "map"
    map_capacity: int = 1 << 20
    # merge only every k-th frame into the map (keyframing); every frame
    # still aligns. 1 = merge all.
    merge_every: int = 1
    # filters applied to the map layer after every merge (the reference's
    # sm2mm 'final_filters'). A FilterDecimateVoxels(FIRST_POINT) here is
    # the standard map maintenance: it collapses the ghost layers each
    # overlapping scan deposits at its slightly drifted pose and bounds the
    # map at one point per voxel.
    map_filters: Sequence = ()
    # incremental map maintenance (ops/voxel_hash_map.py): the rolling map
    # is a voxel hash map at this resolution, and merge + FirstPoint
    # maintenance become one insert of the new points. Same winner per
    # voxel as map_filters = [FilterDecimateVoxels(FIRST_POINT, resolution)]
    # (the earliest merged point); mutually exclusive with map_filters.
    incremental_map_resolution: Optional[float] = None
    map_table_size: Optional[int] = None
    # Fit per-point normals for newly merged map points against the
    # accumulated map + the new scan (ops/normals.py), once per frame; pair
    # with MatcherPoint2Plane(use_point_normals=True). 0 = off.
    normals_knn: int = 0
    normals_radius: float = 1.5
    normals_eigen_threshold: float = 1e-2
    # incremental mode fits normals only for the points that entered the
    # map in this frame, compacted to this query capacity. Frames that
    # insert more new voxels than this (the first frames of a run) leave
    # the overflow without normals.
    normals_query_capacity: int = 2048

    def __post_init__(self):
        if self.incremental_map_resolution is not None and self.map_filters:
            raise ValueError(
                "incremental_map_resolution replaces map_filters — "
                "configure one or the other"
            )

    @property
    def _incremental(self) -> bool:
        return self.incremental_map_resolution is not None

    def _map_pc(self, map_state) -> PointCloud:
        """The PointCloud view of the map state that the align sees."""
        return map_state.pc if self._incremental else map_state

    def _merge_filter(self) -> FilterMerge:
        return FilterMerge(
            input_pointcloud_layer="__world",
            target_layer=self.map_layer,
            target_capacity=self.map_capacity,
        )

    def _local(self, raw_layers, twist) -> PointCloud:
        """The frame's filtered local layer, the twist [..., 6] feeding the
        deskew variables as 0-d tensors (a fleet's as [B] tensors)."""
        variables = {name: twist[..., i] for i, name in enumerate(_TWIST_NAMES)}
        return apply_filter_pipeline(self.filters, raw_layers, variables)[self.local_layer]

    def _candidates(self, near_map: PointCloud, src_world: PointCloud):
        """The normals fit's candidate pool: the cropped map plus the scan.
        The crop covers the scan's box and a margin, so every new point's
        neighbourhood lies inside it."""
        cand = PointCloud(
            xyz=torch.cat([near_map.xyz, src_world.xyz], dim=-2),
            count=near_map.count + src_world.count,
        )
        return cand, torch.cat([near_map.valid_mask(), src_world.valid_mask()], dim=-1)

    def _fit(self, pc: PointCloud, source=None, source_valid=None) -> PointCloud:
        return estimate_point_normals(
            pc,
            knn=self.normals_knn,
            max_radius=self.normals_radius,
            plane_eigen_threshold=self.normals_eigen_threshold,
            source=source,
            source_valid=source_valid,
        )

    # ------------------------------------------------------------------
    @spanned("odometry.step")  # the frame's root span
    def _step(self, map_state, raw_layers, prev_pose, rel_prev, twist,
              twist_prev, do_merge: bool, dt: Optional[float]):
        """One frame -> (new_map_state, ICPResults, rel_new). map_state is
        a PointCloud (sort-maintenance mode) or a VoxelHashMapState
        (incremental mode). The guess is the motion model
        prev_pose·exp(dt·twist_prev) when ``dt`` is given, else the
        previous relative pose.

        Stacked inputs (poses [B, 3, 3] / [B, 3], twists [B, 6], layers
        [B, C, 3], a stacked map state) advance B streams by one frame; the
        results then carry a leading B and ``do_merge`` holds for all."""
        batch = prev_pose.t.shape[:-1]
        map_pc = self._map_pc(map_state)
        seed_rel = se3.exp(dt * twist_prev) if dt is not None else rel_prev
        guess = se3.compose(prev_pose, seed_rel)
        src = self._local(raw_layers, twist)
        l_layers = {self.local_layer: src}
        # crop once: for the align and, below, as the candidate pool of the
        # normals fit
        g_layers = {self.map_layer: map_pc}
        if batch:
            g_crop, gidx, _ = crop_batched(self.icp, self.params, g_layers, l_layers, guess)
            res = _align_batched(self.icp, self.params, l_layers, g_crop, guess, gidx)
        else:
            g_crop, gidx = self.icp._crop_globals(self.params, g_layers, l_layers, guess)
            res = self.icp._align_core(self.params, g_crop, l_layers, guess, None, gidx)
        pose = res.optimal_tf
        rel_new = se3.compose(se3.inverse(prev_pose), pose)
        if not do_merge:
            return map_state, res, rel_new

        src_world = src.transformed(pose)
        near_map = g_crop[self.map_layer]
        if not self._incremental:
            if self.normals_knn:
                src_world = self._fit(src_world, *self._candidates(near_map, src_world))
            layers = self._merge_filter()({"__world": src_world, self.map_layer: map_pc})
            layers = apply_filter_pipeline(self.map_filters, layers, None)
            return layers[self.map_layer], res, rel_new

        return self._insert(map_state, src_world, near_map), res, rel_new

    def _insert(self, map_state, src_world: PointCloud, near_map: PointCloud, valid=None):
        """Incremental mode's map update: the insert of ``src_world``'s
        valid points (or of those of ``valid``) into the voxel hash map,
        then normals fitted only for this frame's newly inserted map points:
        the winners compacted to a small query block, fitted against the
        cropped map + the whole scan, and scattered into the map's normals
        channel. The same map normals as a fit of every scan point (same
        candidates): the others' fits were discarded."""
        batch = src_world.xyz.shape[:-2]
        merged, dest = hash_map_insert(
            map_state, src_world, self.incremental_map_resolution, valid=valid, with_dest=True
        )
        if self.normals_knn:
            C = merged.pc.capacity
            cap_n = self.normals_query_capacity
            win = dest < C
            rank = torch.cumsum(win, dim=-1) - 1
            slot = torch.where(win & (rank < cap_n), rank, cap_n)
            q_xyz = scatter_rows(
                src_world.xyz.new_full(batch + (cap_n, 3), PointCloud.PAD_VALUE),
                slot, src_world.xyz)
            d_map = scatter_rows(dest.new_full(batch + (cap_n,), C), slot, dest)
            n_q = torch.clamp(torch.sum(win, dim=-1, dtype=torch.int32), max=cap_n)
            qfit = self._fit(PointCloud(xyz=q_xyz, count=n_q),
                             *self._candidates(near_map, src_world))
            merged = merged._replace(pc=dataclasses.replace(
                merged.pc, normals=scatter_rows(merged.pc.normals, d_map, qfit.normals)))
        return merged

    # ------------------------------------------------------------------
    def seed_map(self, raw_layers, pose: Pose, twist=None):
        """Initialise the map from frame 0 (filtered, world-transformed).
        Incremental mode returns a VoxelHashMapState."""
        device = pose.t.device
        tw = (torch.zeros(6, device=device) if twist is None
              else torch.as_tensor(twist, dtype=torch.float32, device=device))
        src = self._local(raw_layers, tw)
        src_world = src.transformed(pose)
        if self.normals_knn:
            # frame 0: only the scan itself is available
            src_world = self._fit(src_world)
        if self._incremental:
            # the channel flags are those of the filtered cloud: a normals
            # channel first appears on the map with the first insert
            st = empty_voxel_hash_map(
                self.map_capacity,
                table_size=self.map_table_size,
                intensity=src.intensity is not None,
                ring=src.ring is not None,
                time=src.time is not None,
                normals=src.normals is not None,
                device=device,
            )
            return hash_map_insert(st, src_world, self.incremental_map_resolution)
        layers = self._merge_filter()({"__world": src_world})
        return apply_filter_pipeline(self.map_filters, layers, None)[self.map_layer]

    # ------------------------------------------------------------------
    def _drive(self, map_state, pose0: Pose, n: int, frame_of: Callable, twists,
               dt: Optional[float], progress_every: int = 0, step=None) -> Dict:
        """Frames 1 ... n-1 through ``step`` (default ``_step``), for one
        stream, a fleet (everything stacked) or one rank's shard of a map.
        ``frame_of(i)`` gives frame i's raw layers; ``twists`` is one [n,
        ..., 6] tensor on the device or None. Poses, qualities, iteration
        counts and map counts are written into tensors on the device, frame
        by frame, and fetched after the last frame.
        Returns numpy arrays with the frame axis first: "R" [n-1, ..., 3, 3],
        "t", "qualities", "iterations", "map_counts", and "frame_seconds"
        [n-1], "elapsed", "map_state"."""
        device, batch = pose0.t.device, pose0.t.shape[:-1]
        step_dt = dt if (dt is not None and twists is not None) else None
        zeros6 = torch.zeros(batch + (6,), device=device)

        def twist_of(i):
            return zeros6 if twists is None else twists[i]

        # whether frame i merges is decided on the host: the flags never go
        # to the device
        merges = [self.merge_every <= 1 or i % self.merge_every == 0 for i in range(n)]
        steps = max(n - 1, 0)
        Rs = torch.empty((steps,) + batch + (3, 3), device=device)
        ts = torch.empty((steps,) + batch + (3,), device=device)
        qs = torch.empty((steps,) + batch, device=device)
        its = torch.empty((steps,) + batch, dtype=torch.int32, device=device)
        counts = torch.empty((steps,) + batch, dtype=torch.int32, device=device)
        abs_pose = pose0
        rel_prev = Pose(*(x.expand(batch + x.shape) for x in se3.identity(device=device)))
        frame_s = []
        t0 = time.perf_counter()
        for i in range(1, n):
            t_frame = time.perf_counter()
            map_state, res, rel_prev = (step or self._step)(
                map_state, frame_of(i), abs_pose, rel_prev, twist_of(i),
                twist_of(i - 1), merges[i], step_dt,
            )
            abs_pose = res.optimal_tf
            Rs[i - 1], ts[i - 1], qs[i - 1] = abs_pose.R, abs_pose.t, res.quality
            with profile_scope("sync.drive_iterations"):
                # one stream's count is a host int: a copy to the card, which syncs
                its[i - 1] = res.n_iterations
            counts[i - 1] = self._map_pc(map_state).count
            if progress_every and i % progress_every == 0:
                first = abs_pose.t.reshape(-1)[0]
                with profile_scope("sync.progress"):
                    float(first)  # waits for the frame's map update
            frame_s.append(time.perf_counter() - t_frame)
        # the fetch, enqueued last, bounds every enqueued step
        with profile_scope("sync.drive_fetch"):
            out = {"R": Rs.cpu().numpy(), "t": ts.cpu().numpy(),
                   "qualities": qs.cpu().numpy(), "iterations": its.cpu().numpy(),
                   "map_counts": counts.cpu().numpy()}
        out.update(elapsed=time.perf_counter() - t0, map_state=map_state,
                   frame_seconds=np.asarray(frame_s, np.float64))
        return out

    def _twist_table(self, twists, device):
        """The per-frame twists as one [n, 6] tensor on the device."""
        if twists is None:
            return None
        with profile_scope("sync.twist_table"):
            return torch.as_tensor(np.asarray(twists, np.float32), device=device)

    def _results(self, drive: Dict, pose0: Pose) -> Dict:
        n = len(drive["R"]) + 1
        mats = np.tile(np.eye(4, dtype=np.float64), (n, 1, 1))
        with profile_scope("sync.results"):
            mats[0, :3, :3], mats[0, :3, 3] = pose0.R.cpu().numpy(), pose0.t.cpu().numpy()
        mats[1:, :3, :3], mats[1:, :3, 3] = drive["R"], drive["t"]
        return {
            "poses": mats,
            "map": self._map_pc(drive["map_state"]),
            "map_state": drive["map_state"],
            "scans_per_s": (n - 1) / max(drive["elapsed"], 1e-9),
            "qualities": drive["qualities"],
            "iterations": drive["iterations"],
            "frame_seconds": drive["frame_seconds"],
            "map_counts": drive["map_counts"],
        }

    def run(
        self,
        frames: Sequence[Dict[str, PointCloud]],
        twists: Optional[Sequence] = None,
        initial_pose: Optional[Pose] = None,
        progress_every: int = 0,
        dt: Optional[float] = None,
    ) -> Dict:
        """Full odometry over raw frames (dicts of PointCloud layers), on
        the device of the frames' tensors.

        twists: optional per-frame body twists fed to the deskew variables
        (a deployment takes them from the IMU or a velocity estimator).

        dt: scan period. When given together with twists, the align guess
        is the motion-model prediction pose_{i-1}·exp(dt·twist_{i-1})
        (twists[i-1] covers [i-1, i]). Without it the guess is the previous
        estimated relative pose (constant velocity on estimates), which
        feeds estimation error back into the seed.

        Returns {"poses": [N,4,4], "map": PointCloud, "map_state",
        "scans_per_s", "qualities": [N-1]} and, per frame after the first,
        "iterations" (ICP iterations), "frame_seconds" (host clock; the
        last ICP iteration of a frame reads the device, its map update may
        still run) and "map_counts" (map points after the frame)."""
        device = next(iter(frames[0].values())).device
        tw = self._twist_table(twists, device)
        pose0 = initial_pose or se3.identity(device=device)
        map_state = self.seed_map(frames[0], pose0, None if tw is None else tw[0])
        return self._results(self._drive(
            map_state, pose0, len(frames), frames.__getitem__, tw, dt, progress_every), pose0)

    def run_offline(
        self,
        frames: Sequence[Dict[str, PointCloud]],
        twists: Optional[Sequence] = None,
        initial_pose: Optional[Pose] = None,
        dt: Optional[float] = None,
    ) -> Dict:
        """Same contract and results as ``run``, with the inputs staged
        once: frames 1 ... N-1 stacked into one pytree on the device
        ([N-1, C, ...] per field), the twists in one tensor (the merge
        flags stay on the host, which decides them); poses and qualities
        are written into preallocated device tensors and fetched after the
        last frame.

        In the JAX package this mode is one dispatch for the whole
        sequence. Here the ICP loop still reads its termination flag once
        per iteration, so the frame loop stays on the host and the mode
        saves none of the per-iteration launches or syncs: it is ``run``
        without per-frame input handling."""
        device = next(iter(frames[0].values())).device
        tw = self._twist_table(twists, device)
        pose0 = initial_pose or se3.identity(device=device)
        map_state = self.seed_map(frames[0], pose0, None if tw is None else tw[0])
        frames_x = stack_pytrees(list(frames[1:])) if len(frames) > 1 else None

        def frame_of(i):
            return pytree.tree_map(lambda x: x[i - 1], frames_x)

        return self._results(self._drive(
            map_state, pose0, len(frames), frame_of, tw, dt), pose0)


@dataclasses.dataclass
class BatchedOdometryMapper:
    """B independent odometry streams, one frame index at a time: fleet or
    multi-robot mapping on one card (port of ``BatchedOdometryMapper`` of
    the JAX package, which vmaps its fused step).

    One stream keeps the card idle most of a frame: the host's launches
    set the pace, and an ICP iteration costs the host the same for one
    problem and for B. The fleet runs ``mapper._step`` on stacked inputs:
    per-stream maps, poses and twists, one batched kNN sweep per ICP
    iteration and per normals fit for all streams. Whether a frame merges
    is one host flag for the whole fleet. Each stream's result equals its
    own ``OdometryMapper.run``.
    """

    mapper: OdometryMapper

    def _stage(self, streams, twists, initial_poses):
        """Seeds every stream's map and stacks the per-stream state.
        Returns (stacked map state, stacked pose0 [B], twists [n, B, 6] or
        None, n)."""
        m = self.mapper
        B, n = len(streams), len(streams[0])
        if any(len(s) != n for s in streams):
            raise ValueError("the streams of a fleet must have equal lengths")
        if twists is not None and len(twists) != B:
            raise ValueError(f"{len(twists)} twist sequences for {B} streams")
        device = next(iter(streams[0][0].values())).device
        poses0 = initial_poses or [se3.identity(device=device) for _ in range(B)]
        tw = None
        if twists is not None:
            with profile_scope("sync.twist_table"):
                tw = torch.as_tensor(np.asarray(twists, np.float32), device=device)
            tw = tw.transpose(0, 1)
        maps = stack_pytrees([
            m.seed_map(streams[b][0], poses0[b], None if tw is None else tw[0, b])
            for b in range(B)])
        return maps, stack_pytrees(list(poses0)), tw, n

    def _results(self, drive: Dict, pose0: Pose) -> Dict:
        """The fleet's results with the stream axis first."""
        m = self.mapper
        steps, B = drive["t"].shape[:2]
        mats = np.tile(np.eye(4, dtype=np.float64), (B, steps + 1, 1, 1))
        with profile_scope("sync.results"):
            mats[:, 0, :3, :3], mats[:, 0, :3, 3] = pose0.R.cpu().numpy(), pose0.t.cpu().numpy()
        mats[:, 1:, :3, :3] = drive["R"].transpose(1, 0, 2, 3)
        mats[:, 1:, :3, 3] = drive["t"].transpose(1, 0, 2)
        return {
            "poses": mats,
            "maps": m._map_pc(drive["map_state"]),
            "map_states": drive["map_state"],
            "scans_per_s": B * steps / max(drive["elapsed"], 1e-9),
            "qualities": drive["qualities"].T,
            "iterations": drive["iterations"].T,
            "frame_seconds": drive["frame_seconds"],
            "map_counts": drive["map_counts"].T,
        }

    def run(self, streams, twists=None, initial_poses=None, dt: Optional[float] = None):
        """streams: list of B frame sequences of equal length; twists:
        optional list of B per-frame twist sequences; initial_poses: list
        of B poses. Returns {"poses": [B, N, 4, 4], "maps": the stacked
        map PointCloud, "map_states", "scans_per_s": B·(N-1) / elapsed,
        "qualities": [B, N-1]} and, as ``OdometryMapper.run``,
        "iterations" and "map_counts" [B, N-1] and "frame_seconds" [N-1]
        (one fleet frame serves all streams)."""
        maps, pose0, tw, n = self._stage(streams, twists, initial_poses)
        frames_dev = [None] + [stack_pytrees([s[i] for s in streams]) for i in range(1, n)]
        return self._results(self.mapper._drive(
            maps, pose0, n, frames_dev.__getitem__, tw, dt), pose0)

    def run_offline(self, streams, twists=None, initial_poses=None,
                    dt: Optional[float] = None):
        """Same contract and results as ``run``, with the whole fleet's
        frames stacked into one pytree on the device ([N-1, B, C, ...] per
        field). As for ``OdometryMapper.run_offline``, the frame loop stays
        on the host: the mode saves no launch and no sync."""
        maps, pose0, tw, n = self._stage(streams, twists, initial_poses)
        frames_x = stack_pytrees([stack_pytrees([s[i] for s in streams])
                                  for i in range(1, n)]) if n > 1 else None

        def frame_of(i):
            return pytree.tree_map(lambda x: x[i - 1], frames_x)

        return self._results(self.mapper._drive(maps, pose0, n, frame_of, tw, dt), pose0)


def voxel_owner(xyz: torch.Tensor, resolution: float, n_shards: int) -> torch.Tensor:
    """[..., N] int64: the shard that owns each point's voxel,
    teschner_hash(floor(xyz · (1 / resolution))) % n_shards with the hash
    masked to 31 bits. Computed in int64, whose low 31 bits are those of the JAX
    package's wrapping int32 products (odometry.py:823-827), and of its
    numpy int64 seed (:942-947)."""
    cell = torch.floor(xyz * (1.0 / resolution)).to(torch.int64)
    h = (cell[..., 0] * 73856093 ^ cell[..., 1] * 19349663 ^ cell[..., 2] * 83492791) & 0x7FFFFFFF
    return h % n_shards


@dataclasses.dataclass
class SpatialOdometryMapper:
    """Map-building odometry with the rolling map split over the ranks of
    the ``space`` axis: odometry over maps larger than one device (port of
    the JAX package's class). Every rank of the axis runs ``run`` on the
    same frames.

    - align: each rank sweeps only its map shard; the per-query k-lists
      are merged after one all_gather (``parallel/spatial.py``), so every
      rank gets the same pairings and the same pose;
    - merge: voxel ownership. A voxel of ``ownership_resolution`` belongs
      to rank ``voxel_owner(...)``; each rank merges only the frame's
      points of its voxels into its own map (capacity map_capacity / n)
      and runs its own maintenance (FirstPoint filters, or the incremental
      hash insert and the normals fit of its new voxels). No voxel is ever
      on two shards.
    """

    mapper: OdometryMapper
    mesh: object
    axis: str = "space"
    # ownership voxel size; MUST match the map-maintenance resolution so
    # that a shard's FirstPoint maintenance is also globally exact
    ownership_resolution: float = 0.5

    def __post_init__(self):
        m = self.mapper
        self._axis = self.mesh.axis(self.axis)
        self._shard_cap = -(-m.map_capacity // self._axis.size)
        self._icp = spatial_icp(m.icp, self._axis)

    def _owned(self, xyz: torch.Tensor) -> torch.Tensor:
        return voxel_owner(xyz, self.ownership_resolution, self._axis.size) == self._axis.rank

    @spanned("odometry.step")
    def _step(self, map_state, raw_layers, prev_pose, rel_prev, twist, twist_prev,
              do_merge: bool, dt: Optional[float]):
        """One frame on this rank's shard -> (new shard state, ICPResults,
        rel_new); the results are the same on every rank."""
        m = self.mapper
        map_pc = m._map_pc(map_state)
        seed_rel = se3.exp(dt * twist_prev) if dt is not None else rel_prev
        guess = se3.compose(prev_pose, seed_rel)
        src = m._local(raw_layers, twist)
        l_layers = {m.local_layer: src}
        g_crop, _ = self._icp._crop_globals(m.params, {m.map_layer: map_pc}, l_layers, guess)
        res = self._icp._align_core(m.params, g_crop, l_layers, guess, None)
        pose = res.optimal_tf
        rel_new = se3.compose(se3.inverse(prev_pose), pose)
        if not do_merge:
            return map_state, res, rel_new
        src_world = src.transformed(pose)
        own = self._owned(src_world.xyz)
        if m._incremental:
            return (m._insert(map_state, src_world, g_crop[m.map_layer],
                              valid=src_world.valid_mask() & own), res, rel_new)
        merge = FilterMerge(input_pointcloud_layer="__world", target_layer=m.map_layer,
                            target_capacity=self._shard_cap)
        layers = merge({"__world": compact(src_world, own), m.map_layer: map_pc})
        map_filters = [dataclasses.replace(f, output_capacity=self._shard_cap)
                       if hasattr(f, "output_capacity") else f for f in m.map_filters]
        return apply_filter_pipeline(map_filters, layers, None)[m.map_layer], res, rel_new

    def seed_map(self, raw_layers, pose: Pose, twist=None):
        """This rank's shard of the frame-0 map: the unsharded seed, its
        points of this rank's voxels kept (in order, up to the shard's
        capacity). Incremental mode returns a VoxelHashMapState."""
        m = self.mapper
        single = m._map_pc(m.seed_map(raw_layers, pose, twist))
        owned = compact(single, self._owned(single.xyz))
        cap = self._shard_cap

        def cut(ch):
            return None if ch is None else ch[:cap]

        shard = PointCloud(xyz=owned.xyz[:cap], count=torch.clamp(owned.count, max=cap),
                           intensity=cut(owned.intensity), ring=cut(owned.ring),
                           time=cut(owned.time))
        if not m._incremental:
            return shard
        if single.normals is not None:  # compact drops the normals: take them by row
            keep = self._owned(single.xyz) & single.valid_mask()
            rows = torch.nonzero(keep)[:cap, 0]
            normals = torch.zeros((cap, 3), device=single.xyz.device)
            shard = dataclasses.replace(shard, normals=normals.index_copy(
                0, torch.arange(rows.shape[0], device=rows.device), single.normals[rows]))
        st = empty_voxel_hash_map(
            cap,
            intensity=single.intensity is not None,
            ring=single.ring is not None,
            time=single.time is not None,
            normals=single.normals is not None,
            device=single.xyz.device,
        )
        return hash_map_insert(st, shard, m.incremental_map_resolution)

    def gather_map(self, map_state) -> PointCloud:
        """Every rank's shard, stacked in rank order: [n, shard capacity, ...]
        per field."""
        pc = self.mapper._map_pc(map_state)
        return pytree.tree_map(lambda x: all_gather(x, self._axis), pc)

    def run(self, frames, twists=None, initial_pose=None, dt: Optional[float] = None) -> Dict:
        """``OdometryMapper.run``'s contract, on every rank of the axis with
        the same frames; "map" is the stacked map of all shards
        ([n, shard capacity, ...]), "map_state" this rank's shard."""
        m = self.mapper
        device = next(iter(frames[0].values())).device
        tw = m._twist_table(twists, device)
        pose0 = initial_pose or se3.identity(device=device)
        state = self.seed_map(frames[0], pose0, None if tw is None else tw[0])
        out = m._results(m._drive(state, pose0, len(frames), frames.__getitem__, tw, dt,
                                  step=self._step), pose0)
        out["map"] = self.gather_map(out["map_state"])
        return out


def reference_pipeline_map(
    mapper: OdometryMapper,
    frames: Sequence[Dict[str, PointCloud]],
    poses: np.ndarray,
    twists: Optional[Sequence] = None,
) -> PointCloud:
    """The sm2mm-style host path: the map rebuilt by running the frame
    filter pipeline on each frame and FilterMerge with the robot-pose
    variables (FilterMerge.cpp:96-108, input_layer_in_local_coordinates),
    then the map filters: the equality oracle of the fused merge."""
    merge = FilterMerge(
        input_pointcloud_layer=mapper.local_layer,
        target_layer=mapper.map_layer,
        target_capacity=mapper.map_capacity,
        use_robot_pose=True,
    )
    layers_acc: Dict[str, PointCloud] = {}
    for i, frame in enumerate(frames):
        R, t = poses[i, :3, :3], poses[i, :3, 3]
        yaw, pitch, roll = _rot_to_ypr(R)
        variables = {"robot_x": float(t[0]), "robot_y": float(t[1]), "robot_z": float(t[2]),
                     "robot_yaw": yaw, "robot_pitch": pitch, "robot_roll": roll}
        if twists is not None:
            variables.update({k: float(v) for k, v in zip(_TWIST_NAMES, twists[i])})
        local = apply_filter_pipeline(tuple(mapper.filters), dict(frame), variables)
        layers_acc[mapper.local_layer] = local[mapper.local_layer]
        layers_acc = merge(layers_acc, variables)
        layers_acc = apply_filter_pipeline(tuple(mapper.map_filters), layers_acc, None)
    return layers_acc[mapper.map_layer]


def _rot_to_ypr(R: np.ndarray):
    """ZYX yaw / pitch / roll of a rotation matrix (host helper)."""
    pitch = -np.arcsin(np.clip(R[2, 0], -1.0, 1.0))
    if abs(R[2, 0]) < 0.99999:
        yaw = np.arctan2(R[1, 0], R[0, 0])
        roll = np.arctan2(R[2, 1], R[2, 2])
    else:  # gimbal lock
        yaw = np.arctan2(-R[0, 1], R[1, 1])
        roll = 0.0
    return float(yaw), float(pitch), float(roll)
