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

Equality contracts (tests/test_torch_odometry.py): both map modes keep the
same FirstPoint winner per voxel on the same poses, and the port tracks the
JAX package on the same frames.

Not ported yet: ``run_offline``, ``BatchedOdometryMapper``,
``SpatialOdometryMapper``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from mp2p_icp_tpu_torch.core import se3
from mp2p_icp_tpu_torch.core.pointcloud import PointCloud, scatter_rows
from mp2p_icp_tpu_torch.core.se3 import Pose
from mp2p_icp_tpu_torch.filters import FilterMerge, apply_filter_pipeline
from mp2p_icp_tpu_torch.ops.normals import estimate_point_normals
from mp2p_icp_tpu_torch.ops.voxel_hash_map import empty_voxel_hash_map, hash_map_insert

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
        """The frame's filtered local layer, the twist feeding the deskew
        variables as 0-d tensors."""
        variables = {name: twist[i] for i, name in enumerate(_TWIST_NAMES)}
        return apply_filter_pipeline(self.filters, raw_layers, variables)[self.local_layer]

    def _candidates(self, near_map: PointCloud, src_world: PointCloud):
        """The normals fit's candidate pool: the cropped map plus the scan.
        The crop covers the scan's box and a margin, so every new point's
        neighbourhood lies inside it."""
        cand = PointCloud(
            xyz=torch.cat([near_map.xyz, src_world.xyz]),
            count=near_map.count + src_world.count,
        )
        return cand, torch.cat([near_map.valid_mask(), src_world.valid_mask()])

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
    def _step(self, map_state, raw_layers, prev_pose, rel_prev, twist,
              twist_prev, do_merge: bool, dt: Optional[float]):
        """One frame -> (new_map_state, ICPResults, rel_new). map_state is
        a PointCloud (sort-maintenance mode) or a VoxelHashMapState
        (incremental mode). The guess is the motion model
        prev_pose·exp(dt·twist_prev) when ``dt`` is given, else the
        previous relative pose."""
        matchers = tuple(self.icp.matchers)
        map_pc = self._map_pc(map_state)
        seed_rel = se3.exp(dt * twist_prev) if dt is not None else rel_prev
        guess = se3.compose(prev_pose, seed_rel)
        src = self._local(raw_layers, twist)
        l_layers = {self.local_layer: src}
        # crop once: for the align and, below, as the candidate pool of the
        # normals fit
        g_crop, gidx = self.icp._crop_globals(
            self.params, {self.map_layer: map_pc}, l_layers, guess
        )
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

        merged, dest = hash_map_insert(
            map_state, src_world, self.incremental_map_resolution, with_dest=True
        )
        if self.normals_knn:
            # fit normals only for this frame's newly inserted map points:
            # compact the winners to a small query block, fit against the
            # cropped map + the scan, and scatter the results into the
            # map's normals channel. The same map normals as a fit of every
            # scan point (same candidates): the others' fits were discarded.
            C = merged.pc.capacity
            cap_n = self.normals_query_capacity
            win = dest < C
            rank = torch.cumsum(win, dim=0) - 1
            slot = torch.where(win & (rank < cap_n), rank, cap_n)
            q_xyz = scatter_rows(
                src_world.xyz.new_full((cap_n, 3), PointCloud.PAD_VALUE), slot, src_world.xyz)
            d_map = scatter_rows(dest.new_full((cap_n,), C), slot, dest)
            n_q = torch.clamp(torch.sum(win, dtype=torch.int32), max=cap_n)
            qfit = self._fit(PointCloud(xyz=q_xyz, count=n_q),
                             *self._candidates(near_map, src_world))
            merged = merged._replace(pc=dataclasses.replace(
                merged.pc, normals=scatter_rows(merged.pc.normals, d_map, qfit.normals)))
        return merged, res, rel_new

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
    def run_offline(self, *args, **kwargs):
        raise NotImplementedError(
            "OdometryMapper.run_offline (the whole sequence as one program) is "
            "not ported yet; use run()"
        )

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
        step_dt = dt if (dt is not None and twists is not None) else None
        n = len(frames)
        zeros6 = torch.zeros(6, device=device)
        tw_dev = (
            [torch.as_tensor(np.asarray(t, np.float32), device=device) for t in twists]
            if twists is not None else None
        )

        def twist_of(i):
            return zeros6 if tw_dev is None else tw_dev[i]

        pose0 = initial_pose or se3.identity(device=device)
        map_state = self.seed_map(frames[0], pose0, twist_of(0))
        abs_pose = pose0
        rel_prev = se3.identity(device=device)
        poses: List[Pose] = [pose0]
        qualities, iterations, frame_s, counts = [], [], [], []
        t0 = time.perf_counter()
        for i in range(1, n):
            t_frame = time.perf_counter()
            do_merge = self.merge_every <= 1 or i % self.merge_every == 0
            map_state, res, rel_prev = self._step(
                map_state, frames[i], abs_pose, rel_prev, twist_of(i),
                twist_of(i - 1), do_merge, step_dt,
            )
            abs_pose = res.optimal_tf
            poses.append(abs_pose)
            qualities.append(res.quality)
            iterations.append(res.n_iterations)
            counts.append(self._map_pc(map_state).count)
            if progress_every and i % progress_every == 0:
                float(abs_pose.t[0])  # waits for the frame's map update
            frame_s.append(time.perf_counter() - t_frame)
        # one final fetch, enqueued last, bounds every enqueued step
        mats = np.tile(np.eye(4, dtype=np.float64), (n, 1, 1))
        mats[:, :3, :3] = torch.stack([p.R for p in poses]).cpu().numpy()
        mats[:, :3, 3] = torch.stack([p.t for p in poses]).cpu().numpy()
        elapsed = time.perf_counter() - t0

        def fetch(xs, dtype):
            if not xs:
                return np.zeros(0, dtype)
            return torch.stack(xs).cpu().numpy().astype(dtype)

        return {
            "poses": mats,
            "map": self._map_pc(map_state),
            "map_state": map_state,
            "scans_per_s": (n - 1) / max(elapsed, 1e-9),
            "qualities": fetch(qualities, np.float32),
            "iterations": np.asarray(iterations, np.int32),
            "frame_seconds": np.asarray(frame_s, np.float64),
            "map_counts": fetch(counts, np.int32),
        }
