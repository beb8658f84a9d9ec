"""Point-to-plane matcher.

Port of ``mp2p_icp_tpu/matchers/point2plane.py`` (reference:
Matcher_Point2Plane.cpp:41-114, which asks a plane-capable map for the
nearest plane). Two branches:

- ``use_point_normals=True``: the global layer carries per-point normals
  fitted once (``ops/normals.py``); an iteration is a k=1 nearest
  neighbour and a gather, plane = (neighbour, its stored normal);
- otherwise a plane is fitted to the ``knn`` nearest neighbours of each
  local point and kept when l0 < plane_eigen_threshold * l2 (the
  reference's adaptive plane criterion).

On a map split over ranks (``spatial_axis``, parallel/spatial.py) the
neighbours' coordinates come back with the merged kNN result, and the
stored normals travel with them as its payload.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from mp2p_icp_tpu_torch.core.pairings import PairsPt2Pl, concat_blocks
from mp2p_icp_tpu_torch.matchers.base import (
    LayerMatch,
    MatchContext,
    Matcher,
    MatchState,
    neighbour_xyz,
    point_layers,
    transformed_local,
)
from mp2p_icp_tpu_torch.ops.eigen import estimate_points_eigen
from mp2p_icp_tpu_torch.ops.nn_bruteforce import knn_bruteforce


@dataclasses.dataclass(frozen=True)
class MatcherPoint2Plane(Matcher):
    """Params (reference: Matcher_Point2Plane.h:60-73)."""

    distance_threshold: float = 0.40
    knn: int = 7
    plane_eigen_threshold: float = 1e-2
    min_points_to_fit: int = 4
    allow_match_already_matched_points: bool = False
    layer_matches: Tuple[LayerMatch, ...] = (LayerMatch(),)
    # take the plane from the global layer's stored per-point normals
    # instead of a kNN re-fit on every iteration
    use_point_normals: bool = False
    # the map split over ranks: this rank's parallel.mesh.MeshAxis
    spatial_axis: object = None

    def search_radius(self) -> float:
        """The largest pairing distance, for the large-map crop's margin."""
        return self.distance_threshold

    def out_blocks(self, local_map):
        layers = point_layers(local_map)
        return {"pt2pl": sum(layers[lm.local_layer].capacity for lm in self.layer_matches)}

    def match(self, global_map, local_map, pose, state: MatchState, ctx: MatchContext):
        gate = self.gate(ctx.icp_iteration)
        l_layers, g_layers = point_layers(local_map), point_layers(global_map)
        new_local = dict(state.local_paired) if state is not None else None
        blocks = []
        potential = 0
        for lm in self.layer_matches:
            local = l_layers[lm.local_layer]
            glayer = g_layers[lm.global_layer]
            pts, valid = transformed_local(local, pose)
            potential = potential + local.count * int(gate)
            if state is not None and not self.allow_match_already_matched_points:
                valid = valid & ~state.local_paired[lm.local_layer]

            if self.use_point_normals:
                if glayer.normals is None:
                    raise ValueError(
                        "use_point_normals=True but global layer "
                        f"'{lm.global_layer}' has no normals channel — "
                        "run ops.normals.estimate_point_normals first"
                    )
                # on a sharded map the normals travel with the neighbours
                res = knn_bruteforce(
                    pts, valid, glayer.xyz, glayer.valid_mask(), k=1,
                    max_radius_sq=self.distance_threshold**2,
                    spatial_axis=self.spatial_axis, point_payload=glayer.normals,
                )
                centroid = neighbour_xyz(res, glayer)[:, 0]
                normal = (res.payload[:, 0] if hasattr(res, "payload") else
                          glayer.normals[torch.clamp(res.idx[:, 0], 0, glayer.capacity - 1).long()])
                has_plane = torch.sum(normal * normal, dim=-1) > 0.5
                keep = valid & res.valid[:, 0] & has_plane
            else:
                res = knn_bruteforce(
                    pts, valid, glayer.xyz, glayer.valid_mask(), k=self.knn,
                    max_radius_sq=self.distance_threshold**2,
                    spatial_axis=self.spatial_axis,
                )
                pe = estimate_points_eigen(neighbour_xyz(res, glayer), res.valid)
                centroid = pe.mean
                normal = pe.eigenvectors[:, :, 0]
                enough = pe.count >= self.min_points_to_fit
                is_plane = pe.eigenvalues[:, 0] < self.plane_eigen_threshold * pe.eigenvalues[:, 2]
                keep = valid & enough & is_plane

            w = torch.where(keep, lm.weight * gate, 0.0)
            rows = torch.arange(local.capacity, dtype=torch.int32, device=w.device)
            blocks.append(
                PairsPt2Pl(
                    local=local.xyz,
                    plane_centroid=centroid,
                    plane_normal=normal,
                    weight=w,
                    local_idx=torch.where(w > 0, rows, -1),
                )
            )
            if state is not None:
                new_local[lm.local_layer] = state.local_paired[lm.local_layer] | (w > 0)

        new_state = (
            MatchState(local_paired=new_local, global_paired=dict(state.global_paired))
            if state is not None else None
        )
        return dict(pt2pl=concat_blocks(blocks, PairsPt2Pl, pose.t.device)), new_state, potential
