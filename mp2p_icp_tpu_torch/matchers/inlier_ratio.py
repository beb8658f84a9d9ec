"""Inlier-ratio matcher: keep the best fraction of nearest-neighbour pairs.

Port of ``mp2p_icp_tpu/matchers/inlier_ratio.py`` (reference:
Matcher_Points_InlierRatio.cpp:41-143): the nearest global point of each
transformed local point, with no radius; the pairs are sorted by distance
and the best ``inliers_ratio`` of them kept. As in the JAX package the
sort-and-truncate is a masked quantile: the distance at rank
ceil(ratio * n_valid) of the sorted [Q] distances is the cut, and every
pair at or below it is kept (so pairs tied at the cut all stay).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from mp2p_icp_tpu_torch.core.pairings import PairsPt2Pt, concat_blocks
from mp2p_icp_tpu_torch.matchers.base import (
    LayerMatch,
    MatchContext,
    Matcher,
    MatchState,
    neighbour_xyz,
    point_layers,
    recorded_global_idx,
    subsample_mask,
    transformed_local,
)
from mp2p_icp_tpu_torch.ops.nn_bruteforce import knn_bruteforce

_BIG = 3.0e37


@dataclasses.dataclass(frozen=True)
class MatcherPointsInlierRatio(Matcher):
    """Params (reference: Matcher_Points_InlierRatio.h)."""

    inliers_ratio: float = 0.80
    max_local_points_per_layer: int = 0
    allow_match_already_matched_points: bool = False
    layer_matches: Tuple[LayerMatch, ...] = (LayerMatch(),)
    # the crop's margin: the matcher itself has no radius
    search_radius_hint: float = 2.0
    # the map split over ranks (parallel/spatial.py): this rank's
    # parallel.mesh.MeshAxis
    spatial_axis: object = None

    def search_radius(self) -> float:
        """The large-map crop's margin."""
        return self.search_radius_hint

    def out_blocks(self, local_map):
        layers = point_layers(local_map)
        return {"pt2pt": sum(layers[lm.local_layer].capacity for lm in self.layer_matches)}

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
            valid = subsample_mask(valid, local.count, self.max_local_points_per_layer)

            res = knn_bruteforce(pts, valid, glayer.xyz, glayer.valid_mask(), k=1,
                                 spatial_axis=self.spatial_axis)
            d = torch.where(res.valid[:, 0], res.dist_sq[:, 0], _BIG)
            n_valid = torch.sum(d < _BIG, dtype=torch.int32)
            n_keep = torch.ceil(self.inliers_ratio * n_valid.to(torch.float32)).to(torch.int64)
            cutoff = torch.sort(d).values[torch.clamp(n_keep - 1, 0, d.shape[0] - 1)]
            keep = (d <= cutoff) & (d < _BIG)

            w = torch.where(keep, lm.weight * gate, 0.0)
            gidx = res.idx[:, 0]
            rows = torch.arange(local.capacity, dtype=torch.int32, device=w.device)
            blocks.append(
                PairsPt2Pt(
                    local=local.xyz,
                    globl=neighbour_xyz(res, glayer)[:, 0],
                    weight=w,
                    local_idx=torch.where(w > 0, rows, -1),
                    global_idx=torch.where(
                        w > 0, recorded_global_idx(ctx, lm.global_layer, gidx), -1),
                )
            )
            if state is not None:
                new_local[lm.local_layer] = state.local_paired[lm.local_layer] | (w > 0)

        new_state = (
            MatchState(local_paired=new_local, global_paired=dict(state.global_paired))
            if state is not None else None
        )
        return dict(pt2pt=concat_blocks(blocks, PairsPt2Pt, pose.t.device)), new_state, potential
