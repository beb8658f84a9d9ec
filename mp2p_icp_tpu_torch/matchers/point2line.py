"""Point-to-line matcher.

Port of ``mp2p_icp_tpu/matchers/point2line.py`` (reference:
Matcher_Point2Line.cpp:46-163): the ``knn`` nearest global points of each
transformed local point within ``distance_threshold``, a line fitted to
them (``ops/eigen.estimate_points_eigen``), and a pt2ln pair when the
neighbourhood is line-like: l0 and l1 below ``line_eigen_threshold`` times
l2, at least ``min_points_to_fit`` neighbours. The line is (centroid,
eigenvector of l2).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from mp2p_icp_tpu_torch.core.pairings import PairsPt2Ln, concat_blocks
from mp2p_icp_tpu_torch.matchers.base import (
    LayerMatch,
    MatchContext,
    Matcher,
    MatchState,
    point_layers,
    transformed_local,
)
from mp2p_icp_tpu_torch.ops.eigen import estimate_points_eigen
from mp2p_icp_tpu_torch.ops.nn_bruteforce import MAX_K, knn_bruteforce


@dataclasses.dataclass(frozen=True)
class MatcherPoint2Line(Matcher):
    """Params (reference: Matcher_Point2Line.h)."""

    distance_threshold: float = 0.40
    knn: int = 4
    line_eigen_threshold: float = 0.01
    min_points_to_fit: int = 4
    allow_match_already_matched_points: bool = False
    layer_matches: Tuple[LayerMatch, ...] = (LayerMatch(),)

    def __post_init__(self):
        if not 1 <= self.knn <= MAX_K:
            raise ValueError(f"MatcherPoint2Line: knn={self.knn}, the kNN sweeps take "
                             f"1 <= k <= {MAX_K}")

    def search_radius(self) -> float:
        """The largest pairing distance, for the large-map crop's margin."""
        return self.distance_threshold

    def out_blocks(self, local_map):
        layers = point_layers(local_map)
        return {"pt2ln": sum(layers[lm.local_layer].capacity for lm in self.layer_matches)}

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

            res = knn_bruteforce(
                pts, valid, glayer.xyz, glayer.valid_mask(), k=self.knn,
                max_radius_sq=self.distance_threshold**2,
            )
            neigh = glayer.xyz[torch.clamp(res.idx, 0, glayer.capacity - 1).long()]
            pe = estimate_points_eigen(neigh, res.valid)
            l0, l1, l2 = pe.eigenvalues.unbind(-1)
            is_line = (l0 < self.line_eigen_threshold * l2) & (l1 < self.line_eigen_threshold * l2)
            keep = valid & (pe.count >= self.min_points_to_fit) & is_line
            w = torch.where(keep, lm.weight * gate, 0.0)
            rows = torch.arange(local.capacity, dtype=torch.int32, device=w.device)
            blocks.append(
                PairsPt2Ln(
                    local=local.xyz,
                    line_point=pe.mean,
                    line_dir=pe.eigenvectors[:, :, 2],
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
        return dict(pt2ln=concat_blocks(blocks, PairsPt2Ln, pose.t.device)), new_state, potential
