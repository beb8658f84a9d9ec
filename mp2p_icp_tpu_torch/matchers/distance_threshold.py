"""The workhorse pt2pt matcher.

Port of ``mp2p_icp_tpu/matchers/distance_threshold.py`` (reference:
Matcher_Points_DistanceThreshold.cpp:48-269): for each transformed local
point, its k nearest global points; a pair is kept when
distSq < threshold² + (angularFactor·|p|)²; one-to-one exclusivity is a
deterministic segment-min (ops.nn.resolve_one_to_one). ``threshold`` may
be an ``Expression`` over ``ICP_ITERATION`` (core/params.py).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from mp2p_icp_tpu_torch.core.pairings import PairsPt2Pt, concat_blocks
from mp2p_icp_tpu_torch.matchers.base import (
    LayerMatch,
    MatchContext,
    Matcher,
    MatchState,
    claim,
    neighbour_xyz,
    point_layers,
    recorded_global_idx,
    static_value,
    spatial_scale,
    subsample_mask,
    transformed_local,
)
from mp2p_icp_tpu_torch.ops.nn import resolve_one_to_one
from mp2p_icp_tpu_torch.ops.nn_bruteforce import knn_bruteforce


@dataclasses.dataclass(frozen=True)
class MatcherPointsDistanceThreshold(Matcher):
    """Params (reference: Matcher_Points_DistanceThreshold.h:60-71)."""

    threshold: object = 0.50  # float | Expression
    threshold_angular_deg: float = 0.0
    pairings_per_point: int = 1
    max_local_points_per_layer: int = 0
    allow_match_already_matched_global_points: bool = False
    allow_match_already_matched_points: bool = False
    layer_matches: Tuple[LayerMatch, ...] = (LayerMatch(),)
    # range (m) at which the angular term is evaluated for the crop margin
    # (the per-point threshold thr² + (angFactor·|p|)² has no bound)
    angular_range_hint: float = 100.0
    # the map split over ranks (parallel/spatial.py): this rank's
    # parallel.mesh.MeshAxis; its size is the shard count that the global
    # ids and claim masks span
    spatial_axis: object = None

    def search_radius(self) -> float:
        """The largest pairing distance, for the large-map crop's margin (an
        Expression is taken at iteration 0, as in the JAX package)."""
        thr = static_value(self.threshold, "threshold", 0)
        if self.threshold_angular_deg <= 0:
            return thr
        ang = math.radians(self.threshold_angular_deg) * self.angular_range_hint
        return math.sqrt(thr**2 + ang**2)

    def out_blocks(self, local_map):
        layers = point_layers(local_map)
        return {
            "pt2pt": sum(
                layers[lm.local_layer].capacity * self.pairings_per_point
                for lm in self.layer_matches
            )
        }

    def match(self, global_map, local_map, pose, state: MatchState, ctx: MatchContext):
        gate = self.gate(ctx.icp_iteration)
        # a host gate (the ICP loop) or a per-problem tensor (the batched
        # final quality of an evaluator with its own matcher)
        on = gate.to(torch.int32) if isinstance(gate, torch.Tensor) else int(gate)
        thr = static_value(self.threshold, "threshold", ctx.icp_iteration)
        ang_factor_sq = math.radians(self.threshold_angular_deg) ** 2
        k = self.pairings_per_point
        l_layers, g_layers = point_layers(local_map), point_layers(global_map)
        # state=None: single-matcher iteration, the cross-matcher paired
        # masks carry no information
        new_local = dict(state.local_paired) if state is not None else None
        new_global = dict(state.global_paired) if state is not None else None
        blocks = []
        potential = 0
        for lm in self.layer_matches:
            local = l_layers[lm.local_layer]
            glayer = g_layers[lm.global_layer]
            pts, valid = transformed_local(local, pose)
            potential = potential + local.count * (k * on)
            if state is not None and not self.allow_match_already_matched_points:
                valid = valid & ~state.local_paired[lm.local_layer]
            valid = subsample_mask(valid, local.count, self.max_local_points_per_layer)

            # per-point threshold thr² + angFactor²·|p|² (norm of the
            # transformed point, reference :151-153) is a per-query radius
            norm_sq = torch.sum(pts * pts, dim=-1)
            norm_sq = torch.where(torch.isfinite(norm_sq), norm_sq, 0.0)
            thr_sq = thr**2 + ang_factor_sq * norm_sq

            res = knn_bruteforce(
                pts, valid, glayer.xyz, glayer.valid_mask(), k=k,
                max_radius_sq=thr_sq, spatial_axis=self.spatial_axis,
            )
            keep = res.valid
            g_cap = glayer.capacity * spatial_scale(self)
            if not self.allow_match_already_matched_global_points:
                if state is not None:
                    gmask = state.global_paired[lm.global_layer]
                    keep = keep & ~gmask[torch.clamp(res.idx, 0, g_cap - 1).long()]
                if k == 1:
                    one2one = resolve_one_to_one(res.idx, res.dist_sq, keep, g_cap)
                    keep = keep & one2one[:, None]

            w = torch.where(keep, lm.weight * gate, 0.0)  # [Q, k]
            wf = w.reshape(-1)
            C = local.capacity
            local_idx = torch.arange(C, dtype=torch.int32, device=wf.device)
            gidx = res.idx.reshape(-1)
            blocks.append(
                PairsPt2Pt(
                    local=torch.repeat_interleave(local.xyz, k, dim=0),
                    globl=neighbour_xyz(res, glayer).reshape(-1, 3),
                    weight=wf,
                    local_idx=torch.where(
                        wf > 0, torch.repeat_interleave(local_idx, k), -1
                    ),
                    global_idx=torch.where(
                        wf > 0, recorded_global_idx(ctx, lm.global_layer, gidx), -1
                    ),
                )
            )
            if state is not None and not self.allow_match_already_matched_global_points:
                new_local[lm.local_layer] = (
                    state.local_paired[lm.local_layer] | torch.any(w > 0, dim=-1)
                )
                new_global[lm.global_layer] = claim(
                    new_global[lm.global_layer], gidx, wf > 0
                )

        pt2pt = concat_blocks(blocks, PairsPt2Pt, pose.t.device)
        new_state = (
            MatchState(local_paired=new_local, global_paired=new_global)
            if state is not None else None
        )
        return dict(pt2pt=pt2pt), new_state, potential
