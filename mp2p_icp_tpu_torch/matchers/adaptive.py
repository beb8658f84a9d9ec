"""Adaptive two-stage robust matcher.

Port of ``mp2p_icp_tpu/matchers/adaptive.py`` (reference:
Matcher_Adaptive.cpp:32-314):

1. the k nearest neighbours of every transformed local point within
   ``absolute_max_search_distance`` (k = ``plane_search_points`` with
   plane detection on, else ``max_pt2pt_correspondences``); a 50-bin
   histogram of the 1st/2nd squared distances gives the adaptive threshold
   as its (1+CI)/2 quantile;
2. with ``enable_detect_planes``: a plane fitted to each neighbourhood
   (``ops/eigen.estimate_points_eigen``); a plane-like one (l0 below
   ``plane_eigen_threshold`` times l1 and l2, at least
   ``plane_minimum_found_points`` neighbours) within
   ``plane_minimum_distance`` of the transformed local point gives a pt2pl
   pair. The distance is that of the transformed point, where the reference
   takes the untransformed one (Matcher_Adaptive.cpp:254): a deviation of
   the JAX package, kept;
3. pt2pt pairs for the other local points, below the threshold and within
   the first-to-second distance ratio.

``confidence_interval`` and ``absolute_max_search_distance`` may be
``Expression`` s over ``ICP_ITERATION``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from mp2p_icp_tpu_torch.core.pairings import PairsPt2Pl, PairsPt2Pt, concat_blocks
from mp2p_icp_tpu_torch.core.params import Expression
from mp2p_icp_tpu_torch.matchers.base import (
    LayerMatch,
    MatchContext,
    Matcher,
    MatchState,
    claim,
    neighbour_xyz,
    point_layers,
    recorded_global_idx,
    spatial_scale,
    static_value,
    transformed_local,
)
from mp2p_icp_tpu_torch.ops.eigen import estimate_points_eigen
from mp2p_icp_tpu_torch.ops.nn_bruteforce import knn_bruteforce

_BIG = 3.0e37
_HIST_BINS = 50  # reference: CHistogram(min, max, 50), Matcher_Adaptive.cpp:193


def adaptive_threshold_sq(res, confidence_interval: float, minimum_corr_dist: float):
    """The adaptive squared-distance threshold: the (1+CI)/2 quantile of a
    50-bin histogram of the valid 1st/2nd NN squared distances, floored at
    ``minimum_corr_dist²`` (reference: Matcher_Adaptive.cpp:191-218)."""
    m = min(2, res.dist_sq.shape[1])
    d12 = torch.where(res.valid[:, :m], res.dist_sq[:, :m], _BIG).reshape(-1)
    sample_ok = d12 < _BIG
    d_min = torch.min(torch.where(sample_ok, d12, _BIG))
    d_max = torch.max(torch.where(sample_ok, d12, -_BIG))
    span = torch.clamp(d_max - d_min, min=1e-12)
    bins = torch.clamp(
        ((d12 - d_min) / span * _HIST_BINS).to(torch.int32), 0, _HIST_BINS - 1
    )
    # index_add rather than bincount: no host sync on CUDA (counts are
    # small integers, exact in f32 in any order); out of place for vmap
    hist = torch.zeros(_HIST_BINS + 1, device=d12.device).index_add(
        0, torch.where(sample_ok, bins, _HIST_BINS).long(),
        torch.ones_like(d12),
    )[:_HIST_BINS]
    cdf = torch.cumsum(hist, dim=0) / torch.clamp(torch.sum(hist), min=1.0)
    # reference: confidenceIntervalsFromHistogram(..., 1-CI) — the upper
    # limit is the (1+CI)/2 quantile of the binned samples
    q = (1.0 + confidence_interval) * 0.5
    bin_idx = torch.argmax((cdf >= q).to(torch.int32))
    ci_high = d_min + (bin_idx + 1).to(torch.float32) / _HIST_BINS * span
    return torch.clamp(ci_high, min=minimum_corr_dist**2)


@dataclasses.dataclass(frozen=True)
class MatcherAdaptive(Matcher):
    """Params (reference: Matcher_Adaptive.h)."""

    confidence_interval: object = 0.80  # float | Expression
    first_to_second_distance_max: float = 1.2
    absolute_max_search_distance: object = 5.0  # float | Expression
    minimum_corr_dist: float = 0.1
    enable_detect_planes: bool = False
    plane_search_points: int = 8
    plane_minimum_found_points: int = 4
    plane_minimum_distance: float = 0.10
    plane_eigen_threshold: float = 0.01
    max_pt2pt_correspondences: int = 1
    allow_match_already_matched_points: bool = False
    allow_match_already_matched_global_points: bool = False
    layer_matches: Tuple[LayerMatch, ...] = (LayerMatch(),)
    # the map split over ranks (parallel/spatial.py): this rank's
    # parallel.mesh.MeshAxis; its size is the shard count that the global
    # ids and claim masks span
    spatial_axis: object = None

    def search_radius(self) -> float:
        """The largest pairing distance, for the large-map crop's margin: an
        Expression's largest value over iterations 0..512, as in the JAX
        package."""
        return max(static_value(self.absolute_max_search_distance,
                                "absolute_max_search_distance", i)
                   for i in range(513 if isinstance(self.absolute_max_search_distance,
                                                    Expression) else 1))

    def _knn(self) -> int:
        return (self.plane_search_points if self.enable_detect_planes
                else self.max_pt2pt_correspondences)

    def out_blocks(self, local_map):
        layers = point_layers(local_map)
        caps = [layers[lm.local_layer].capacity for lm in self.layer_matches]
        return {
            "pt2pt": sum(caps) * self.max_pt2pt_correspondences,
            "pt2pl": sum(caps),
        }

    def out_capacity_pt2pl(self, local_map) -> int:
        return self.out_blocks(local_map)["pt2pl"]

    def match(self, global_map, local_map, pose, state: MatchState, ctx: MatchContext):
        gate = self.gate(ctx.icp_iteration)
        it = ctx.icp_iteration
        conf_int = static_value(self.confidence_interval, "confidence_interval", it)
        amsd = static_value(self.absolute_max_search_distance,
                            "absolute_max_search_distance", it)
        knn = self._knn()
        kk = min(knn, self.max_pt2pt_correspondences)
        l_layers, g_layers = point_layers(local_map), point_layers(global_map)
        new_local = dict(state.local_paired) if state is not None else None
        new_global = dict(state.global_paired) if state is not None else None
        pt_blocks, pl_blocks = [], []
        potential = 0
        for lm in self.layer_matches:
            local = l_layers[lm.local_layer]
            glayer = g_layers[lm.global_layer]
            pts, valid = transformed_local(local, pose)
            potential = potential + local.count * int(gate)
            if state is not None and not self.allow_match_already_matched_points:
                valid = valid & ~state.local_paired[lm.local_layer]

            res = knn_bruteforce(
                pts, valid, glayer.xyz, glayer.valid_mask(), k=knn,
                max_radius_sq=amsd**2, spatial_axis=self.spatial_axis,
            )
            neigh = neighbour_xyz(res, glayer)  # [Q, knn, 3]

            # --- stage 1: adaptive threshold from the 1st/2nd NN histogram
            max_corr_dist_sq = adaptive_threshold_sq(
                res, conf_int, self.minimum_corr_dist
            )

            # --- stage 2a: plane detection per local point
            C = local.capacity
            local_idx = torch.arange(C, dtype=torch.int32, device=pts.device)
            if self.enable_detect_planes:
                pe = estimate_points_eigen(neigh, res.valid)
                l0, l1, l2 = pe.eigenvalues.unbind(-1)
                plane_like = ((l0 < self.plane_eigen_threshold * l2)
                              & (l0 < self.plane_eigen_threshold * l1)
                              & (pe.count >= self.plane_minimum_found_points))
                normal = pe.eigenvectors[:, :, 0]
                dist_pl = torch.abs(torch.sum(normal * (pts - pe.mean), dim=-1))
                is_plane = valid & plane_like & (dist_pl < self.plane_minimum_distance)
                plane_w = torch.where(is_plane, lm.weight * gate, 0.0)
                pl_blocks.append(PairsPt2Pl(
                    local=local.xyz, plane_centroid=pe.mean, plane_normal=normal,
                    weight=plane_w, local_idx=torch.where(plane_w > 0, local_idx, -1)))
            else:
                is_plane = None
                plane_w = torch.zeros(C, device=pts.device)
                pl_blocks.append(PairsPt2Pl(
                    local=local.xyz, plane_centroid=torch.zeros_like(local.xyz),
                    plane_normal=torch.zeros_like(local.xyz), weight=plane_w,
                    local_idx=torch.full((C,), -1, dtype=torch.int32, device=pts.device)))

            # --- stage 2b: pt2pt pairs of the non-plane points, stopping at
            # the first ratio violation
            dk = res.dist_sq[:, :kk]
            first = dk[:, :1]
            ratio_ok = dk <= first * (self.first_to_second_distance_max**2)
            ratio_ok[:, 0] = True
            ratio_ok = torch.cumprod(ratio_ok.to(torch.int32), dim=1).bool()
            keep = res.valid[:, :kk] & ratio_ok & (dk < max_corr_dist_sq)
            keep = keep & valid[:, None]
            if is_plane is not None:
                keep = keep & ~is_plane[:, None]
            gidx = res.idx[:, :kk]
            if state is not None and not self.allow_match_already_matched_global_points:
                # skip globals an earlier matcher already paired
                # (Matcher_Adaptive.cpp:278-281)
                g_cap = glayer.capacity * spatial_scale(self)
                keep = keep & ~state.global_paired[lm.global_layer][
                    torch.clamp(gidx, 0, g_cap - 1).long()]
            w = torch.where(keep, lm.weight * gate, 0.0)
            wf = w.reshape(-1)
            gflat = gidx.reshape(-1)
            pt_blocks.append(
                PairsPt2Pt(
                    local=torch.repeat_interleave(local.xyz, kk, dim=0),
                    globl=neigh[:, :kk].reshape(-1, 3),
                    weight=wf,
                    local_idx=torch.where(
                        wf > 0, torch.repeat_interleave(local_idx, kk), -1
                    ),
                    global_idx=torch.where(
                        wf > 0, recorded_global_idx(ctx, lm.global_layer, gflat), -1
                    ),
                )
            )
            if state is not None:
                new_local[lm.local_layer] = (
                    state.local_paired[lm.local_layer] | torch.any(w > 0, dim=-1)
                    | (plane_w > 0)
                )
                if not self.allow_match_already_matched_global_points:
                    # claim this matcher's pt2pt globals (the reference marks
                    # globals only on the pt2pt path, Matcher_Adaptive.cpp:293-299)
                    new_global[lm.global_layer] = claim(
                        new_global[lm.global_layer], gflat, wf > 0
                    )

        out = {
            "pt2pt": concat_blocks(pt_blocks, PairsPt2Pt, pose.t.device),
            "pt2pl": concat_blocks(pl_blocks, PairsPt2Pl, pose.t.device),
        }
        new_state = (
            MatchState(local_paired=new_local, global_paired=new_global)
            if state is not None else None
        )
        return out, new_state, potential
