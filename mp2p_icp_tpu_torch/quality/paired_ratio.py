"""Paired-ratio quality evaluator.

Port of ``mp2p_icp_tpu/quality/paired_ratio.py`` (reference:
QualityEvaluator_PairedRatio.cpp:27-73): quality = found pairings /
potential pairings, either from the ICP loop's final pairings
(``reuse_icp_pairings``) or from its own distance-threshold matcher.
``absolute_minimum_pairing_ratio`` triggers a hard discard (quality = 0).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from mp2p_icp_tpu_torch.core.pairings import Pairings
from mp2p_icp_tpu_torch.matchers.base import MatchState, spatial_scale
from mp2p_icp_tpu_torch.matchers.distance_threshold import MatcherPointsDistanceThreshold


class QualityResult(NamedTuple):
    quality: torch.Tensor  # scalar in [0, 1]
    hard_discard: torch.Tensor  # scalar bool


@dataclasses.dataclass(frozen=True)
class QualityPairedRatio:
    """Params (reference: QualityEvaluator_PairedRatio.h)."""

    reuse_icp_pairings: bool = True
    absolute_minimum_pairing_ratio: float = 0.0
    weight: float = 1.0
    # used when reuse_icp_pairings is False
    matcher: Optional[MatcherPointsDistanceThreshold] = None

    def evaluate(self, pairings: Pairings, global_map=None, local_map=None,
                 pose=None, ctx=None) -> QualityResult:
        if not self.reuse_icp_pairings and self.matcher is not None:
            # on a map split over ranks the global masks span every shard
            state = MatchState.create(local_map, global_map, spatial_scale(self.matcher))
            blocks, _, pot = self.matcher.match(
                global_map, local_map, pose, state, ctx
            )
            n = blocks["pt2pt"].count()
        else:
            n = pairings.size()
            pot = pairings.potential_pairings
        q = n.to(torch.float32) / torch.clamp(
            torch.as_tensor(pot, device=n.device).to(torch.float32), min=1.0
        )
        return QualityResult(
            quality=torch.clamp(q, 0.0, 1.0),
            hard_discard=q < self.absolute_minimum_pairing_ratio,
        )
