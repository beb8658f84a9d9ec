"""Shared machinery for the closed-form solvers.

Port of ``mp2p_icp_tpu/solvers/common.py`` (reference:
visit_correspondences.h:38-221): pt2pt pairs become centroid-centred vector
pairs, ln2ln directions and pl2pl normals join as unit attitude pairs,
per-type weights are count-normalised, and the optional scale-outlier
detector and robust kernel re-weight the pairs.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from mp2p_icp_tpu_torch.core.pairings import Pairings
from mp2p_icp_tpu_torch.core.se3 import Pose
from mp2p_icp_tpu_torch.solvers.robust import RobustKernel, robust_sqrt_weight


@dataclasses.dataclass(frozen=True)
class PairWeights:
    """Per-type weights (reference: PairWeights.h:35-52)."""

    pt2pt: float = 1.0
    pt2ln: float = 1.0
    pt2pl: float = 1.0
    ln2ln: float = 1.0
    pl2pl: float = 1.0


@dataclasses.dataclass(frozen=True)
class WeightParameters:
    """Reference: WeightParameters.h:34-70."""

    use_scale_outlier_detector: bool = False
    scale_outlier_threshold: float = 1.20
    pair_weights: PairWeights = dataclasses.field(default_factory=PairWeights)
    robust_kernel: RobustKernel = RobustKernel.NONE
    robust_kernel_param: float = 1.0


class VectorPairs(NamedTuple):
    """Weighted vector pairs consumed by Horn: b = global side, r = local
    side, w >= 0 (0 = masked)."""

    b: torch.Tensor  # [C, 3]
    r: torch.Tensor  # [C, 3]
    w: torch.Tensor  # [C]
    ct_local: torch.Tensor  # [3]
    ct_global: torch.Tensor  # [3]


def eval_centroids(p: Pairings, extra_mask: Optional[torch.Tensor] = None):
    """Weight-masked centroids of the pt2pt block."""
    w = (p.pt2pt.weight > 0).to(p.pt2pt.weight.dtype)
    if extra_mask is not None:
        w = w * extra_mask.to(w.dtype)
    n = torch.clamp(torch.sum(w), min=1.0)
    ct_local = torch.sum(p.pt2pt.local * w[:, None], dim=0) / n
    ct_global = torch.sum(p.pt2pt.globl * w[:, None], dim=0) / n
    return ct_local, ct_global


def _assemble(p, wp, ct_local, ct_global, normalize_point_vectors, current_estimate):
    """One pass of visit_correspondences: (VectorPairs, scale-inlier mask
    over the pt2pt block)."""
    pw = wp.pair_weights
    n_pt = p.pt2pt.count().to(torch.float32)
    n_ln = p.ln2ln.count().to(torch.float32)
    n_pl = p.pl2pl.count().to(torch.float32)
    denom = torch.clamp(
        pw.pt2pt * n_pt + pw.ln2ln * n_ln + pw.pl2pl * n_pl, min=1e-30
    )

    # --- pt2pt: centred (optionally normalised) vectors
    b = p.pt2pt.globl - ct_global
    r = p.pt2pt.local - ct_local
    bn = torch.linalg.vector_norm(b, dim=-1)
    rn = torch.linalg.vector_norm(r, dim=-1)
    near_centroid = (bn < 1e-4) | (rn < 1e-4)
    w_pt = p.pt2pt.weight * (pw.pt2pt / denom) * (~near_centroid)
    scale_inlier = torch.ones_like(bn, dtype=torch.bool)
    if wp.use_scale_outlier_detector:
        ratio = torch.maximum(bn, rn) / torch.clamp(torch.minimum(bn, rn), min=1e-12)
        scale_inlier = ratio <= wp.scale_outlier_threshold
        w_pt = w_pt * scale_inlier
    if normalize_point_vectors:
        b = b / torch.clamp(bn, min=1e-12)[:, None]
        r = r / torch.clamp(rn, min=1e-12)[:, None]

    # --- ln2ln directions and pl2pl normals as attitude pairs
    w_ln = (p.ln2ln.weight > 0).to(p.ln2ln.weight.dtype) * (pw.ln2ln / denom)
    w_pl = (p.pl2pl.weight > 0).to(p.pl2pl.weight.dtype) * (pw.pl2pl / denom)
    all_b = torch.cat([b, p.ln2ln.global_dir, p.pl2pl.global_normal], dim=0)
    all_r = torch.cat([r, p.ln2ln.local_dir, p.pl2pl.local_normal], dim=0)
    all_w = torch.cat([w_pt, w_ln, w_pl], dim=0)

    if wp.robust_kernel != RobustKernel.NONE:
        if current_estimate is None:
            raise ValueError("robust kernel requires a current pose estimate")
        err_sqr = torch.sum(torch.square(all_r @ current_estimate.R.T - all_b), dim=-1)
        all_w = all_w * robust_sqrt_weight(
            wp.robust_kernel, err_sqr, wp.robust_kernel_param
        )

    return (
        VectorPairs(b=all_b, r=all_r, w=all_w, ct_local=ct_local, ct_global=ct_global),
        scale_inlier,
    )


def build_vector_pairs(
    p: Pairings,
    wp: WeightParameters,
    normalize_point_vectors: bool,
    current_estimate: Optional[Pose] = None,
) -> VectorPairs:
    """The full visit_correspondences, including the second centroid pass
    without the detected outliers when the scale detector is on
    (optimal_tf_horn.cpp:222-234)."""
    ct_local, ct_global = eval_centroids(p)
    vp, inliers = _assemble(
        p, wp, ct_local, ct_global, normalize_point_vectors, current_estimate
    )
    if wp.use_scale_outlier_detector:
        ct_local2, ct_global2 = eval_centroids(p, extra_mask=inliers)
        vp, _ = _assemble(
            p, wp, ct_local2, ct_global2, normalize_point_vectors, current_estimate
        )
    return vp


def translation_from_centroids(R: torch.Tensor, ct_local, ct_global) -> torch.Tensor:
    """t = ct_global - R ct_local (reference: optimal_tf_horn.cpp:240-247)."""
    return ct_global - R @ ct_local
