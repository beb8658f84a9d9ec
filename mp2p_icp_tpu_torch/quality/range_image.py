"""Range-image similarity quality evaluator (Bogoslavskyi & Stachniss,
IROS 2017).

Port of ``mp2p_icp_tpu/quality/range_image.py`` (reference:
QualityEvaluator_RangeImageSimilarity.cpp:47-223): both clouds are
projected by a pinhole model into range images from both viewpoints (I11,
I12, I21, I22); each pixel pair scores 1 - erf(|dr| / (σ√2)) when both
see something, 1 - erf(penalty / √2) when one does, and the quality is the
mean over the counted pixels of both pairs. The projection is a z-buffer:
a scatter with the minimum as its reduction, exact in any order. A map
without a "raw" layer scores 0.5, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch

from mp2p_icp_tpu_torch.core import se3
from mp2p_icp_tpu_torch.core.pointcloud import PointCloud
from mp2p_icp_tpu_torch.core.se3 import Pose
from mp2p_icp_tpu_torch.quality.paired_ratio import QualityResult

_BIG = 3.0e37


def project_range_image(xyz, valid, ncols: int, nrows: int, fx: float, fy: float,
                        cx: float, cy: float) -> torch.Tensor:
    """Pinhole z-buffer projection: [nrows, ncols] ranges, 0 where empty.
    The camera looks along +x, image plane (y, z) (MRPT convention)."""
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    in_front = (x > 0.01) & valid
    xs = torch.clamp(x, min=1e-6)
    u = (cx - fx * y / xs).to(torch.int32)
    v = (cy - fy * z / xs).to(torch.int32)
    in_img = in_front & (u >= 0) & (u < ncols) & (v >= 0) & (v < nrows)
    rng = torch.linalg.vector_norm(xyz, dim=-1)
    flat = torch.where(in_img, v * ncols + u, nrows * ncols).long()
    img = torch.full((nrows * ncols + 1,), _BIG, device=xyz.device).scatter_reduce(
        0, flat, torch.where(in_img, rng, _BIG), "amin")
    img = img[:-1].reshape(nrows, ncols)
    return torch.where(img < _BIG, img, 0.0)


def _score_images(I, J, sigma: float, penalty_not_visible: float = 2.0):
    """(sum, count) of the per-pixel agreement of two range images
    (QualityEvaluator_RangeImageSimilarity.cpp:183-223); pixels empty in
    both are not counted."""
    f32 = dict(dtype=torch.float32, device=I.device)
    sqrt2 = torch.sqrt(torch.tensor(2.0, **f32))
    both = (I > 0) & (J > 0)
    one = (I > 0) ^ (J > 0)
    val_both = 1.0 - torch.erf(torch.abs(I - J) / (torch.tensor(sigma, **f32) * sqrt2))
    val_one = 1.0 - torch.erf(torch.tensor(penalty_not_visible, **f32) / sqrt2)
    score = torch.where(both, val_both, torch.where(one, val_one, 0.0))
    return torch.sum(score), torch.sum((both | one).to(torch.float32))


@dataclasses.dataclass(frozen=True)
class QualityRangeImageSimilarity:
    """Params (reference: QualityEvaluator_RangeImageSimilarity.h)."""

    ncols: int = 100
    nrows: int = 60
    fx: float = 50.0
    fy: float = 50.0
    cx: float = 50.0
    cy: float = 30.0
    sigma: float = 0.1
    # in sigmas (reference: QualityEvaluator_RangeImageSimilarity.h:76)
    penalty_not_visible: float = 2.0
    weight: float = 1.0

    def evaluate_clouds(self, global_pc: PointCloud, local_pc: PointCloud,
                        pose: Pose) -> QualityResult:
        def proj(xyz, valid):
            return project_range_image(xyz, valid, self.ncols, self.nrows, self.fx,
                                       self.fy, self.cx, self.cy)

        lv, gv = local_pc.valid_mask(), global_pc.valid_mask()
        # I11: the global cloud from the global viewpoint, I21: the moved
        # local cloud from there; I12 / I22: both from the local viewpoint
        I11 = proj(global_pc.xyz, gv)
        I21 = proj(se3.apply(pose, local_pc.xyz), lv)
        I12 = proj(se3.apply(se3.inverse(pose), global_pc.xyz), gv)
        I22 = proj(local_pc.xyz, lv)
        s1, n1 = _score_images(I11, I21, self.sigma, self.penalty_not_visible)
        s2, n2 = _score_images(I12, I22, self.sigma, self.penalty_not_visible)
        q = (s1 + s2) / torch.clamp(n1 + n2, min=1.0)
        return QualityResult(quality=q, hard_discard=torch.zeros((), dtype=torch.bool,
                                                                 device=q.device))

    def evaluate(self, pairings, global_map=None, local_map=None, pose=None,
                 ctx=None) -> QualityResult:
        gl = global_map.get("raw") if hasattr(global_map, "get") else None
        ll = local_map.get("raw") if hasattr(local_map, "get") else None
        if gl is None or ll is None:
            device = pose.t.device
            return QualityResult(quality=torch.tensor(0.5, device=device),
                                 hard_discard=torch.zeros((), dtype=torch.bool, device=device))
        return self.evaluate_clouds(gl, ll, pose)
