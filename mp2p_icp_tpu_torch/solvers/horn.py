"""Horn's closed-form quaternion solution for the optimal SE(3) transform.

Port of ``mp2p_icp_tpu/solvers/horn.py`` (reference: optimal_tf_horn.cpp):
weighted cross-covariance S = sum w r bT, Horn's symmetric 4x4 N matrix,
rotation = its dominant eigenvector, translation from the centroids.

The eigenvector comes from the same 30-step shifted power iteration as in
the JAX package (not ``torch.linalg.eigh``), so the port follows the
reference's choice of vector and sign on near-degenerate inputs too.
"""

from __future__ import annotations

from typing import Optional

import torch

from mp2p_icp_tpu_torch.core import se3
from mp2p_icp_tpu_torch.core.pairings import Pairings
from mp2p_icp_tpu_torch.core.se3 import Pose
from mp2p_icp_tpu_torch.solvers.common import (
    VectorPairs,
    WeightParameters,
    build_vector_pairs,
    translation_from_centroids,
)
from mp2p_icp_tpu_torch.utils.profiler import profile_scope


def _horn_n_matrix(S: torch.Tensor) -> torch.Tensor:
    """The 4x4 symmetric N matrix of Horn's method from S = sum w r bT."""
    Sxx, Sxy, Sxz = S[0, 0], S[0, 1], S[0, 2]
    Syx, Syy, Syz = S[1, 0], S[1, 1], S[1, 2]
    Szx, Szy, Szz = S[2, 0], S[2, 1], S[2, 2]
    rows = [
        [Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx],
        [Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz],
        [Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy],
        [Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz],
    ]
    return torch.stack([torch.stack(r) for r in rows])


def max_eigvec_4x4(N: torch.Tensor, iters: int = 30) -> torch.Tensor:
    """Dominant eigenvector of a symmetric 4x4 via shifted power iteration:
    the Gershgorin shift makes every eigenvalue non-negative so the
    algebraically largest dominates; deterministic start vector with a tiny
    symmetry-breaking ramp; canonical sign q_w >= 0."""
    shift = torch.max(torch.sum(torch.abs(N), dim=1))
    A = N + shift * torch.eye(4, dtype=N.dtype, device=N.device)
    with profile_scope("sync.horn_start"):  # a copy from the host, which syncs
        v = torch.tensor([1.0, 1e-3, 2e-3, 3e-3], dtype=N.dtype, device=N.device)
    v = v / torch.linalg.vector_norm(v)
    for _ in range(iters):
        v = A @ v
        v = v / torch.clamp(torch.linalg.vector_norm(v), min=1e-30)
    # canonical sign: q_w >= 0 (reference: optimal_tf_horn.cpp:166-173)
    return v * torch.sign(v[0] + 1e-30)


def horn_from_vector_pairs(vp: VectorPairs) -> Pose:
    """Rotation + translation from weighted vector pairs. All-zero weights
    give the identity (the ICP loop's NO_PAIRINGS test fires first)."""
    w_total = torch.sum(vp.w)
    S = torch.einsum(
        "c,ci,cj->ij", vp.w / torch.clamp(w_total, min=1e-30), vp.r, vp.b
    )
    R = se3.quat_to_rot(max_eigvec_4x4(_horn_n_matrix(S)))
    t = translation_from_centroids(R, vp.ct_local, vp.ct_global)
    ok = w_total > 0
    return Pose(
        torch.where(ok, R, torch.eye(3, dtype=R.dtype, device=R.device)),
        torch.where(ok, t, torch.zeros_like(t)),
    )


def optimal_tf_horn(
    pairings: Pairings,
    wp: Optional[WeightParameters] = None,
    current_estimate: Optional[Pose] = None,
) -> Pose:
    """Full Horn solve from raw pairings (pt2pt + ln2ln + pl2pl attitude
    terms; pt2ln/pt2pl must be converted first, see pt2_conversions)."""
    vp = build_vector_pairs(
        pairings, wp or WeightParameters(), normalize_point_vectors=False,
        current_estimate=current_estimate,
    )
    return horn_from_vector_pairs(vp)


def horn_scale(pairings: Pairings, wp: Optional[WeightParameters] = None) -> torch.Tensor:
    """Optimal uniform scale ``s`` with global ≈ s·R·local + t: the
    reference's Horn scale expression (optimal_tf_horn.cpp:177-195),
    s = sqrt(Σw|b|² / Σw|r|²) over the centred vector pairs (b global, r
    local), weighted as the rotation solve is. Reporting only: the pose
    stays rigid. No pairs give 1."""
    vp = build_vector_pairs(pairings, wp or WeightParameters(), normalize_point_vectors=False)
    num = torch.sum(vp.w * torch.sum(vp.b * vp.b, dim=-1))
    den = torch.sum(vp.w * torch.sum(vp.r * vp.r, dim=-1))
    ok = (num > 0) & (den > 0)
    return torch.where(ok, torch.sqrt(num / torch.clamp(den, min=1e-30)), 1.0)
