"""Covariance of the final ICP fit.

Port of ``mp2p_icp_tpu/covariance.py``: cov = H⁻¹ with H the unweighted
(robust kernel off) Gauss-Newton normal matrix at the final pose, inverted
with Jacobi equilibration; 1e6·I when there are no pairings (reference:
covariance.cpp:30-141).
"""

from __future__ import annotations

import torch

from mp2p_icp_tpu_torch.core.pairings import Pairings
from mp2p_icp_tpu_torch.core.se3 import Pose
from mp2p_icp_tpu_torch.solvers.gauss_newton import GNParams, gn_build_normal_equations

SIGMA_NO_PAIRINGS = 1.0e6


def covariance(pairings: Pairings, final_pose: Pose) -> torch.Tensor:
    """6x6 covariance of the pose estimate from the final pairings."""
    H, _, _ = gn_build_normal_equations(final_pose, pairings, GNParams())
    eye = torch.eye(6, dtype=H.dtype, device=H.device)
    H_safe = H + 1e-9 * eye
    # equilibrated inverse: inv(H) = D inv(D H D) D
    dinv = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(H_safe), min=1e-30))
    Hs = H_safe * dinv[:, None] * dinv[None, :]
    inv, _ = torch.linalg.inv_ex(Hs)  # no host sync on a singular input
    cov = inv * dinv[:, None] * dinv[None, :]
    return torch.where(pairings.size() > 0, cov, SIGMA_NO_PAIRINGS * eye)
