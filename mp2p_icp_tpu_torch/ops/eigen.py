"""Masked mean/covariance + eigendecomposition of point neighbourhoods.

Port of ``mp2p_icp_tpu/ops/eigen.py`` (reference: estimate_points_eigen.h:
40-68), the basis of plane fitting in the point-to-plane matcher and the
normals fit. Batched: ``[..., K, 3]`` neighbourhoods with ``[..., K]`` masks
give sorted eigenpairs for all of them at once.

The symmetric 3x3 eigendecomposition is the JAX package's closed form
(trigonometric eigenvalues, cross-product eigenvectors), ported line for
line: the same candidate row pair, the same fallbacks, the same
``v1 = v2 x v0``. The sign of an eigenvector is whatever the cross product
gives, and the normals stored on a map are compared with the JAX
package's, so ``torch.linalg.eigh`` (another order, another sign, a solver
call per fit) does not stand in for it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_EPS = 1e-12
_TWO_PI_3 = 2.0943951023931953


class PointsEigen(NamedTuple):
    """Sorted eigen-structure of a point neighbourhood. Eigenvalues
    ascending: [..., 3] (l0 <= l1 <= l2); eigenvectors[..., :, i] is the
    unit eigenvector of l_i."""

    mean: torch.Tensor  # [..., 3]
    eigenvalues: torch.Tensor  # [..., 3]
    eigenvectors: torch.Tensor  # [..., 3, 3]
    count: torch.Tensor  # [...]


def masked_mean_cov(points: torch.Tensor, mask: torch.Tensor):
    """Weighted mean and covariance over the masked K axis.

    points: [..., K, 3]; mask: [..., K] (bool or float weights).
    Returns (mean [..., 3], cov [..., 3, 3], count [...])."""
    w = mask.to(points.dtype)
    n = torch.sum(w, dim=-1)
    n_safe = torch.clamp(n, min=1.0)
    mean = torch.sum(points * w[..., None], dim=-2) / n_safe[..., None]
    centered = points - mean[..., None, :]
    # one factor of the outer product is weighted: cov = sum w (p-m)(p-m)^T / sum w
    cov = torch.einsum("...k,...ki,...kj->...ij", w, centered, centered)
    return mean, cov / n_safe[..., None, None], n


def _norm(v: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    return torch.linalg.vector_norm(v, dim=-1, keepdim=keepdim)


def _pick_row(rows: torch.Tensor, which: torch.Tensor) -> torch.Tensor:
    """rows [..., 3, 3], which [...] -> the chosen row [..., 3]."""
    return torch.gather(rows, -2, which[..., None, None].expand(*which.shape, 1, 3)).squeeze(-2)


def _det3(B: torch.Tensor) -> torch.Tensor:
    """Determinant of [..., 3, 3] by cofactor expansion along the first row."""
    return (
        B[..., 0, 0] * (B[..., 1, 1] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 1])
        - B[..., 0, 1] * (B[..., 1, 0] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 0])
        + B[..., 0, 2] * (B[..., 1, 0] * B[..., 2, 1] - B[..., 1, 1] * B[..., 2, 0])
    )


def eigh3x3(A: torch.Tensor):
    """Closed-form symmetric 3x3 eigendecomposition, batched. Returns
    (eigenvalues ascending [..., 3], eigenvectors [..., 3, 3], one column
    per eigenvalue). Repeated eigenvalues are handled by the choice among
    candidate vectors."""
    A = 0.5 * (A + A.transpose(-1, -2))
    q = (A[..., 0, 0] + A[..., 1, 1] + A[..., 2, 2]) / 3.0
    eye = torch.eye(3, dtype=A.dtype, device=A.device).expand(A.shape)
    B = A - q[..., None, None] * eye
    p2 = torch.sum(B * B, dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=_EPS))
    r = _det3(B) / torch.clamp(2.0 * p * p * p, min=_EPS)
    phi = torch.arccos(torch.clamp(r, -1.0, 1.0)) / 3.0
    # eigenvalues in descending order: phi, phi + 2 pi / 3, phi + 4 pi / 3
    l2 = q + 2.0 * p * torch.cos(phi)
    l0 = q + 2.0 * p * torch.cos(phi + _TWO_PI_3)
    l1 = 3.0 * q - l0 - l2
    evals = torch.stack([l0, l1, l2], dim=-1)

    # the unit vectors are rows of the identity made on the device (a list
    # of numbers would be copied from the host: a sync per call)
    ex, ey, ez = (eye[..., i, :] for i in range(3))

    def eigvec(lam):
        # (A - lam I) has rank <= 2: two independent rows cross to the
        # eigenvector. Take the cross product of largest norm.
        M = A - lam[..., None, None] * eye
        r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
        cands = torch.stack([torch.linalg.cross(r0, r1), torch.linalg.cross(r0, r2),
                             torch.linalg.cross(r1, r2)], dim=-2)
        v = _pick_row(cands, torch.argmax(_norm(cands), dim=-1))
        n = _norm(v, keepdim=True)
        # doubly degenerate eigenvalue: rank(M) <= 1 and every cross product
        # vanishes. The eigenspace is the plane orthogonal to the largest
        # row; take a unit vector in it.
        rows = torch.stack([r0, r1, r2], dim=-2)
        rnorms = _norm(rows)
        row = _pick_row(rows, torch.argmax(rnorms, dim=-1))
        perp = torch.linalg.cross(row, ex)
        perp = torch.where(_norm(perp, keepdim=True) > 1e-12, perp,
                           torch.linalg.cross(row, ey))
        perp = perp / torch.clamp(_norm(perp, keepdim=True), min=_EPS)
        # fully isotropic (M ~ 0): any vector is an eigenvector -> e_x
        fallback = torch.where((rnorms.max(dim=-1).values > 1e-12)[..., None], perp, ex)
        return torch.where(n > 1e-10, v / torch.clamp(n, min=_EPS), fallback)

    v0 = eigvec(l0)
    v2 = eigvec(l2)
    # orthogonalise v2 against v0; v1 = v2 x v0 (right-handed, exact)
    v2 = v2 - torch.sum(v2 * v0, dim=-1, keepdim=True) * v0
    n2 = _norm(v2, keepdim=True)
    # v2 degenerate (isotropic): any vector orthogonal to v0
    alt = torch.linalg.cross(v0, ez)
    alt = torch.where(_norm(alt, keepdim=True) > 1e-6, alt, torch.linalg.cross(v0, ey))
    alt = alt / torch.clamp(_norm(alt, keepdim=True), min=_EPS)
    v2 = torch.where(n2 > 1e-10, v2 / torch.clamp(n2, min=_EPS), alt)
    v1 = torch.linalg.cross(v2, v0)
    return evals, torch.stack([v0, v1, v2], dim=-1)


def estimate_points_eigen(points: torch.Tensor, mask: torch.Tensor) -> PointsEigen:
    """Mean, covariance and sorted eigendecomposition of each masked
    neighbourhood (the reference's estimate_points_eigen(), batched)."""
    mean, cov, n = masked_mean_cov(points, mask)
    evals, evecs = eigh3x3(cov)
    return PointsEigen(mean=mean, eigenvalues=evals, eigenvectors=evecs, count=n)
