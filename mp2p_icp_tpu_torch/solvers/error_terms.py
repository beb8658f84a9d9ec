"""Residuals + analytic Jacobians for the five MP2P pairing types.

Port of ``mp2p_icp_tpu/solvers/error_terms.py`` (reference: errorTerms.cpp).
Jacobians are taken w.r.t. a right se(3) perturbation ``T' = T ∘ exp(eps)``,
tangent ordering ``[rho, theta]``:

    d(T(l))/d eps = [ R | -R hat(l) ]        (3x6)

Every function is batched over the pairing capacity axis and returns
``(residual [C, D], jacobian [C, D, 6])``. The ln2ln residual is the JAX
package's branch-free 6-dim form
``[ (I - u_g u_gT)(T(p_l) - p_g) ;  (R u_l) x u_g ]``.
"""

from __future__ import annotations

import torch

from mp2p_icp_tpu_torch.core import se3
from mp2p_icp_tpu_torch.core.se3 import Pose


def _rotation_jacobian(pose: Pose, v: torch.Tensor) -> torch.Tensor:
    """d(R v)/d eps for right perturbation, rotation columns only: -R hat(v)."""
    return -(pose.R.expand(v.shape[0], 3, 3) @ se3.hat(v))


def _point_jacobian(pose: Pose, local: torch.Tensor) -> torch.Tensor:
    """d(T(l))/d eps for right perturbation: [C, 3, 6] = [R | -R hat(l)]."""
    R = pose.R.expand(local.shape[0], 3, 3)
    return torch.cat([R, _rotation_jacobian(pose, local)], dim=-1)


def _projector(u: torch.Tensor) -> torch.Tensor:
    """I - u uT per row, [C, 3, 3]."""
    eye = torch.eye(3, dtype=u.dtype, device=u.device)
    return eye - u[:, :, None] * u[:, None, :]


def error_point2point(pose: Pose, local: torch.Tensor, globl: torch.Tensor):
    """r = T(l) - g (3-vec per pair). Reference: errorTerms.cpp:36-66."""
    r = se3.apply(pose, local) - globl
    return r, _point_jacobian(pose, local)


def error_point2line(pose: Pose, local, line_point, line_dir):
    """r = (I - u uT)(T(l) - p_base): perpendicular offset from the global
    line (3-vec). Reference: errorTerms.cpp:68-113."""
    q = se3.apply(pose, local) - line_point
    r = q - line_dir * torch.sum(line_dir * q, dim=-1, keepdim=True)
    return r, _projector(line_dir) @ _point_jacobian(pose, local)


def error_point2plane(pose: Pose, local, plane_centroid, plane_normal):
    """r = -n (n . (T(l) - c)) (3-vec, unit normals).
    Reference: errorTerms.cpp:115-161."""
    tl = se3.apply(pose, local)
    dist = torch.sum(plane_normal * (tl - plane_centroid), dim=-1, keepdim=True)
    r = -plane_normal * dist
    nnT = -(plane_normal[:, :, None] * plane_normal[:, None, :])
    return r, nnT @ _point_jacobian(pose, local)


def error_plane2plane(pose: Pose, local_normal, global_normal):
    """r = R n_l - n_g (3-vec); J = [0 | -R hat(n_l)].
    Reference: errorTerms.cpp:328-363."""
    r = se3.rotate(pose, local_normal) - global_normal
    J = torch.cat(
        [torch.zeros_like(_rotation_jacobian(pose, local_normal)),
         _rotation_jacobian(pose, local_normal)],
        dim=-1,
    )
    return r, J


def error_line2line(pose: Pose, local_point, local_dir, global_point, global_dir):
    """Branch-free 6-dim residual:
      r[:3] = (I - u_g u_gT)(T(p_l) - p_g)   — base point off the global line
      r[3:] = (R u_l) x u_g                  — direction misalignment
    """
    q = se3.apply(pose, local_point) - global_point
    r_pos = q - global_dir * torch.sum(global_dir * q, dim=-1, keepdim=True)
    J_pos = _projector(global_dir) @ _point_jacobian(pose, local_point)

    Ru = se3.rotate(pose, local_dir)
    r_dir = torch.linalg.cross(Ru, global_dir)
    # d(Ru x u_g)/d eps = -hat(u_g) d(Ru)/d eps = -hat(u_g) [0 | -R hat(u_l)]
    dR = _rotation_jacobian(pose, local_dir)
    dRu = torch.cat([torch.zeros_like(dR), dR], dim=-1)
    J_dir = -se3.hat(global_dir) @ dRu
    return (
        torch.cat([r_pos, r_dir], dim=-1),
        torch.cat([J_pos, J_dir], dim=-2),
    )
