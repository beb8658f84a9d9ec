"""Plain SE(3) algebra for the benchmark's generators and reference.

Poses are (R [..., 3, 3], t [..., 3]) tuples of tensors of any float dtype;
tangents are [..., 6] = [rho, theta] with the left Jacobian convention
(exp maps [rho, theta] to (Rodrigues(theta), J_l(theta) rho)). Written from
the textbook formulas (Barfoot, State Estimation for Robotics, 7.1), not
from the program's core/se3.py.
"""

from __future__ import annotations

import torch


def hat(w: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> the skew-symmetric [..., 3, 3] with hat(w) v = w x v."""
    z = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([z, -w[..., 2], w[..., 1]], -1),
        torch.stack([w[..., 2], z, -w[..., 0]], -1),
        torch.stack([-w[..., 1], w[..., 0], z], -1),
    ], -2)


def _coeffs(theta: torch.Tensor):
    """(sin t / t, (1 - cos t) / t^2, (t - sin t) / t^3) with series where
    t is small."""
    t2 = theta * theta
    small = theta < 1e-4
    ts = torch.where(small, torch.ones_like(theta), theta)
    a = torch.where(small, 1 - t2 / 6, torch.sin(ts) / ts)
    b = torch.where(small, 0.5 - t2 / 24, (1 - torch.cos(ts)) / (ts * ts))
    c = torch.where(small, 1 / 6 - t2 / 120, (ts - torch.sin(ts)) / (ts * ts * ts))
    return a, b, c


def exp(xi: torch.Tensor):
    """[..., 6] tangent -> (R, t)."""
    rho, w = xi[..., :3], xi[..., 3:]
    theta = torch.linalg.vector_norm(w, dim=-1)
    a, b, c = (x[..., None, None] for x in _coeffs(theta))
    K = hat(w)
    K2 = K @ K
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(K.shape)
    R = eye + a * K + b * K2
    V = eye + b * K + c * K2
    return R, (V @ rho[..., None])[..., 0]


def log(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(R, t) -> [..., 6] tangent (angles below pi)."""
    cos = torch.clamp((R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1) / 2, -1.0, 1.0)
    theta = torch.arccos(cos)
    vee = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                       R[..., 1, 0] - R[..., 0, 1]], -1)
    small = theta < 1e-4
    ts = torch.where(small, torch.ones_like(theta), theta)
    scale = torch.where(small, 0.5 + theta * theta / 12, ts / (2 * torch.sin(ts)))
    w = vee * scale[..., None]
    # V^-1 = I - K/2 + (1/t^2)(1 - (t sin t) / (2 (1 - cos t))) K^2
    K = hat(w)
    t2 = ts * ts
    d = torch.where(small, 1 / 12 + theta * theta / 720,
                    (1 - ts * torch.sin(ts) / (2 * (1 - torch.cos(ts)))) / t2)
    eye = torch.eye(3, dtype=R.dtype, device=R.device).expand(K.shape)
    Vinv = eye - 0.5 * K + d[..., None, None] * (K @ K)
    return torch.cat([(Vinv @ t[..., None])[..., 0], w], -1)


def compose(a, b):
    """a o b."""
    return a[0] @ b[0], (a[0] @ b[1][..., None])[..., 0] + a[1]


def inverse(p):
    Rt = p[0].transpose(-1, -2)
    return Rt, -(Rt @ p[1][..., None])[..., 0]


def from_xyz_ypr(x, y, z, yaw, pitch, roll, dtype=torch.float64, device="cpu"):
    """R = Rz(yaw) Ry(pitch) Rx(roll), t = (x, y, z)."""
    v = torch.tensor([yaw, pitch, roll], dtype=torch.float64)
    cy, sy = torch.cos(v[0]), torch.sin(v[0])
    cp, sp = torch.cos(v[1]), torch.sin(v[1])
    cr, sr = torch.cos(v[2]), torch.sin(v[2])
    R = torch.stack([
        torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr]),
        torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr]),
        torch.stack([-sp, cp * sr, cp * cr]),
    ])
    t = torch.tensor([x, y, z], dtype=torch.float64)
    return R.to(dtype=dtype, device=device), t.to(dtype=dtype, device=device)


def apply(p, pts: torch.Tensor) -> torch.Tensor:
    """R pts + t for pts [..., N, 3]."""
    return pts @ p[0].transpose(-1, -2) + p[1][..., None, :]


def gaps(a, b):
    """(|t_a - t_b|, rotation angle of R_a^T R_b) per pose."""
    dt = torch.linalg.vector_norm(a[1] - b[1], dim=-1)
    # |R_a - R_b|_F = 2 sqrt(2) sin(angle / 2): exact for small angles too
    f = torch.linalg.matrix_norm(a[0] - b[0])
    return dt, 2.0 * torch.arcsin(torch.clamp(f / (2.0 * 2.0 ** 0.5), max=1.0))
