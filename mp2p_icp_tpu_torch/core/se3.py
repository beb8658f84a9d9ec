"""SE(3) / SO(3) Lie-group math on torch tensors.

Port of ``mp2p_icp_tpu/core/se3.py``; the conventions are the same:

- A pose is ``Pose(R, t)``: rotation ``R[..., 3, 3]`` and translation
  ``t[..., 3]``; it acts on points as ``x -> R @ x + t``.
- Tangent vectors are ``[rho (3), theta (3)]``: translation part first.
- Small-angle branches use Taylor expansions selected with ``torch.where``,
  so every function stays branch-free on the host and broadcasts over
  leading axes.

Every function works on the device of its inputs; the two constructors
(``identity``, ``from_xyz_ypr``) take ``device=None`` as the package's
``default_device()``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mp2p_icp_tpu_torch.device import resolve

_EPS = 1e-8


class Pose(NamedTuple):
    """SE(3) element: ``x -> R @ x + t``. Broadcasts over leading axes."""

    R: torch.Tensor  # [..., 3, 3]
    t: torch.Tensor  # [..., 3]

    @property
    def batch_shape(self):
        return self.t.shape[:-1]

    def as_matrix(self) -> torch.Tensor:
        """Homogeneous [..., 4, 4] matrix."""
        top = torch.cat([self.R, self.t[..., :, None]], dim=-1)
        bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=self.R.dtype, device=self.R.device)
        return torch.cat([top, bottom.expand(self.batch_shape + (1, 4))], dim=-2)


def identity(dtype=torch.float32, device=None) -> Pose:
    device = resolve(device)
    return Pose(torch.eye(3, dtype=dtype, device=device),
                torch.zeros(3, dtype=dtype, device=device))


def from_matrix(T: torch.Tensor) -> Pose:
    """The pose of a homogeneous [..., 4, 4] matrix."""
    return Pose(T[..., :3, :3], T[..., :3, 3])


def matmul3(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A @ B for A [..., n, 3] and B [..., 3, m], as three broadcast
    products added in index order. Only elementwise kernels run, so a value
    does not depend on how many problems share the call: a library product
    may take another kernel, and another rounding, for a batch, and a fleet
    step must give each stream the pose and the map points of its own run."""
    return (A[..., :, 0, None] * B[..., 0, None, :] + A[..., :, 1, None] * B[..., 1, None, :]
            + A[..., :, 2, None] * B[..., 2, None, :])


def sum3(v: torch.Tensor) -> torch.Tensor:
    """The sum over the last axis of size 3, added left to right (the JAX
    package's three-term reductions on its CPU backend)."""
    return v[..., 0] + v[..., 1] + v[..., 2]


def _matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return matmul3(M, v[..., :, None])[..., 0]


def compose(a: Pose, b: Pose) -> Pose:
    """a ∘ b: apply b first, then a."""
    return Pose(matmul3(a.R, b.R), _matvec(a.R, b.t) + a.t)


def inverse(p: Pose) -> Pose:
    Rt = p.R.transpose(-1, -2)
    return Pose(Rt, -_matvec(Rt, p.t))


def apply(p: Pose, points: torch.Tensor) -> torch.Tensor:
    """Transform points [..., N, 3] (or a single [..., 3]) by the pose."""
    if points.ndim > p.t.ndim:
        return matmul3(points, p.R.transpose(-1, -2)) + p.t[..., None, :]
    return _matvec(p.R, points) + p.t


def rotate(p: Pose, vecs: torch.Tensor) -> torch.Tensor:
    """Rotate vectors (no translation) — for normals / line directions."""
    if vecs.ndim > p.t.ndim:
        return matmul3(vecs, p.R.transpose(-1, -2))
    return _matvec(p.R, vecs)


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: [..., 3] -> skew-symmetric [..., 3, 3]."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _eye_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def _sinc_coeffs(theta_sq: torch.Tensor):
    """(A, B, C) = (sinθ/θ, (1-cosθ)/θ², (θ-sinθ)/θ³) with Taylor guards."""
    theta = torch.sqrt(theta_sq + _EPS)
    small = theta_sq < 1e-8
    A = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(theta) / theta)
    B = torch.where(
        small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(theta)) / theta_sq
    )
    C = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0, (1.0 - A) / theta_sq)
    return A, B, C


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: axis-angle [..., 3] -> rotation matrix [..., 3, 3]."""
    theta_sq = torch.sum(w * w, dim=-1)
    A, B, _ = _sinc_coeffs(theta_sq)
    W = hat(w)
    return _eye_like(W) + A[..., None, None] * W + B[..., None, None] * matmul3(W, W)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> axis-angle [..., 3], numerically stable near 0 and π."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    w_vee = vee(R - R.transpose(-1, -2))  # = 2 sinθ * axis
    sin_theta = torch.sin(theta)
    # generic branch: θ/(2 sinθ) * vee(R - Rᵀ), Taylor-guarded near θ = 0
    generic_scale = torch.where(
        torch.abs(sin_theta) < 1e-6,
        0.5 + theta * theta / 12.0,
        theta
        / (2.0 * torch.clamp(torch.abs(sin_theta), min=_EPS))
        * torch.sign(sin_theta),
    )
    w_generic = generic_scale[..., None] * w_vee
    # near π: vee(R - Rᵀ) ~ 0; recover the axis from the diagonal of (R+I)/2
    near_pi = cos_theta < -1.0 + 1e-5
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis = torch.sqrt(torch.clamp((diag + 1.0) * 0.5, 0.0, 1.0))
    off = torch.stack(
        [
            R[..., 2, 1] + R[..., 1, 2],  # ~ 2*ay*az
            R[..., 0, 2] + R[..., 2, 0],  # ~ 2*ax*az
            R[..., 1, 0] + R[..., 0, 1],  # ~ 2*ax*ay
        ],
        dim=-1,
    )
    # signs from the symmetric-part entries coupling each component to the
    # largest one (the anchor)
    imax = torch.argmax(axis, dim=-1)
    sign_anchor = torch.gather(axis, -1, imax[..., None])
    coupling = torch.stack(
        [
            torch.stack([diag[..., 0], off[..., 2], off[..., 1]], dim=-1),
            torch.stack([off[..., 2], diag[..., 1], off[..., 0]], dim=-1),
            torch.stack([off[..., 1], off[..., 0], diag[..., 2]], dim=-1),
        ],
        dim=-2,
    )  # [..., 3, 3]
    row = torch.gather(
        coupling, -1, imax[..., None, None].expand(*imax.shape, 3, 1)
    )[..., 0]
    is_anchor = torch.arange(3, device=R.device) == imax[..., None]
    signs = torch.where(is_anchor, torch.ones_like(row), torch.sign(row))
    w_pi = theta[..., None] * axis * signs * torch.sign(sign_anchor + _EPS)
    return torch.where(near_pi[..., None], w_pi, w_generic)


def so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Left Jacobian J_l of SO(3)."""
    theta_sq = torch.sum(w * w, dim=-1)
    _, B, C = _sinc_coeffs(theta_sq)
    W = hat(w)
    return _eye_like(W) + B[..., None, None] * W + C[..., None, None] * matmul3(W, W)


def so3_left_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    theta_sq = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta_sq + _EPS)
    W = hat(w)
    small = theta_sq < 1e-8
    half_theta = 0.5 * theta
    cot_term = torch.where(
        small,
        1.0 / 12.0 + theta_sq / 720.0,
        (
            1.0
            - half_theta
            * torch.cos(half_theta)
            / torch.clamp(torch.sin(half_theta), min=_EPS)
        )
        / torch.clamp(theta_sq, min=_EPS),
    )
    return _eye_like(W) - 0.5 * W + cot_term[..., None, None] * matmul3(W, W)


def exp(tangent: torch.Tensor) -> Pose:
    """se(3) exp: [..., 6] = [rho, theta] -> Pose. t = J_l(theta) @ rho."""
    rho, theta = tangent[..., :3], tangent[..., 3:]
    return Pose(so3_exp(theta), _matvec(so3_left_jacobian(theta), rho))


def log(p: Pose) -> torch.Tensor:
    """SE(3) log: Pose -> [..., 6] = [rho, theta]."""
    theta = so3_log(p.R)
    rho = _matvec(so3_left_jacobian_inv(theta), p.t)
    return torch.cat([rho, theta], dim=-1)


def _se3_Q(rho: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Barfoot's Q(xi) — the off-diagonal block of the SE(3) left Jacobian
    (State Estimation for Robotics, eq. 7.86). Taylor-guarded."""
    th_sq = torch.sum(theta * theta, dim=-1)
    th = torch.sqrt(th_sq + _EPS)
    P = hat(rho)
    T = hat(theta)
    small = th_sq < 1e-8
    c1 = torch.where(
        small, 1.0 / 6.0 - th_sq / 120.0, (th - torch.sin(th)) / (th_sq * th)
    )
    c2 = torch.where(
        small,
        1.0 / 24.0 - th_sq / 720.0,
        (1.0 - 0.5 * th_sq - torch.cos(th)) / (th_sq * th_sq),
    )
    c3_big = 0.5 * (
        c2 - 3.0 * (th - torch.sin(th) - th_sq * th / 6.0) / (th_sq * th_sq * th)
    )
    c3 = torch.where(
        small, torch.full_like(c3_big, 0.5 * (1.0 / 24.0 + 3.0 / 120.0)), c3_big
    )
    TP = matmul3(T, P)
    PT = matmul3(P, T)
    TPT = matmul3(TP, T)
    TT = matmul3(T, T)
    return (
        0.5 * P
        + c1[..., None, None] * (TP + PT + matmul3(T, PT))
        - c2[..., None, None] * (matmul3(TT, P) + matmul3(P, TT) - 3.0 * TPT)
        - c3[..., None, None] * (matmul3(TPT, T) + matmul3(TT, PT))
    )


def se3_left_jacobian_inv(xi: torch.Tensor) -> torch.Tensor:
    """Inverse left Jacobian of SE(3) for xi = [rho, theta]:
    [[Jl^-1, -Jl^-1 Q Jl^-1], [0, Jl^-1]] (6x6)."""
    rho, theta = xi[..., :3], xi[..., 3:]
    Jinv = so3_left_jacobian_inv(theta)
    Q = _se3_Q(rho, theta)
    top = torch.cat([Jinv, -matmul3(matmul3(Jinv, Q), Jinv)], dim=-1)
    bottom = torch.cat([torch.zeros_like(Q), Jinv], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def se3_right_jacobian_inv(xi: torch.Tensor) -> torch.Tensor:
    """Jr^-1(xi) = Jl^-1(-xi)."""
    return se3_left_jacobian_inv(-xi)


def adjoint(p: Pose) -> torch.Tensor:
    """SE(3) adjoint for the tangent order [rho, theta]:
    Ad(T) = [[R, hat(t) R], [0, R]] (6x6), so that
    T exp(xi) T^-1 = exp(Ad(T) xi)."""
    top = torch.cat([p.R, matmul3(hat(p.t), p.R)], dim=-1)
    bottom = torch.cat([torch.zeros_like(p.R), p.R], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [..., 4] = (w, x, y, z) -> rotation matrix."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack(
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                dim=-1,
            ),
            torch.stack(
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                dim=-1,
            ),
            torch.stack(
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
                dim=-1,
            ),
        ],
        dim=-2,
    )


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion (w, x, y, z), canonical w >= 0.
    Four candidates, one per largest diagonal element of the quaternion
    outer-product matrix, selected by argmax (no host branch)."""
    r00, r01, r02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    r10, r11, r12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    r20, r21, r22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tw = 1.0 + r00 + r11 + r22
    tx = 1.0 + r00 - r11 - r22
    ty = 1.0 - r00 + r11 - r22
    tz = 1.0 - r00 - r11 + r22
    qw = torch.stack([tw, r21 - r12, r02 - r20, r10 - r01], dim=-1)
    qx = torch.stack([r21 - r12, tx, r01 + r10, r02 + r20], dim=-1)
    qy = torch.stack([r02 - r20, r01 + r10, ty, r12 + r21], dim=-1)
    qz = torch.stack([r10 - r01, r02 + r20, r12 + r21, tz], dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # [..., 4(cand), 4(comp)]
    best = torch.argmax(torch.stack([tw, tx, ty, tz], dim=-1), dim=-1)
    q = torch.gather(
        cands, -2, best[..., None, None].expand(*best.shape, 1, 4)
    )[..., 0, :]
    q = q * torch.sign(q[..., :1] + _EPS)
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def from_xyz_ypr(x, y, z, yaw, pitch, roll, dtype=torch.float32, device=None) -> Pose:
    """Pose from translation + yaw/pitch/roll (ZYX convention, radians),
    matching the reference's CPose3D(x, y, z, yaw, pitch, roll)."""
    device = resolve(device)
    x, y, z, yaw, pitch, roll = (
        torch.as_tensor(v, dtype=dtype, device=device)
        for v in (x, y, z, yaw, pitch, roll)
    )
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cr, sr = torch.cos(roll), torch.sin(roll)
    R = torch.stack(
        [
            torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], -1),
            torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], -1),
            torch.stack([-sp, cp * sr, cp * cr], -1),
        ],
        dim=-2,
    )
    return Pose(R, torch.stack([x, y, z], dim=-1))


def delta_norms(a: Pose, b: Pose):
    """(translation, rotation) norms of log(a⁻¹ ∘ b) — the reference's
    termination metric (ICP.cpp:191-229)."""
    d = log(compose(inverse(a), b))
    return (
        torch.linalg.vector_norm(d[..., :3], dim=-1),
        torch.linalg.vector_norm(d[..., 3:], dim=-1),
    )


def error_log_norm(gt: Pose, est: Pose) -> torch.Tensor:
    """‖log(gt⁻¹ ∘ est)‖ — the end-to-end accuracy metric."""
    return torch.linalg.vector_norm(log(compose(inverse(gt), est)), dim=-1)


def random_pose(generator: torch.Generator, max_trans: float = 1.0,
                max_angle: float = 3.1415, device=None) -> Pose:
    """Uniform random pose for tests: a random axis, an angle U(0,
    max_angle) and translation components U(-max_trans, max_trans), drawn
    from ``generator`` (the JAX package draws from a PRNG key instead, so
    the values differ; the distribution is the same)."""
    device = resolve(device)
    axis = torch.randn(3, generator=generator, device=generator.device)
    axis = axis / torch.linalg.vector_norm(axis)
    angle = torch.rand((), generator=generator, device=generator.device) * max_angle
    t = (torch.rand(3, generator=generator, device=generator.device) * 2.0 - 1.0) * max_trans
    return Pose(so3_exp(axis * angle).to(device), t.to(device))
