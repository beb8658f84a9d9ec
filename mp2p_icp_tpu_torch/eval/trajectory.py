"""Trajectory evaluation: ATE / RPE metrics + KITTI pose format.

The port's own copy of ``mp2p_icp_tpu/eval/trajectory.py`` (numpy; only
``poses_from_se3`` touches tensors): KITTI odometry pose-file IO,
Umeyama/SE(3) trajectory alignment, absolute trajectory error (ATE RMSE)
and relative pose error (RPE) as used by the KITTI benchmark and TUM tools.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def load_kitti_poses(path: str) -> np.ndarray:
    """KITTI odometry format: each line = row-major 3x4 [R|t]. -> [N, 4, 4]."""
    data = np.loadtxt(path).reshape(-1, 3, 4)
    n = data.shape[0]
    out = np.tile(np.eye(4), (n, 1, 1))
    out[:, :3, :] = data
    return out


def save_kitti_poses(path: str, poses: np.ndarray) -> None:
    flat = np.asarray(poses)[:, :3, :].reshape(-1, 12)
    np.savetxt(path, flat, fmt="%.9e")


def poses_from_se3(pose_list) -> np.ndarray:
    """List of core.se3.Pose -> [N, 4, 4] numpy. The poses are stacked on
    their device and fetched in two transfers (R, t), not two per pose."""
    R = torch.stack([p.R for p in pose_list]).cpu().numpy()
    t = torch.stack([p.t for p in pose_list]).cpu().numpy()
    N = R.shape[0]
    out = np.tile(np.eye(4), (N, 1, 1))
    out[:, :3, :3] = R
    out[:, :3, 3] = t
    return out


def umeyama_align(est_xyz: np.ndarray, gt_xyz: np.ndarray, with_scale=False):
    """Least-squares SE(3) (or Sim(3)) alignment est -> gt (Umeyama 1991).
    Returns (R, t, s)."""
    mu_e = est_xyz.mean(0)
    mu_g = gt_xyz.mean(0)
    E = est_xyz - mu_e
    G = gt_xyz - mu_g
    C = G.T @ E / est_xyz.shape[0]
    U, D, Vt = np.linalg.svd(C)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_e = (E**2).sum() / est_xyz.shape[0]
        s = float(np.trace(np.diag(D) @ S) / var_e)
    else:
        s = 1.0
    t = mu_g - s * R @ mu_e
    return R, t, s


def ate_rmse(est: np.ndarray, gt: np.ndarray, align: bool = True) -> float:
    """Absolute trajectory error RMSE over translations; est/gt: [N, 4, 4]."""
    e = est[:, :3, 3]
    g = gt[:, :3, 3]
    if align:
        R, t, s = umeyama_align(e, g)
        e = (s * (R @ e.T)).T + t
    return float(np.sqrt(np.mean(np.sum((e - g) ** 2, axis=1))))


def rpe(
    est: np.ndarray, gt: np.ndarray, delta: int = 1
) -> Tuple[float, float]:
    """Relative pose error over a frame delta: (trans RMSE [m],
    rot RMSE [rad])."""
    t_errs, r_errs = [], []
    for i in range(len(est) - delta):
        de = np.linalg.inv(est[i]) @ est[i + delta]
        dg = np.linalg.inv(gt[i]) @ gt[i + delta]
        err = np.linalg.inv(dg) @ de
        t_errs.append(np.linalg.norm(err[:3, 3]))
        c = np.clip((np.trace(err[:3, :3]) - 1) / 2, -1, 1)
        r_errs.append(np.arccos(c))
    return (
        float(np.sqrt(np.mean(np.square(t_errs)))),
        float(np.sqrt(np.mean(np.square(r_errs)))),
    )
