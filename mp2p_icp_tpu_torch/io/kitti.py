"""KITTI odometry .bin scans.

Port of ``mp2p_icp_tpu/io/kitti.py`` (reference: apps/kitti2mm/main.cpp:46-77):
a KITTI velodyne scan is flat float32 [N, 4] (x, y, z, intensity), 16 bytes
a point.
"""

from __future__ import annotations

import numpy as np

from mp2p_icp_tpu_torch.core.pointcloud import PointCloud


def load_kitti_bin(path: str, capacity: int = None, device=None) -> PointCloud:
    """The scan as a cloud with an intensity channel, at ``capacity``
    (default: the point count rounded up to a power of two), on ``device``
    (default: the package's default device)."""
    raw = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    return PointCloud.from_numpy(raw[:, :3], capacity=capacity, intensity=raw[:, 3],
                                 device=device)


def save_kitti_bin(path: str, pc: PointCloud) -> None:
    n = int(pc.count)
    out = np.zeros((n, 4), np.float32)
    out[:, :3] = pc.to_numpy()
    if pc.intensity is not None:
        out[:, 3] = pc.intensity[:n].cpu().numpy()
    out.tofile(path)
