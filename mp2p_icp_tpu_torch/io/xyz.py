"""ASCII .xyz point-cloud files, optionally gzipped.

Port of ``mp2p_icp_tpu/io/xyz.py`` (reference: load_xyz_file.cpp:29-67):
N x 3 (or more columns, the first three taken) ASCII rows, ``.gz`` read and
written transparently.
"""

from __future__ import annotations

import gzip

import numpy as np

from mp2p_icp_tpu_torch.core.pointcloud import PointCloud
from mp2p_icp_tpu_torch.io.native import parse_float_table


def _open(path, mode):
    return (gzip.open if str(path).endswith(".gz") else open)(path, mode)


def load_xyz_file(path: str, decimation: int = 1, device=None) -> PointCloud:
    """The file's points (every ``decimation``-th row) as a cloud on
    ``device`` (default: the package's default device)."""
    with _open(path, "rb") as f:
        xyz = parse_float_table(f.read())
    xyz = xyz.reshape(-1, xyz.shape[-1])[:, :3]
    if decimation > 1:
        xyz = xyz[::decimation]
    return PointCloud.from_numpy(np.ascontiguousarray(xyz), device=device)


def save_xyz_file(path: str, pc: PointCloud) -> None:
    with _open(path, "wt") as f:
        np.savetxt(f, pc.to_numpy(), fmt="%.6f")
