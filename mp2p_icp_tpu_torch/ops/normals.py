"""Per-point normal estimation — plane-capable point maps.

Port of ``mp2p_icp_tpu/ops/normals.py``. The reference's
Matcher_Point2Plane asks the map for the nearest plane (NearestPlaneCapable,
Matcher_Point2Plane.cpp:41-114), and its plane-capable maps fit a plane per
cell at insertion time. For plain point layers: fit a normal per point once,
from its kNN neighbourhood (the closed-form 3x3 eigendecomposition), and
store it on the cloud's ``normals`` channel, so that a registration
iteration only gathers.

A normal is zero where the neighbourhood is not plane-like (the matchers'
criterion l0 < eigen_threshold * l2), which the matchers read as "no plane
here". The kNN is ``knn_bruteforce``: on CUDA tensors the K1 kernel with
k = ``knn`` (K2, through ``knn_bruteforce_batched``, for a batch of clouds).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from mp2p_icp_tpu_torch.core.pointcloud import PointCloud, take_rows
from mp2p_icp_tpu_torch.ops.eigen import estimate_points_eigen
from mp2p_icp_tpu_torch.ops.nn_bruteforce import knn_bruteforce, knn_bruteforce_batched
from mp2p_icp_tpu_torch.utils.profiler import spanned


@spanned("normals.fit")
def estimate_point_normals(
    pc: PointCloud,
    knn: int = 8,
    max_radius: float = 2.0,
    plane_eigen_threshold: float = 1e-2,
    min_points_to_fit: int = 4,
    source: Optional[PointCloud] = None,
    source_valid: Optional[torch.Tensor] = None,
) -> PointCloud:
    """``pc`` with a ``normals`` channel fitted from each point's kNN
    neighbourhood; zero where it is not planar or holds too few points.

    source: optional denser cloud to take the neighbourhoods from (the
    accumulated map plus the new scan, while ``pc`` is the new points);
    source_valid: its validity when it is not the leading rows.

    A batch of clouds (xyz [B, Q, 3], with ``source`` [B, C, 3] when given)
    is fitted as B problems; its kNN is one batched sweep (K2 on CUDA
    tensors)."""
    src = source if source is not None else pc
    valid = pc.valid_mask()
    sv = source_valid if source_valid is not None else src.valid_mask()
    front_end = knn_bruteforce_batched if pc.xyz.ndim == 3 else knn_bruteforce
    res = front_end(
        pc.xyz, valid, src.xyz, sv, k=knn, max_radius_sq=max_radius * max_radius,
    )
    rows = torch.clamp(res.idx, 0, src.capacity - 1).long()  # [..., Q, k]
    neigh = take_rows(src.xyz, rows.flatten(-2)).reshape(rows.shape + (3,))
    pe = estimate_points_eigen(neigh, res.valid)
    enough = pe.count >= min_points_to_fit
    is_plane = pe.eigenvalues[..., 0] < plane_eigen_threshold * pe.eigenvalues[..., 2]
    keep = valid & enough & is_plane
    normals = torch.where(keep[..., None], pe.eigenvectors[..., 0], 0.0)
    return dataclasses.replace(pc, normals=normals)
