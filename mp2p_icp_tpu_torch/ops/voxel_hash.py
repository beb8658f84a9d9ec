"""Spatial grid-hash construction: the index behind ``ops.nn.nn_search``.

Port of ``mp2p_icp_tpu/ops/voxel_hash.py``. The reference's NN structure is
a nanoflann KD-tree (Matcher_Points_Base.cpp:104-114); its voxel decimation
uses a Teschner spatial hash (PointCloudToVoxelGrid.h:88-116, constants
73856093 / 19349663 / 83492791). The grid hash is the sort-based dual of
the KD-tree: build = hash + stable sort + searchsorted, query = gather over
a fixed candidate set (``ops/nn.py``). It runs on the device of its inputs.

- The table size is a power of two; collisions only add false candidates,
  which the distance test filters (equal cells always hash equally).
- Invalid points go to one bucket past the last and never match.
- The hash is the JAX package's int32 expression, which wraps on
  overflow; here it is formed in int64 and masked with ``H - 1``: the
  low bits of a product and of an XOR do not depend on the high ones, so
  every bucket is the JAX package's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

# Teschner et al. optimised spatial hash constants (same as the reference).
_HX = 73856093
_HY = 19349663
_HZ = 83492791


class HashGrid(NamedTuple):
    """Sorted spatial hash index over a fixed-capacity point set.

    points_sorted: [C, 3] points reordered by bucket hash
    order:         [C] i32 original index of each sorted row
    valid_sorted:  [C] validity of each sorted row
    bucket_start:  [H] i32 first sorted row of each hash bucket
    bucket_count:  [H] i32 number of rows in each bucket
    cell_size:     float, metres per cell (must be >= the query radius
                   for 27-cell completeness)
    """

    points_sorted: torch.Tensor
    order: torch.Tensor
    valid_sorted: torch.Tensor
    bucket_start: torch.Tensor
    bucket_count: torch.Tensor
    cell_size: float


def cell_coords(points: torch.Tensor, cell_size) -> torch.Tensor:
    return torch.floor(points / cell_size).to(torch.int32)


def hash_cells(cells: torch.Tensor, table_size: int) -> torch.Tensor:
    """Teschner hash of integer cell coords into [0, table_size), int64."""
    c = cells.to(torch.int64)
    h = (c[..., 0] * _HX) ^ (c[..., 1] * _HY) ^ (c[..., 2] * _HZ)
    return h & (table_size - 1)


def _table_size_for(capacity: int) -> int:
    # ~2x points for low collision rate, power of two, min 1024
    ts = 1024
    while ts < 2 * capacity:
        ts *= 2
    return ts


def build_hash_grid(
    points: torch.Tensor,
    valid: torch.Tensor,
    cell_size: float,
    table_size: Optional[int] = None,
) -> HashGrid:
    """Build the sorted hash index: [C] points in, [C] sorted rows and an
    [H] bucket table out."""
    C = points.shape[0]
    H = table_size or _table_size_for(C)
    h = hash_cells(cell_coords(points, cell_size), H)
    # invalid points go one past the last bucket so they never match
    h = torch.where(valid, h, H)
    order = torch.sort(h, stable=True).indices  # jnp.argsort is stable
    h_sorted = h[order]
    buckets = torch.arange(H, dtype=h_sorted.dtype, device=h.device)
    bucket_start = torch.searchsorted(h_sorted, buckets, side="left").to(torch.int32)
    bucket_end = torch.searchsorted(h_sorted, buckets, side="right").to(torch.int32)
    return HashGrid(
        points_sorted=points[order],
        order=order.to(torch.int32),
        valid_sorted=h_sorted < H,
        bucket_start=bucket_start,
        bucket_count=bucket_end - bucket_start,
        cell_size=float(cell_size),
    )


# The 27 neighbour offsets of a 3x3x3 cell neighbourhood, in the JAX
# package's order (which fixes the order of the candidates, and so ties).
NEIGHBOR_OFFSETS = np.stack(
    np.meshgrid(np.arange(-1, 2), np.arange(-1, 2), np.arange(-1, 2), indexing="ij"),
    axis=-1,
).reshape(27, 3)
