"""Grid-hash nearest-neighbour queries and one-to-one pairing resolution.

Port of ``mp2p_icp_tpu/ops/nn.py``:

- ``nn_search``: k nearest neighbours of each query among the candidates
  of its 27 neighbour cells in a ``voxel_hash.HashGrid``. A documented,
  bounded-memory fallback of the exact kNN (``ops.nn_bruteforce``, whose
  kernels every production path calls): a query gathers 27 * k_per_cell
  candidate rows instead of sweeping the whole map. Exact within
  ``grid.cell_size`` as long as no bucket holds more than ``k_per_cell``
  rows. Plain PyTorch on the device of its inputs (gathers, one
  reduction), as in the JAX package, which has no kernel for it.
- ``resolve_one_to_one``: the production one-to-one pairing resolver of
  the DistanceThreshold matcher.
"""

from __future__ import annotations

import torch

from mp2p_icp_tpu_torch.core.se3 import sum3
from mp2p_icp_tpu_torch.ops.nn_bruteforce import NNResult
from mp2p_icp_tpu_torch.ops.voxel_hash import (
    NEIGHBOR_OFFSETS,
    HashGrid,
    cell_coords,
    hash_cells,
)

_BIG = 3.0e37
_NO_IDX = 2147483647

__all__ = ["NNResult", "nn_search", "resolve_one_to_one"]


def _gather_candidates(grid: HashGrid, queries: torch.Tensor, k_per_cell: int):
    """Candidate rows [Q, 27 * k_per_cell] (sorted-row indices, int64) and
    their validity. As in the JAX package (and the reference behaviour
    kept): when two of the 27 neighbour cells hash into one bucket, its rows
    are gathered twice, and a k > 1 result may hold one neighbour twice."""
    H = grid.bucket_start.shape[0]
    offsets = torch.from_numpy(NEIGHBOR_OFFSETS).to(torch.int32).to(queries.device)
    ncells = cell_coords(queries, grid.cell_size)[:, None, :] + offsets[None]  # [Q, 27, 3]
    nh = hash_cells(ncells, H)  # [Q, 27]
    start = grid.bucket_start[nh].to(torch.int64)
    count = grid.bucket_count[nh]
    slot = torch.arange(k_per_cell, device=queries.device)
    rows = start[..., None] + slot  # [Q, 27, k]
    cand_valid = slot < count[..., None]
    rows = torch.clamp(rows, 0, grid.points_sorted.shape[0] - 1)
    Q = queries.shape[0]
    return rows.reshape(Q, -1), cand_valid.reshape(Q, -1)


def nn_search(
    grid: HashGrid,
    queries: torch.Tensor,
    query_valid: torch.Tensor,
    k: int = 1,
    k_per_cell: int = 8,
    max_radius_sq=None,
) -> NNResult:
    """k nearest neighbours of each query point within the 27-cell
    neighbourhood (exact within grid.cell_size).

    queries: [Q, 3]; query_valid: [Q] bool; max_radius_sq: a number or a
    0-d tensor, pairs at or beyond it are invalid. Returns idx [Q, k]
    (original rows, -1 invalid), dist_sq [Q, k] (3e37 invalid), valid.
    Ties go to the lower candidate slot, as ``jnp.argmin`` and
    ``jax.lax.top_k`` give them.
    """
    rows, cand_valid = _gather_candidates(grid, queries, k_per_cell)  # [Q, M]
    d = grid.points_sorted[rows] - queries[:, None, :]
    dist_sq = sum3(d * d)  # the JAX package's order of the three terms
    cand_valid = cand_valid & grid.valid_sorted[rows] & query_valid[:, None]
    if max_radius_sq is not None:
        cand_valid = cand_valid & (dist_sq < max_radius_sq)
    dist_sq = torch.where(cand_valid, dist_sq, _BIG)
    if k == 1:
        best = torch.argmin(dist_sq, dim=-1, keepdim=True)  # the first of equal minima
    else:
        best = torch.sort(dist_sq, dim=-1, stable=True).indices[:, :k]
    bd = torch.gather(dist_sq, -1, best)
    brow = torch.gather(rows, -1, best)
    valid = bd < _BIG
    idx = torch.where(valid, grid.order[brow], -1)
    return NNResult(idx=idx, dist_sq=bd, valid=valid)


def resolve_one_to_one(
    nn_idx: torch.Tensor,
    nn_dist_sq: torch.Tensor,
    nn_valid: torch.Tensor,
    n_global_capacity: int,
) -> torch.Tensor:
    """Enforce one-to-one local<->global pairing: when several local points
    claim the same global point, only the closest keeps it (ties: lowest
    local index). Returns the refined valid mask [Q] (k=1 claims only).

    The JAX package sorts lexicographically by (global idx, distance, local
    row) in one multi-key sort. Here the same order comes from chained
    stable sorts, least significant key first: rows are already ascending,
    then a stable sort by distance, then a stable sort by global idx. The
    winners are the heads of the equal-idx runs. Written out of place, so
    it runs under torch.func.vmap."""
    Q = nn_idx.shape[0]
    valid0 = nn_valid[:, 0]
    idx = torch.where(valid0, nn_idx[:, 0], _NO_IDX)
    d = torch.where(valid0, nn_dist_sq[:, 0], _BIG)
    by_d = torch.sort(d, stable=True).indices
    perm = by_d[torch.sort(idx[by_d], stable=True).indices]
    idx_s = idx[perm]
    is_head = torch.cat([torch.ones(1, dtype=torch.bool, device=idx.device),
                         idx_s[1:] != idx_s[:-1]])
    return torch.zeros(Q, dtype=torch.bool, device=idx.device).scatter(
        0, perm, is_head & (idx_s != _NO_IDX))
