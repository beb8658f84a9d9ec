"""One-to-one pairing resolution.

Port of ``resolve_one_to_one`` from ``mp2p_icp_tpu/ops/nn.py`` (the grid-hash
``nn_search`` there is a documented fallback that no production path calls,
so it is not ported).
"""

from __future__ import annotations

import torch

_BIG = 3.0e37
_NO_IDX = 2147483647


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
