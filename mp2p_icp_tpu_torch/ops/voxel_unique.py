"""FirstPoint voxel winners by one stable sort of the packed cell key.

Port of ``first_point_select`` of ``mp2p_icp_tpu/ops/voxel_unique.py``
(reference: PointCloudToVoxelGrid.h:35-136, a robin_map spatial hash).
Points are sorted by their integer cell; the sort is stable, so the first
row of each run of equal keys is the lowest input index of its voxel, the
FirstPoint winner. Everything has a fixed capacity: invalid points sort
last under the largest key.

The JAX package sorts two int32 key words; here they are packed into one
int64 key, which orders the same way (k1 < 2^30, k2 < 2^15).
``voxel_segments`` (the other decimation methods) is not ported yet.
"""

from __future__ import annotations

import torch

OFFSET = 1 << 14  # cells in [-16384, 16383] per axis
SENTINEL = 2147483647  # the key words of an invalid row (int32 max)
_INVALID_KEY = torch.iinfo(torch.int64).max


def voxel_cells(xyz: torch.Tensor, voxel_size) -> torch.Tensor:
    """[..., C, 3] int64 cells floor(xyz / voxel_size) + OFFSET, clipped to
    [0, 2·OFFSET). The divide is kept (not a multiply by the reciprocal),
    so a point on a cell border falls in the same voxel as in the JAX
    package. The clip is done in float, before the conversion, so that
    padding rows (1e8) and infinities stay defined at any resolution."""
    cells = torch.floor(torch.nan_to_num(xyz / voxel_size, nan=0.0))
    return torch.clamp(cells, -OFFSET, OFFSET - 1).to(torch.int64) + OFFSET


def key_words(cells: torch.Tensor, valid: torch.Tensor):
    """The exact two-word voxel key (k1 = (c0 << 15) | c1 < 2^30, k2 = c2)
    as int64; invalid rows get (SENTINEL, SENTINEL)."""
    k1 = torch.where(valid, cells[..., 0] * (1 << 15) + cells[..., 1], SENTINEL)
    k2 = torch.where(valid, cells[..., 2], SENTINEL)
    return k1, k2


def first_point_select(xyz: torch.Tensor, valid: torch.Tensor, voxel_size,
                       out_cap: int, flatten_z: bool = False):
    """FirstPoint voxel winners of xyz [..., C, 3] with valid [..., C];
    leading axes are independent problems, sorted and compacted together.
    Returns (sel [..., out_cap] int64, n_voxels [...]): sel[j] is the input
    index of the winner of the voxel of rank j (voxels in key order) for
    j < min(n_voxels, out_cap), and C beyond."""
    C = xyz.shape[-2]
    cells = voxel_cells(xyz, voxel_size)
    if flatten_z:
        cells = torch.cat([cells[..., :2], torch.zeros_like(cells[..., :1])], dim=-1)
    k1, k2 = key_words(cells, valid)
    key = torch.where(valid, k1 * (1 << 15) + k2, _INVALID_KEY)
    keys, order = torch.sort(key, dim=-1, stable=True)
    first = torch.ones_like(keys[..., :1], dtype=torch.bool)
    new_seg = torch.cat([first, keys[..., 1:] != keys[..., :-1]], dim=-1) & (keys != _INVALID_KEY)
    seg_id = torch.cumsum(new_seg, dim=-1) - 1
    n = torch.sum(new_seg, dim=-1, dtype=torch.int32)
    # a winner goes to its voxel rank; every other row to slot out_cap
    dest = torch.where(new_seg & (seg_id < out_cap), seg_id, out_cap)
    sel = torch.full(key.shape[:-1] + (out_cap + 1,), C, dtype=torch.int64, device=xyz.device)
    return sel.scatter_(-1, dest, order)[..., :out_cap], n
