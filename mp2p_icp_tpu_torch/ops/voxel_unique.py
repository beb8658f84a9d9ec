"""Voxel segments of a point set by one stable sort of the packed cell key.

Port of ``first_point_select`` and ``voxel_segments`` of
``mp2p_icp_tpu/ops/voxel_unique.py`` (reference:
PointCloudToVoxelGrid.h:35-136, a robin_map spatial hash).
Points are sorted by their integer cell; the sort is stable, so the first
row of each run of equal keys is the lowest input index of its voxel, the
FirstPoint winner. Everything has a fixed capacity: invalid points sort
last under the largest key.

The JAX package sorts two int32 key words; here they are packed into one
int64 key, which orders the same way (k1 < 2^30, k2 < 2^15).
``voxel_segments`` gives the sorted view that the other decimation methods
reduce over; ``segment_sums_in_order`` and ``segment_argmin`` are those
reductions, each with one result whatever the device's order of atomics.
"""

from __future__ import annotations

import math
from typing import NamedTuple

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


class VoxelSegments(NamedTuple):
    """Sorted-by-voxel view of a point set (the JAX package's fields).
    order:      [C] original index of each sorted row
    segment_id: [C] voxel segment of each sorted row (the invalid rows
                form one last segment)
    valid:      [C] sorted-row validity
    n_voxels:   0-d int32, the occupied voxels
    first_in_segment: [C] bool, True at each valid segment's first row"""

    order: torch.Tensor
    segment_id: torch.Tensor
    valid: torch.Tensor
    n_voxels: torch.Tensor
    first_in_segment: torch.Tensor


def voxel_segments(xyz: torch.Tensor, valid: torch.Tensor, voxel_size,
                   flatten_z: bool = False) -> VoxelSegments:
    """The voxel segments of xyz [C, 3] with valid [C]: one stable sort of
    the packed key (rows of one voxel keep their input order)."""
    cells = voxel_cells(xyz, voxel_size)
    if flatten_z:
        cells = torch.cat([cells[..., :2], torch.zeros_like(cells[..., :1])], dim=-1)
    k1, k2 = key_words(cells, valid)
    key = torch.where(valid, k1 * (1 << 15) + k2, _INVALID_KEY)
    keys, order = torch.sort(key, stable=True)
    new_seg = torch.ones_like(keys, dtype=torch.bool)
    new_seg[1:] = keys[1:] != keys[:-1]
    valid_sorted = keys != _INVALID_KEY
    first = new_seg & valid_sorted
    return VoxelSegments(
        order=order,
        segment_id=torch.cumsum(new_seg, dim=0) - 1,
        valid=valid_sorted,
        n_voxels=torch.sum(first, dtype=torch.int32),
        first_in_segment=first,
    )


def segment_sums_in_order(values: torch.Tensor, segs: VoxelSegments,
                          num_segments: int) -> torch.Tensor:
    """[num_segments, ...] sums of ``values`` (sorted rows [C, ...]) per
    segment, each added row by row in sorted order from 0, as the JAX
    package's segment_sum adds them on its CPU backend. A scatter-add on
    the card would add in the order of its atomics, which changes from run
    to run. ``torch.segment_reduce`` of 2-D data adds each segment's rows
    in order, one thread per segment and column, on the card as on the CPU
    (its 1-D form reduces in a tree on the card, so the data is kept 2-D).
    The invalid rows, sorted last, get length 0 and are not read."""
    lens = torch.zeros(num_segments, dtype=torch.int64, device=values.device)
    lens = lens.index_add(0, segs.segment_id, segs.valid.to(torch.int64))
    flat = values.reshape(values.shape[0], math.prod(values.shape[1:]))
    sums = torch.segment_reduce(flat, "sum", lengths=lens, unsafe=True)
    return sums.reshape((num_segments,) + values.shape[1:])


def segment_argmin(segs: VoxelSegments, values: torch.Tensor, num_segments: int) -> torch.Tensor:
    """[num_segments] original index of the row that minimises ``values``
    (sorted rows) in each segment; on ties the first sorted row, i.e. the
    lowest original index (the JAX package's ``_segment_argmin``). Empty
    segments give order[C - 1]."""
    C = values.shape[0]
    seg = segs.segment_id
    v = torch.where(segs.valid, values, 3e37)
    mins = torch.full((num_segments,), torch.inf, device=values.device)
    mins = mins.scatter_reduce(0, seg, v, "amin")
    won = (v <= mins[seg]) & segs.valid
    rows = torch.arange(C, device=values.device)
    win_row = torch.full((num_segments,), C, dtype=torch.int64, device=values.device)
    win_row = win_row.scatter_reduce(0, seg, torch.where(won, rows, C), "amin")
    return segs.order[torch.clamp(win_row, 0, C - 1)]
