"""Ring-ordered curvature classification filter.

Port of ``mp2p_icp_tpu/filters/curvature.py`` (reference:
FilterCurvature.cpp:59-251). Per LiDAR ring: (1) drop points closer than
``min_clearance`` (inf-norm) to their predecessor; (2) for each kept point,
look at its ring neighbours (wrapping): a gap larger than ``max_gap`` marks
a discontinuity border ("larger" when this point is nearer the sensor than
its predecessor, else "other"); otherwise the angle between the incoming
and outgoing segments decides: |cos| < max_cosine -> larger curvature, else
smaller. Rings with <= 3 points are "larger" wholesale.

The points are sorted stably by ring, so each ring keeps its scan order;
the per-ring recurrences become segment minima and maxima with wrap-around
through each ring's first and last row. The JAX package's documented
deviation is kept: the clearance test compares against the previous *raw*
ring point, not the previous *accepted* one (the reference's sequential
dependency); on real scans they differ only for runs of sub-clearance
points.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from mp2p_icp_tpu_torch.core.pointcloud import PointCloud
from mp2p_icp_tpu_torch.core.se3 import sum3
from mp2p_icp_tpu_torch.filters.base import FilterBase
from mp2p_icp_tpu_torch.filters.common import compact

_NO_RING = 1 << 20  # the ring key of an invalid row: after every real ring


def mask_at(rows: torch.Tensor, mask: torch.Tensor, C: int) -> torch.Tensor:
    """[C] bool, True at ``rows[i]`` wherever ``mask[i]``."""
    out = torch.zeros(C + 1, dtype=torch.bool, device=rows.device)
    out[torch.where(mask, rows, C)] = True
    return out[:C]


@dataclasses.dataclass(frozen=True)
class FilterCurvature(FilterBase):
    """Params (reference: FilterCurvature.h:54-70, defaults preserved)."""

    input_pointcloud_layer: str = "raw"
    output_layer_larger_curvature: Optional[str] = None
    output_layer_smaller_curvature: Optional[str] = None
    output_layer_other: Optional[str] = None
    max_cosine: float = 0.5
    min_clearance: float = 0.02
    max_gap: float = 1.00

    def __call__(self, layers: Dict[str, PointCloud], variables=None):
        pc = layers[self.input_pointcloud_layer]
        if pc.ring is None:
            raise ValueError(
                f"FilterCurvature: layer '{self.input_pointcloud_layer}' needs a 'ring' channel")
        if not (self.output_layer_larger_curvature or self.output_layer_smaller_curvature):
            raise ValueError(
                "FilterCurvature: at least one of larger/smaller output layers must be set")
        C, dev = pc.capacity, pc.device
        valid = pc.valid_mask()
        ring = torch.where(valid, pc.ring.to(torch.int64), _NO_RING)
        rs, order = torch.sort(ring, stable=True)
        xyz_s = pc.xyz[order]
        valid_s = rs < _NO_RING
        row = torch.arange(C, device=dev)
        new_ring = torch.ones(C, dtype=torch.bool, device=dev)
        new_ring[1:] = rs[1:] != rs[:-1]

        # (1) clearance against the previous raw ring point
        prev_raw = torch.clamp(row - 1, 0, C - 1)
        d_prev = torch.abs(xyz_s - xyz_s[prev_raw]).amax(dim=-1)
        accept = valid_s & (new_ring | (d_prev >= self.min_clearance))

        # the accepted rows to the front, in ring order
        acc_order = torch.sort((~accept).to(torch.uint8), stable=True).indices
        a_valid = row < torch.sum(accept)
        a_xyz = xyz_s[acc_order]
        a_ring = rs[acc_order]
        a_orig = order[acc_order]  # the input row of each accepted row

        # ring segments over the accepted rows
        a_new = torch.ones(C, dtype=torch.bool, device=dev)
        a_new[1:] = a_ring[1:] != a_ring[:-1]
        a_new = a_new | ~a_valid
        a_seg = torch.cumsum(a_new, dim=0) - 1
        a_start = torch.full((C,), C, dtype=torch.int64, device=dev).scatter_reduce(
            0, a_seg, torch.where(a_valid, row, C), "amin")
        a_end = torch.full((C,), -1, dtype=torch.int64, device=dev).scatter_reduce(
            0, a_seg, torch.where(a_valid, row, -1), "amax")
        start, end = a_start[a_seg], a_end[a_seg]
        ring_size = torch.clamp(end - start + 1, min=0)

        # wrap-around neighbours within the ring
        im1 = torch.clamp(torch.where(row > start, row - 1, end), 0, C - 1)
        ip1 = torch.clamp(torch.where(row < end, row + 1, start), 0, C - 1)
        pt, ptm1, ptp1 = a_xyz, a_xyz[im1], a_xyz[ip1]

        gap_sqr = self.max_gap ** 2
        d_m1 = sum3(torch.square(pt - ptm1))
        d_p1 = sum3(torch.square(pt - ptp1))
        at_gap = (d_m1 > gap_sqr) | (d_p1 > gap_sqr)
        nearer = sum3(pt * pt) < sum3(ptm1 * ptm1)

        v1 = pt - ptm1
        v2 = ptp1 - pt
        v1n = torch.sqrt(sum3(v1 * v1))
        v2n = torch.sqrt(sum3(v2 * v2))
        sharp = torch.abs(sum3(v1 * v2)) < self.max_cosine * v1n * v2n

        tiny_ring = ring_size <= 3
        larger = a_valid & (tiny_ring | (at_gap & nearer) | (~at_gap & sharp))
        other = a_valid & ~tiny_ring & at_gap & ~nearer
        smaller = a_valid & ~tiny_ring & ~at_gap & ~sharp

        out = dict(layers)
        for name, mask in ((self.output_layer_larger_curvature, larger),
                           (self.output_layer_smaller_curvature, smaller),
                           (self.output_layer_other, other)):
            if name:
                out[name] = compact(pc, mask_at(a_orig, mask, C))
        return out
