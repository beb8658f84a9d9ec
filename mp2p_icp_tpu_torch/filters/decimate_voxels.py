"""Voxel decimation filter.

Port of ``mp2p_icp_tpu/filters/decimate_voxels.py`` (reference:
FilterDecimateVoxels.cpp:107-381): methods FirstPoint / RandomPoint /
VoxelAverage / ClosestToAverage, several input layers merged, the
``flatten_to`` 2-D projection mode, the ``minimum_input_points_to_filter``
bypass.

``FIRST_POINT`` has two backends. ``sort`` is one stable sort of the voxel
key (``ops.voxel_unique``); its output rows are in voxel-key order (the
reference emits insertion order; point sets are order-free downstream).
``hash`` is a scratch voxel hash table (``ops.voxel_hash_map``); its
output keeps the winners' input order. The other methods reduce over the
voxel segments of the same sort (``voxel_segments``), with sums added in
sorted order so that a mean has one value on every device. On a batch of
clouds [B, C, 3] they run as B single calls, stacked: what ``jax.vmap`` of
the JAX filter gives, each cloud to the bit as its own call.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Optional, Tuple

import torch
import torch.utils._pytree as pytree

from mp2p_icp_tpu_torch.core.pointcloud import PointCloud, scatter_rows, take_rows
from mp2p_icp_tpu_torch.filters.base import FilterBase
from mp2p_icp_tpu_torch.ops.voxel_hash_map import hash_decimate_first_point
from mp2p_icp_tpu_torch.ops.voxel_unique import (
    first_point_select,
    segment_argmin,
    segment_sums_in_order,
    voxel_segments,
)
from mp2p_icp_tpu_torch.utils.profiler import spanned


class DecimateMethod(enum.Enum):
    FIRST_POINT = "FirstPoint"
    RANDOM_POINT = "RandomPoint"
    VOXEL_AVERAGE = "VoxelAverage"
    CLOSEST_TO_AVERAGE = "ClosestToAverage"

    @staticmethod
    def from_string(s: str) -> "DecimateMethod":
        s = s.split("::")[-1]
        for m in DecimateMethod:
            if m.value.lower() == s.lower():
                return m
        raise ValueError(f"Unknown decimate method: {s!r}")


@dataclasses.dataclass(frozen=True)
class FilterDecimateVoxels(FilterBase):
    """Params (reference: FilterDecimateVoxels.h)."""

    input_pointcloud_layer: Tuple[str, ...] = ("raw",)
    output_pointcloud_layer: str = "decimated"
    voxel_filter_resolution: float = 1.0
    decimate_method: DecimateMethod = DecimateMethod.FIRST_POINT
    flatten_to: Optional[float] = None  # z value for 2-D projection mode
    minimum_input_points_to_filter: int = 0
    output_capacity: Optional[int] = None  # default: input capacity
    # 'sort' = stable voxel sort (output in voxel-key order); 'hash' =
    # scratch hash table (output in input order, the reference's own
    # insertion order, FilterDecimateVoxels.cpp:244-270)
    backend: str = "sort"

    @spanned("filters.decimate")
    def __call__(self, layers: Dict[str, PointCloud], variables=None):
        if self.backend == "hash":
            return self._call_hash(layers)
        inputs = [layers[name] for name in self.input_pointcloud_layer]
        if self.decimate_method != DecimateMethod.FIRST_POINT and inputs[0].xyz.ndim == 3:
            return self._per_cloud(layers)
        # a batch of clouds [B, C, 3] decimates by FirstPoint as B problems at once
        xyz = torch.cat([pc.xyz for pc in inputs], dim=-2)
        valid = torch.cat([pc.valid_mask() for pc in inputs], dim=-1)

        if self.flatten_to is not None:
            flat = torch.cat(
                [xyz[..., :2], torch.full_like(xyz[..., :1], self.flatten_to)], dim=-1
            )
            xyz = torch.where(valid[..., None], flat, xyz)

        C = xyz.shape[-2]
        out_cap = self.output_capacity or C

        # per-map bypass (reference FilterDecimateVoxels.cpp:158-192): an
        # input map with size <= minimum is copied through verbatim and
        # excluded from the voxel filter; larger maps decimate as usual
        min_pts = self.minimum_input_points_to_filter
        bypass_pt = None
        valid_decim = valid
        if min_pts > 0:
            if len(inputs) * min_pts > out_cap:
                raise ValueError(
                    "minimum_input_points_to_filter bypass could overflow "
                    f"output_capacity: {len(inputs)} input layer(s) x "
                    f"minimum {min_pts} > output_capacity {out_cap} — the "
                    "reference copies every below-minimum map verbatim, so "
                    "size output_capacity accordingly"
                )
            bypass_pt = torch.cat(
                [(pc.count <= min_pts)[..., None].expand(pc.xyz.shape[:-1]) for pc in inputs],
                dim=-1,
            )
            valid_decim = valid & ~bypass_pt

        if self.decimate_method == DecimateMethod.FIRST_POINT:
            src, n = first_point_select(
                xyz, valid_decim, self.voxel_filter_resolution, out_cap,
                flatten_z=self.flatten_to is not None,
            )
            src = torch.clamp(src, 0, C - 1)
            return self._emit(layers, inputs, xyz, valid, src, n, out_cap, bypass_pt)
        segs = voxel_segments(xyz, valid_decim, self.voxel_filter_resolution,
                              flatten_z=self.flatten_to is not None)
        # rows of the voxel of rank j, for the first out_cap ranks
        ranks = torch.clamp(torch.arange(out_cap, device=xyz.device), max=C - 1)
        if self.decimate_method == DecimateMethod.RANDOM_POINT:
            # a fixed pseudo-random pick: the least uint32 hash of the row,
            # order * 2654435761 mod 2^32 mod 2^16, formed in int64
            h = ((segs.order * 2654435761) & 0xFFFF).to(torch.float32)
            src = segment_argmin(segs, h, C)[ranks]
            return self._emit(layers, inputs, xyz, valid, src, segs.n_voxels, out_cap,
                              bypass_pt)
        xyz_sorted = xyz[segs.order]
        w = segs.valid.to(torch.float32)
        sums = segment_sums_in_order(xyz_sorted * w[:, None], segs, C)
        cnts = segment_sums_in_order(w, segs, C)
        means = sums / torch.clamp(cnts, min=1.0)[:, None]
        if self.decimate_method == DecimateMethod.VOXEL_AVERAGE:
            return self._emit(layers, inputs, xyz, valid, None, segs.n_voxels, out_cap,
                              bypass_pt, out_xyz=means[ranks])
        d = xyz_sorted - means[segs.segment_id]
        d2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
        src = segment_argmin(segs, d2, C)[ranks]
        return self._emit(layers, inputs, xyz, valid, src, segs.n_voxels, out_cap, bypass_pt)

    def _per_cloud(self, layers):
        """A batch of clouds as B single calls, the outputs stacked."""
        B = layers[self.input_pointcloud_layer[0]].xyz.shape[0]
        outs = [self({name: pytree.tree_map(lambda x: x[b], layers[name])
                      for name in self.input_pointcloud_layer})[self.output_pointcloud_layer]
                for b in range(B)]
        new_layers = dict(layers)
        new_layers[self.output_pointcloud_layer] = pytree.tree_map(
            lambda *xs: torch.stack(xs), *outs)
        return new_layers

    def _emit(self, layers, inputs, xyz, valid, src, n, out_cap, bypass_pt, out_xyz=None):
        """Output assembly: the first min(n, out_cap) voxel representatives
        (``src``: their input rows, or ``out_xyz``: their coordinates, for
        the average, which has no source row), the channels of a
        representative that is a source point, then the bypassed maps."""
        out_valid = torch.arange(out_cap, device=xyz.device) < n[..., None]
        if out_xyz is None:
            out_xyz = take_rows(xyz, src)
        out = PointCloud(
            xyz=torch.where(out_valid[..., None], out_xyz, PointCloud.PAD_VALUE),
            count=torch.clamp(n, max=out_cap),
        )

        # channel passthrough (a winner is a concrete source point)
        if src is not None and len(inputs) == 1:
            def gather(ch):
                return None if ch is None else torch.where(out_valid, take_rows(ch, src), 0.0)

            pc0 = inputs[0]
            out = dataclasses.replace(
                out, intensity=gather(pc0.intensity), ring=gather(pc0.ring),
                time=gather(pc0.time),
            )

        # the bypassed maps' points follow the decimated block verbatim
        # (reference inserts them into the same output cloud,
        # FilterDecimateVoxels.cpp:168-186); channels ride along
        if bypass_pt is not None:
            byp = valid & bypass_pt
            rank = torch.cumsum(byp, dim=-1) - 1
            dest = torch.clamp(torch.where(byp, out.count[..., None] + rank, out_cap), 0, out_cap)
            n_byp = torch.sum(byp, dim=-1, dtype=torch.int32)

            def append_ch(out_ch, chs):
                if out_ch is None and all(c is None for c in chs):
                    return None
                o = out_ch if out_ch is not None else xyz.new_zeros(dest.shape[:-1] + (out_cap,))
                s = torch.cat([
                    c if c is not None else xyz.new_zeros(pc.xyz.shape[:-1])
                    for pc, c in zip(inputs, chs)
                ], dim=-1)
                return scatter_rows(o, dest, s)

            out = PointCloud(
                xyz=scatter_rows(out.xyz, dest, xyz),
                count=torch.clamp(out.count + n_byp, max=out_cap),
                intensity=append_ch(out.intensity, [pc.intensity for pc in inputs]),
                ring=append_ch(out.ring, [pc.ring for pc in inputs]),
                time=append_ch(out.time, [pc.time for pc in inputs]),
            )

        new_layers = dict(layers)
        new_layers[self.output_pointcloud_layer] = out
        return new_layers

    def _call_hash(self, layers: Dict[str, PointCloud]):
        if self.decimate_method != DecimateMethod.FIRST_POINT:
            raise ValueError(
                f"backend='hash' supports FIRST_POINT only (got {self.decimate_method})")
        if self.flatten_to is not None:
            raise ValueError("backend='hash' does not support flatten_to")
        if self.minimum_input_points_to_filter > 0:
            raise ValueError(
                "backend='hash' does not support minimum_input_points_to_filter"
            )
        inputs = [layers[name] for name in self.input_pointcloud_layer]
        if len(inputs) == 1:
            src = inputs[0]
            valid = src.valid_mask()
        else:
            # channels only ride the single-input case, as with 'sort'
            src = PointCloud(
                xyz=torch.cat([pc.xyz for pc in inputs], dim=-2),
                count=sum(pc.count for pc in inputs),
            )
            valid = torch.cat([pc.valid_mask() for pc in inputs], dim=-1)
        out_cap = self.output_capacity or src.capacity
        new_layers = dict(layers)
        new_layers[self.output_pointcloud_layer] = hash_decimate_first_point(
            src, self.voxel_filter_resolution, out_cap, valid=valid
        )
        return new_layers
