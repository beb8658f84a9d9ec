"""The global map split over the ranks of the ``space`` axis.

Port of ``mp2p_icp_tpu/parallel/spatial.py``. Each rank holds one
contiguous shard of every global layer and sweeps only that shard (K1, or
K3 above 131072 rows); the per-query k-lists are merged after one
all_gather (``ops/nn_bruteforce.knn_sharded``). ``make_spatial_align``
aligns one problem; ``parallel.batch.make_batched_align(..., space=)``
aligns a batch split over the ``data`` axis with every problem's map split
over ``space`` (each rank passes ``own_shard`` of the maps). Everything after the
matchers (solvers, termination, quality) runs on every rank on the same
merged pairings, so every rank takes the same decisions and ends with the
same result: the ICP loop is the unsharded one.

A shard above ``crop_capacity`` is first cropped by its rank to the box
around the scan at the guess (``ICP._crop_globals``); global ids then
address the cropped shards, the same on every rank. Where a shard's crop
overflows (more points in the box than ``crop_capacity``), its even stride
can keep another candidate set than the crop of the whole map: size
``crop_capacity`` so that the in-box points fit where equality matters.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.utils._pytree as pytree

from mp2p_icp_tpu_torch.core.pointcloud import PointCloud
from mp2p_icp_tpu_torch.icp import ICP, ICPParameters


def shard_global_layers(g_layers: Dict[str, PointCloud], n_shards: int) -> Dict[str, PointCloud]:
    """Each layer split into n stacked shards of ceil(C / n) rows with
    their own counts: xyz [n, C/n, 3], count [n] (padding rows appended to
    the last shards). Shard s holds rows [s·C/n, (s+1)·C/n) of the layer,
    so a global id s·(C/n) + local is the layer's own row."""
    out = {}
    for name, pc in g_layers.items():
        C = pc.capacity
        Cs = -(-C // n_shards)
        pad = n_shards * Cs - C
        counts = torch.clamp(pc.count.to(torch.int64)
                             - Cs * torch.arange(n_shards, device=pc.device), 0, Cs)

        def split(ch, fill):
            if ch is None:
                return None
            if pad:
                ch = torch.cat([ch, ch.new_full((pad,) + ch.shape[1:], fill)])
            return ch.reshape((n_shards, Cs) + ch.shape[1:])

        out[name] = PointCloud(
            xyz=split(pc.xyz, PointCloud.PAD_VALUE),
            count=counts.to(torch.int32),
            intensity=split(pc.intensity, 0.0),
            ring=split(pc.ring, 0.0),
            time=split(pc.time, 0.0),
            normals=split(pc.normals, 0.0),
        )
    return out


def own_shard(g_layers: Dict[str, PointCloud], axis, batched: bool = False):
    """This rank's shard of every layer split over ``axis``
    (``shard_global_layers`` at ``axis.rank``): [ceil(C / n), 3] of one map,
    or, ``batched``, [B, ceil(C / n), 3] of a batch of maps, each problem's
    own shard."""
    if batched:
        B = next(iter(g_layers.values())).xyz.shape[0]
        parts = [own_shard(pytree.tree_map(lambda x: x[b], dict(g_layers)), axis)
                 for b in range(B)]
        return pytree.tree_map(lambda *xs: torch.stack(xs), *parts)
    return pytree.tree_map(lambda x: x[axis.rank], shard_global_layers(g_layers, axis.size))


def spatial_matchers(matchers, axis):
    """The matchers with ``spatial_axis`` set to ``axis``; a matcher
    without the field raises."""
    adj = []
    for m in matchers:
        if not hasattr(m, "spatial_axis"):
            raise NotImplementedError(f"{type(m).__name__} has no spatial_axis support")
        adj.append(dataclasses.replace(m, spatial_axis=axis))
    return adj


def spatial_icp(icp: ICP, axis) -> ICP:
    """``icp`` on a global map split over ``axis``: its matchers and the own
    matcher of each quality evaluator that has one take ``spatial_axis``."""
    evaluators = [
        dataclasses.replace(ev, matcher=spatial_matchers([ev.matcher], axis)[0])
        if getattr(ev, "matcher", None) is not None else ev
        for ev in icp.quality_evaluators
    ]
    return dataclasses.replace(icp, matchers=spatial_matchers(icp.matchers, axis),
                               quality_evaluators=evaluators)


def make_spatial_align(icp: ICP, params: ICPParameters, mesh, axis: str = "space"):
    """Returns ``fn(l_layers, g_sharded, guess) -> ICPResults``, to be
    called by every rank of the ``axis`` group with the same arguments:
    ``g_sharded`` is ``shard_global_layers(g, mesh.shape[axis])`` (each
    rank keeps its own shard of it). The result is the same on every rank.
    Matchers: DistanceThreshold, Adaptive, InlierRatio, Point2Plane;
    several may share an iteration (the paired masks span the global ids
    of all shards)."""
    ax = mesh.axis(axis)
    sharded_icp = spatial_icp(icp, ax)

    def fn(l_layers, g_sharded, guess):
        g_local = pytree.tree_map(lambda x: x[ax.rank], dict(g_sharded))
        # the crop's index maps are dropped: sharded pairings record the
        # global ids of the cropped shards
        g_local, _ = sharded_icp._crop_globals(params, g_local, l_layers, guess)
        return sharded_icp._align_core(params, g_local, l_layers, guess, None)

    return fn
