"""Matcher base machinery.

Port of ``mp2p_icp_tpu/matchers/base.py``. A matcher is a frozen config
object whose ``match()`` maps (global layers, local layers, pose, state,
context) to fixed-capacity pairing blocks. The ICP loop runs on the host,
so ``gate`` is a plain 0/1 float and the loop simply skips a matcher whose
window does not cover the iteration.

A map comes as a ``{name: layer}`` dict or as a ``MetricMap``. Not
ported: ``GridCache`` / ``HashGrid`` (every production call of the JAX
package passes an empty grid cache).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from mp2p_icp_tpu_torch.core import se3
from mp2p_icp_tpu_torch.core.metric_map import MetricMap
from mp2p_icp_tpu_torch.core.params import Expression, iteration_env
from mp2p_icp_tpu_torch.core.pointcloud import PointCloud
from mp2p_icp_tpu_torch.core.se3 import Pose


@dataclasses.dataclass(frozen=True)
class LayerMatch:
    """One entry of the ``pointLayerMatches`` weight table."""

    global_layer: str = "raw"
    local_layer: str = "raw"
    weight: float = 1.0


def point_layers(m) -> Dict[str, PointCloud]:
    """The layers of a map, as the JAX package hands them on: a
    ``MetricMap`` gives its point layers, a dict is returned as it is (voxel
    layers included, for the quality evaluators that read them)."""
    if isinstance(m, MetricMap):
        return {k: v for k, v in m.layers.items() if isinstance(v, PointCloud)}
    return m


def static_value(value, name: str, iteration=0):
    """A module parameter at ICP iteration ``iteration``: a number as a
    float; an ``Expression`` evaluated as the JAX package evaluates it on
    its traced float32 iteration (core/params.py), rounded to float32. A
    host iteration gives a float; a tensor iteration (per problem under
    ``torch.func.vmap``) gives a float32 tensor."""
    if isinstance(value, Expression):
        out = value(iteration_env(iteration))
        if isinstance(iteration, torch.Tensor):
            return torch.as_tensor(out, dtype=torch.float32, device=iteration.device)
        return float(torch.as_tensor(out, dtype=torch.float32))
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        return float(value)
    raise TypeError(f"{name}={value!r}: a number or an Expression is expected")


class MatchState(NamedTuple):
    """Per-layer boolean "already paired" masks (the reference's paired
    bitfields)."""

    local_paired: Dict[str, torch.Tensor]
    global_paired: Dict[str, torch.Tensor]

    @staticmethod
    def create(local_map, global_map, global_scale: int = 1) -> "MatchState":
        """global_scale > 1: the global layers are one rank's shards of a
        map split over that many ranks, and the global masks span the
        global ids of all shards (shard · capacity + local); built from the
        merged kNN results, they are the same on every rank."""
        return MatchState(
            local_paired={
                name: torch.zeros(layer.capacity, dtype=torch.bool,
                                  device=layer.device)
                for name, layer in point_layers(local_map).items()
            },
            global_paired={
                name: torch.zeros(layer.capacity * global_scale, dtype=torch.bool,
                                  device=layer.device)
                for name, layer in point_layers(global_map).items()
            },
        )


class MatchContext(NamedTuple):
    """The reference's MatchContext{icpIteration}: a host int in the ICP
    loop; a per-problem int32 tensor for the batched final quality."""

    icp_iteration: object
    # per global layer, the [crop_capacity] i32 table from a cropped row to
    # the row of the user's map (-1 for padding), set when ICP cropped the
    # layer (ICP._crop_globals): matchers record global_idx through it, so
    # results address the user's map; claim masks keep the cropped ids
    global_index_maps: Optional[dict] = None


def spatial_scale(m) -> int:
    """The shards a matcher's global ids span: the size of its
    ``spatial_axis`` (the map split over ranks), else 1."""
    axis = getattr(m, "spatial_axis", None)
    return 1 if axis is None else axis.size


def neighbour_xyz(res, layer: PointCloud) -> torch.Tensor:
    """The coordinates [..., k, 3] of a kNN result's neighbours: carried by
    the result on a sharded map (``ShardedNNResult.xyz``), else gathered
    from the layer."""
    if hasattr(res, "xyz"):
        return res.xyz
    return layer.xyz[torch.clamp(res.idx, 0, layer.capacity - 1).long()]


def recorded_global_idx(ctx: MatchContext, layer: str, gidx: torch.Tensor) -> torch.Tensor:
    """``gidx`` (ids into the layer the matcher swept) as ids into the
    user's map: through the crop's index map when the layer was cropped."""
    gm = (ctx.global_index_maps or {}).get(layer)
    if gm is None:
        return gidx
    return gm[torch.clamp(gidx, 0, gm.shape[-1] - 1).long()]


@dataclasses.dataclass(frozen=True)
class Matcher:
    """Common gating params (reference: Matcher.h:90-112)."""

    enabled: bool = True
    run_from_iteration: int = 0
    run_up_to_iteration: int = 0  # 0 = no upper bound

    def gate(self, iteration):
        """1.0 when this matcher runs at ``iteration``, else 0.0: a float
        for a host iteration, a float32 tensor for a tensor one."""
        if isinstance(iteration, torch.Tensor):
            on = (iteration >= self.run_from_iteration) & self.enabled
            if self.run_up_to_iteration > 0:
                on = on & (iteration <= self.run_up_to_iteration)
            return on.to(torch.float32)
        on = self.enabled and iteration >= self.run_from_iteration
        if self.run_up_to_iteration > 0:
            on = on and iteration <= self.run_up_to_iteration
        return 1.0 if on else 0.0

    # subclasses implement:
    # def match(self, global_map, local_map, pose, state, ctx)
    #     -> (pairing blocks, new MatchState, potential_pairings)
    # def out_blocks(self, local_map) -> {block name: capacity}

    def out_capacity(self, local_map) -> int:
        """Rows of the matcher's first pairing block (Adaptive: pt2pt)."""
        return next(iter(self.out_blocks(local_map).values()))


def subsample_mask(
    valid: torch.Tensor, count: torch.Tensor, max_points: int
) -> torch.Tensor:
    """Deterministic even-stride subsampling of valid points down to
    ``max_points`` (0 = keep all)."""
    if max_points <= 0:
        return valid
    C = valid.shape[0]
    idx = torch.arange(C, dtype=torch.float32, device=valid.device)
    stride = torch.clamp(count.to(torch.float32) / float(max_points), min=1.0)
    keep = torch.floor(idx / stride) != torch.floor((idx - 1) / stride)
    keep[0] = True
    return valid & keep


def transformed_local(local: PointCloud, pose: Pose) -> Tuple[torch.Tensor, torch.Tensor]:
    """Local points mapped into the global frame + validity. Padding rows
    transform to huge coordinates and are masked by ``valid`` downstream."""
    return se3.apply(pose, local.xyz), local.valid_mask()


def claim(mask: torch.Tensor, gidx: torch.Tensor, won: torch.Tensor) -> torch.Tensor:
    """``mask`` with the global ids of the rows in ``won`` set. Losing rows
    write to a dump slot past the end, which is cut off (out of place, so
    it runs under torch.func.vmap)."""
    g_cap = mask.shape[-1]
    slots = torch.where(won, torch.clamp(gidx, 0, g_cap - 1), g_cap).long()
    claimed = torch.zeros(g_cap + 1, dtype=torch.bool, device=mask.device).index_put(
        (slots,), torch.ones_like(won))
    return mask | claimed[:g_cap]
