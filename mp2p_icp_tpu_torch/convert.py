"""Build the port's objects from the JAX package's values.

The JAX package has no weights: its state is point layers and module
configs. These functions take them as numpy arrays and plain dicts (for a
module, ``dataclasses.asdict(module)`` and its class name), so they never
import jax, and both packages can be fed the same problem.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.utils._pytree as pytree

from mp2p_icp_tpu_torch.core.pointcloud import PointCloud
from mp2p_icp_tpu_torch.core.se3 import Pose
from mp2p_icp_tpu_torch.device import resolve
from mp2p_icp_tpu_torch.icp import ICP
from mp2p_icp_tpu_torch.matchers import (
    LayerMatch,
    MatcherAdaptive,
    MatcherPoint2Plane,
    MatcherPointsDistanceThreshold,
)
from mp2p_icp_tpu_torch.ops.voxel_hash_map import VoxelHashMapState
from mp2p_icp_tpu_torch.quality.paired_ratio import QualityPairedRatio
from mp2p_icp_tpu_torch.solvers.common import PairWeights, WeightParameters
from mp2p_icp_tpu_torch.solvers.gauss_newton import GNParams
from mp2p_icp_tpu_torch.solvers.robust import RobustKernel
from mp2p_icp_tpu_torch.solvers.solver import SolverGaussNewton, SolverHorn

# JAX-side fields with no counterpart in the port: the hash-grid candidate
# budget (the grid path is not ported) and the shard count (read only when
# spatial_axis is set, which raises)
_DROPPED_FIELDS = {"k_per_cell", "spatial_num_shards"}
_CHANNELS = ("intensity", "ring", "time", "normals")


def pointcloud_from_numpy(xyz, count, device=None, **channels) -> PointCloud:
    """A PointCloud from a padded [C, 3] array and its valid count, with the
    padding rows kept as given (row-for-row with the JAX cloud). A stacked
    batch ([B, C, 3] with counts [B]) gives a batched cloud."""
    device = resolve(device)
    xyz = np.array(xyz, dtype=np.float32)
    if xyz.ndim not in (2, 3) or xyz.shape[-1] != 3:
        raise ValueError(f"xyz must be [C, 3] or [B, C, 3], got {xyz.shape}")
    extra = {
        k: torch.from_numpy(np.array(v, dtype=np.float32)).to(device)
        for k, v in channels.items() if v is not None
    }
    return PointCloud(
        xyz=torch.from_numpy(xyz).to(device),
        count=torch.from_numpy(np.array(count, dtype=np.int32)).to(device),
        **extra,
    )


def pointcloud_from_jax(pc, device=None) -> PointCloud:
    """The port's copy of a JAX package PointCloud, stacked or not (read
    through numpy: any object with the same fields will do)."""
    channels = {k: None if getattr(pc, k) is None else np.asarray(getattr(pc, k))
                for k in _CHANNELS}
    return pointcloud_from_numpy(np.asarray(pc.xyz), np.asarray(pc.count),
                                 device=device, **channels)


def pointcloud_to_numpy(pc: PointCloud) -> dict:
    """{field: numpy array} of a cloud, stacked or not, without its empty
    channels: ``PointCloud(**{k: jnp.asarray(v) ...})`` rebuilds it in the
    JAX package."""
    return {f.name: _np(getattr(pc, f.name)) for f in dataclasses.fields(pc)
            if getattr(pc, f.name) is not None}


def voxel_hash_map_from_jax(state, device=None) -> VoxelHashMapState:
    """The port's copy of a JAX package VoxelHashMapState (point buffer with
    its channels, both key tables, the drop counter), read through numpy."""
    device = resolve(device)

    def i32(x):
        return torch.from_numpy(np.array(x, dtype=np.int32)).to(device)

    return VoxelHashMapState(
        pc=pointcloud_from_jax(state.pc, device=device),
        table_k1=i32(state.table_k1), table_k2=i32(state.table_k2),
        n_dropped=i32(state.n_dropped),
    )


def stacked_voxel_hash_maps_from_jax(states, device=None) -> VoxelHashMapState:
    """The port's stacked state (a leading B on every tensor) of a list of
    B JAX package VoxelHashMapStates of one shape, or of one state that the
    JAX package already stacked: a fleet step can then start from the same
    state in both packages."""
    if not hasattr(states, "table_k1"):  # a list of states (a state is a tuple itself)
        return pytree.tree_map(lambda *xs: torch.stack(xs),
                               *[voxel_hash_map_from_jax(s, device=device) for s in states])
    return voxel_hash_map_from_jax(states, device=device)


def unstack(tree) -> list:
    """The B members of a stacked pytree of the port (a map state, a
    PointCloud, a Pose), each ready for ``voxel_hash_map_to_numpy`` /
    ``pointcloud_to_numpy``."""
    B = pytree.tree_leaves(tree)[0].shape[0]
    return [pytree.tree_map(lambda x: x[b], tree) for b in range(B)]


def voxel_hash_map_to_numpy(state: VoxelHashMapState) -> dict:
    """{"pc": {field: array}, "table_k1", "table_k2", "n_dropped"} of a
    state: the JAX package rebuilds it as ``VoxelHashMapState(pc=PointCloud(
    **{k: jnp.asarray(v) ...}), table_k1=jnp.asarray(...), ...)``."""
    return {"pc": pointcloud_to_numpy(state.pc), "table_k1": _np(state.table_k1),
            "table_k2": _np(state.table_k2), "n_dropped": _np(state.n_dropped)}


def results_to_numpy(res) -> dict:
    """The comparable fields of either package's ICPResults, stacked or
    not, as numpy arrays: R, t, n_iterations, termination_reason, quality,
    covariance, and the final pt2pt block's weight and global_idx."""
    return {
        "R": _np(res.optimal_tf.R), "t": _np(res.optimal_tf.t),
        "n_iterations": _np(res.n_iterations).astype(np.int32),
        "termination_reason": _np(res.termination_reason).astype(np.int32),
        "quality": _np(res.quality), "covariance": _np(res.covariance),
        "pt2pt_weight": _np(res.final_pairings.pt2pt.weight),
        "pt2pt_global_idx": _np(res.final_pairings.pt2pt.global_idx),
    }


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def pose_from_numpy(R, t, device=None) -> Pose:
    device = resolve(device)
    return Pose(
        torch.from_numpy(np.array(R, dtype=np.float32)).to(device),
        torch.from_numpy(np.array(t, dtype=np.float32)).to(device),
    )


def _kernel(v) -> RobustKernel:
    """A robust kernel from the JAX package's enum member (by its value) or
    from a name."""
    v = getattr(v, "value", v)
    try:
        return RobustKernel(v)
    except ValueError:
        return RobustKernel.from_string(v)


def _module_fields(cfg: dict) -> dict:
    cfg = dict(cfg)
    if cfg.pop("spatial_axis", None) is not None:
        raise NotImplementedError("spatially sharded matchers are not ported yet")
    for k in _DROPPED_FIELDS:
        cfg.pop(k, None)
    if "layer_matches" in cfg:
        cfg["layer_matches"] = tuple(LayerMatch(**lm) for lm in cfg["layer_matches"])
    return cfg


def matcher_from_config(name: str, cfg: dict):
    """A port matcher from a JAX matcher's class name and asdict."""
    cfg = _module_fields(cfg)
    if name == "MatcherPointsDistanceThreshold":
        return MatcherPointsDistanceThreshold(**cfg)
    if name == "MatcherAdaptive":
        return MatcherAdaptive(**cfg)
    if name == "MatcherPoint2Plane":
        return MatcherPoint2Plane(**cfg)
    raise NotImplementedError(f"matcher {name} is not ported yet")


def solver_from_config(name: str, cfg: dict):
    """A port solver from a JAX solver's class name and asdict."""
    cfg = dict(cfg)
    if name == "SolverHorn":
        wp = dict(cfg.pop("weight_params"))
        wp["pair_weights"] = PairWeights(**wp["pair_weights"])
        wp["robust_kernel"] = _kernel(wp["robust_kernel"])
        return SolverHorn(weight_params=WeightParameters(**wp), **cfg)
    if name == "SolverGaussNewton":
        gp = dict(cfg.pop("gn_params"))
        gp["pair_weights"] = PairWeights(**gp["pair_weights"])
        gp["kernel"] = _kernel(gp["kernel"])
        return SolverGaussNewton(gn_params=GNParams(**gp), **cfg)
    raise NotImplementedError(f"solver {name} is not ported yet")


def quality_from_config(name: str, cfg: dict):
    """A port quality evaluator from a JAX evaluator's class name and asdict."""
    if name != "QualityPairedRatio":
        raise NotImplementedError(f"quality evaluator {name} is not ported yet")
    cfg = dict(cfg)
    if cfg.get("matcher") is not None:
        cfg["matcher"] = matcher_from_config(
            "MatcherPointsDistanceThreshold", cfg["matcher"]
        )
    return QualityPairedRatio(**cfg)


def icp_from_config(matchers, solvers, quality_evaluators=None,
                    quality_weights=None) -> ICP:
    """An ICP from ``[(class name, dataclasses.asdict(module)), ...]`` lists
    of the JAX package's modules. Without ``quality_evaluators`` the ICP
    keeps its default (one paired-ratio evaluator)."""
    kw = {}
    if quality_evaluators is not None:
        kw["quality_evaluators"] = tuple(
            quality_from_config(n, c) for n, c in quality_evaluators
        )
    if quality_weights is not None:
        kw["quality_weights"] = list(quality_weights)
    return ICP(
        matchers=[matcher_from_config(n, c) for n, c in matchers],
        solvers=[solver_from_config(n, c) for n, c in solvers],
        **kw,
    )


def config_of(module) -> tuple:
    """(class name, asdict) of a dataclass module — the input format above."""
    return type(module).__name__, dataclasses.asdict(module)
