"""Build the port's objects from the JAX package's values.

The JAX package has no weights: its state is point layers and module
configs. These functions take them as numpy arrays and plain dicts (for a
module, ``dataclasses.asdict(module)`` and its class name), so they never
import jax, and both packages can be fed the same problem.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch
import torch.utils._pytree as pytree

from mp2p_icp_tpu_torch.core.metric_map import (
    Georeferencing,
    LineSet,
    MetricMap,
    PlaneSet,
    VoxelGridLayer,
)
from mp2p_icp_tpu_torch.core.params import Expression
from mp2p_icp_tpu_torch.core.pointcloud import PointCloud
from mp2p_icp_tpu_torch.core.se3 import Pose
from mp2p_icp_tpu_torch.device import resolve
from mp2p_icp_tpu_torch.filters.adjust_timestamps import FilterAdjustTimestamps
from mp2p_icp_tpu_torch.filters.bounding_box import FilterBoundingBox
from mp2p_icp_tpu_torch.filters.by_intensity import FilterByIntensity, FilterNormalizeIntensity
from mp2p_icp_tpu_torch.filters.by_range import FilterByRange
from mp2p_icp_tpu_torch.filters.by_ring import FilterByRing
from mp2p_icp_tpu_torch.filters.curvature import FilterCurvature
from mp2p_icp_tpu_torch.filters.decimate_variants import (
    FilterDecimateAdaptive,
    FilterDecimateVoxelsQuadratic,
)
from mp2p_icp_tpu_torch.filters.decimate_voxels import FilterDecimateVoxels
from mp2p_icp_tpu_torch.filters.delete_layer import FilterDeleteLayer
from mp2p_icp_tpu_torch.filters.deskew import FilterDeskew
from mp2p_icp_tpu_torch.filters.edge_generators import (
    GeneratorEdgesFromCurvature,
    GeneratorEdgesFromRangeImage,
)
from mp2p_icp_tpu_torch.filters.edges_planes import FilterEdgesPlanes
from mp2p_icp_tpu_torch.filters.estimate_normals import FilterEstimateNormals
from mp2p_icp_tpu_torch.filters.generator import Generator
from mp2p_icp_tpu_torch.filters.merge import FilterMerge
from mp2p_icp_tpu_torch.filters.pole_detector import FilterPoleDetector
from mp2p_icp_tpu_torch.filters.voxel_filters import (
    FilterRemoveByVoxelOccupancy,
    FilterVoxelSlice,
    GeneratorVoxelMap,
)
from mp2p_icp_tpu_torch.icp import ICP, ICPParameters
from mp2p_icp_tpu_torch.matchers import (
    LayerMatch,
    MatcherAdaptive,
    MatcherPoint2Line,
    MatcherPoint2Plane,
    MatcherPointsDistanceThreshold,
    MatcherPointsInlierRatio,
)
from mp2p_icp_tpu_torch.ops.voxel_hash import HashGrid
from mp2p_icp_tpu_torch.ops.voxel_hash_map import VoxelHashMapState
from mp2p_icp_tpu_torch.parallel.pose_graph import PoseGraphEdges
from mp2p_icp_tpu_torch.quality.paired_ratio import QualityPairedRatio
from mp2p_icp_tpu_torch.quality.range_image import QualityRangeImageSimilarity
from mp2p_icp_tpu_torch.quality.voxels import QualityVoxels
from mp2p_icp_tpu_torch.solvers.common import PairWeights, WeightParameters
from mp2p_icp_tpu_torch.solvers.gauss_newton import GNParams
from mp2p_icp_tpu_torch.solvers.robust import RobustKernel
from mp2p_icp_tpu_torch.solvers.solver import SolverGaussNewton, SolverHorn, SolverOLAE

# JAX-side fields with no counterpart in the port: the matchers' hash-grid
# candidate budget (no matcher takes the grid path; ops.nn.nn_search has it
# as an argument)
_DROPPED_FIELDS = {"k_per_cell"}
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


def voxel_grid_from_jax(vg, device=None) -> VoxelGridLayer:
    """The port's copy of a JAX package VoxelGridLayer (read through numpy)."""
    device = resolve(device)
    return VoxelGridLayer(
        keys=torch.from_numpy(np.array(vg.keys, dtype=np.int32)).to(device),
        occupancy=torch.from_numpy(np.array(vg.occupancy, dtype=np.float32)).to(device),
        valid=torch.from_numpy(np.array(vg.valid, dtype=bool)).to(device),
        resolution=float(vg.resolution),
    )


def layer_from_jax(layer, device=None):
    """A point layer or a voxel layer of the JAX package, by its fields."""
    if hasattr(layer, "occupancy"):
        return voxel_grid_from_jax(layer, device=device)
    return pointcloud_from_jax(layer, device=device)


def metric_map_from_jax(mm, device=None) -> MetricMap:
    """The port's copy of a JAX package MetricMap: its layers, lines,
    planes, id, label and georeferencing."""
    device = resolve(device)

    def t(x, dtype=np.float32):
        return torch.from_numpy(np.array(x, dtype=dtype)).to(device)

    geo = mm.georeferencing
    return MetricMap(
        layers={k: layer_from_jax(v, device=device) for k, v in mm.layers.items()},
        lines=LineSet(point=t(mm.lines.point), direction=t(mm.lines.direction),
                      count=t(mm.lines.count, np.int32)),
        planes=PlaneSet(normal=t(mm.planes.normal), centroid=t(mm.planes.centroid),
                        count=t(mm.planes.count, np.int32)),
        id=mm.id,
        label=mm.label,
        georeferencing=None if geo is None else Georeferencing(**dataclasses.asdict(geo)),
    )


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


def hash_grid_from_jax(grid, device=None) -> HashGrid:
    """The port's copy of a JAX package HashGrid (ops/voxel_hash.py),
    read through numpy, field for field."""
    device = resolve(device)

    def t(x):
        return torch.from_numpy(np.array(x)).to(device)

    return HashGrid(points_sorted=t(grid.points_sorted), order=t(grid.order),
                    valid_sorted=t(grid.valid_sorted), bucket_start=t(grid.bucket_start),
                    bucket_count=t(grid.bucket_count), cell_size=float(grid.cell_size))


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


def sharded_layers_from_jax(g_sharded: dict, device=None) -> dict:
    """The port's copy of ``parallel.spatial.shard_global_layers``' output
    in the JAX package: {name: stacked [n, C/n] cloud} (read through
    numpy)."""
    return {name: pointcloud_from_jax(pc, device) for name, pc in g_sharded.items()}


def pose_graph_edges_from_numpy(i, j, z_R, z_t, information, valid=None,
                                device=None) -> PoseGraphEdges:
    """PoseGraphEdges from numpy arrays: nodes [E], measured poses R [E, 3,
    3] and t [E, 3], information [E, 6, 6], validity [E] (all valid when
    None)."""
    device = resolve(device)

    def t(a, dtype):
        return torch.from_numpy(np.array(a, dtype=dtype)).to(device)

    valid = np.ones(len(i), bool) if valid is None else valid
    return PoseGraphEdges(i=t(i, np.int64), j=t(j, np.int64),
                          z=Pose(t(z_R, np.float32), t(z_t, np.float32)),
                          information=t(information, np.float32), valid=t(valid, np.bool_))


def pose_graph_edges_from_jax(edges, device=None) -> PoseGraphEdges:
    """The port's copy of a JAX package PoseGraphEdges (read through numpy)."""
    return pose_graph_edges_from_numpy(
        np.asarray(edges.i), np.asarray(edges.j), np.asarray(edges.z.R), np.asarray(edges.z.t),
        np.asarray(edges.information), np.asarray(edges.valid), device=device)


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


def expressions_from_jax(cfg: dict) -> dict:
    """``cfg`` with every JAX package Expression replaced by the port's
    Expression of the same text (nested dicts too)."""
    def one(v):
        if type(v).__name__ == "Expression" and hasattr(v, "text"):
            return Expression(v.text)
        return expressions_from_jax(v) if isinstance(v, dict) else v

    return {k: one(v) for k, v in cfg.items()}


def _module_fields(cfg: dict, mesh=None) -> dict:
    cfg = expressions_from_jax(cfg)
    if isinstance(cfg.get("spatial_axis"), str):
        # the JAX package names a mesh axis; the port holds this rank's axis
        if mesh is None:
            raise ValueError(f"spatial_axis={cfg['spatial_axis']!r}: pass the mesh whose "
                             "axis it names")
        cfg["spatial_axis"] = mesh.axis(cfg["spatial_axis"])
    if "spatial_num_shards" in cfg:
        # the port reads the shard count from the axis itself
        n = cfg.pop("spatial_num_shards")
        axis = cfg.get("spatial_axis")
        if axis is not None and n != axis.size:
            raise ValueError(f"spatial_num_shards={n} but the mesh axis "
                             f"{axis.name!r} has {axis.size} ranks")
    for k in _DROPPED_FIELDS:
        cfg.pop(k, None)
    if "layer_matches" in cfg:
        cfg["layer_matches"] = tuple(LayerMatch(**lm) for lm in cfg["layer_matches"])
    return cfg


def matcher_from_config(name: str, cfg: dict, mesh=None):
    """A port matcher from a JAX matcher's class name and asdict; a
    ``spatial_axis`` name becomes that axis of ``mesh``
    (``parallel.mesh.make_mesh``)."""
    cfg = _module_fields(cfg, mesh)
    if name == "MatcherPointsDistanceThreshold":
        return MatcherPointsDistanceThreshold(**cfg)
    if name == "MatcherAdaptive":
        return MatcherAdaptive(**cfg)
    if name == "MatcherPoint2Plane":
        return MatcherPoint2Plane(**cfg)
    if name == "MatcherPoint2Line":
        return MatcherPoint2Line(**cfg)
    if name == "MatcherPointsInlierRatio":
        return MatcherPointsInlierRatio(**cfg)
    raise NotImplementedError(f"matcher {name} is not ported yet")


def _weight_params(wp: dict) -> WeightParameters:
    wp = dict(wp)
    wp["pair_weights"] = PairWeights(**wp["pair_weights"])
    wp["robust_kernel"] = _kernel(wp["robust_kernel"])
    return WeightParameters(**wp)


def solver_from_config(name: str, cfg: dict):
    """A port solver from a JAX solver's class name and asdict."""
    cfg = expressions_from_jax(cfg)
    if name in ("SolverHorn", "SolverOLAE"):
        cls = SolverHorn if name == "SolverHorn" else SolverOLAE
        return cls(weight_params=_weight_params(cfg.pop("weight_params")), **cfg)
    if name == "SolverGaussNewton":
        gp = dict(cfg.pop("gn_params"))
        gp["pair_weights"] = PairWeights(**gp["pair_weights"])
        gp["kernel"] = _kernel(gp["kernel"])
        return SolverGaussNewton(gn_params=GNParams(**gp), **cfg)
    raise NotImplementedError(f"solver {name} is not ported yet")


def quality_from_config(name: str, cfg: dict):
    """A port quality evaluator from a JAX evaluator's class name and asdict."""
    cfg = dict(cfg)
    if name == "QualityVoxels":
        return QualityVoxels(**cfg)
    if name == "QualityRangeImageSimilarity":
        return QualityRangeImageSimilarity(**cfg)
    if name != "QualityPairedRatio":
        raise NotImplementedError(f"quality evaluator {name} is not ported yet")
    if cfg.get("matcher") is not None:
        cfg["matcher"] = matcher_from_config(
            "MatcherPointsDistanceThreshold", cfg["matcher"]
        )
    return QualityPairedRatio(**cfg)


# the filters of the port by class name, and their enum fields
_FILTERS = {cls.__name__: cls for cls in (
    FilterAdjustTimestamps, FilterBoundingBox, FilterByIntensity, FilterByRange, FilterByRing,
    FilterCurvature, FilterDecimateAdaptive, FilterDecimateVoxels, FilterDecimateVoxelsQuadratic,
    FilterDeleteLayer, FilterDeskew, FilterEdgesPlanes, FilterEstimateNormals, FilterMerge,
    FilterNormalizeIntensity, FilterPoleDetector, FilterRemoveByVoxelOccupancy, FilterVoxelSlice,
    Generator, GeneratorEdgesFromCurvature, GeneratorEdgesFromRangeImage, GeneratorVoxelMap)}


def filter_from_config(name: str, cfg: dict):
    """A port filter (or Generator) from a filter's class name and its
    fields, e.g. ``dataclasses.asdict`` of the JAX package's: enum members
    by their value (or name string), lists as tuples."""
    if name not in _FILTERS:
        raise ValueError(f"unknown filter class {name}")
    cls = _FILTERS[name]
    out = {}
    for k, v in cfg.items():
        default = cls.__dataclass_fields__[k].default
        if isinstance(default, enum.Enum):  # a member of the JAX enum, its value or its name
            v = next((m for m in type(default) if m.value == getattr(v, "value", v)), None) \
                or type(default).from_string(v)
        out[k] = tuple(v) if isinstance(v, list) else v
    return cls(**out)


def params_from_config(cfg: dict) -> ICPParameters:
    """The port's ICPParameters from ``dataclasses.asdict`` of the JAX
    package's (the hook and the functors are passed on as they are)."""
    cfg = dict(cfg)
    cfg["quality_checkpoints"] = tuple(tuple(c) for c in cfg["quality_checkpoints"])
    return ICPParameters(**cfg)


def icp_from_config(matchers, solvers, quality_evaluators=None,
                    quality_weights=None, mesh=None) -> ICP:
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
        matchers=[matcher_from_config(n, c, mesh) for n, c in matchers],
        solvers=[solver_from_config(n, c) for n, c in solvers],
        **kw,
    )


def config_of(module) -> tuple:
    """(class name, asdict) of a dataclass module — the input format above."""
    return type(module).__name__, dataclasses.asdict(module)
