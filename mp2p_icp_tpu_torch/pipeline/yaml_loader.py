"""YAML pipeline configuration in the reference's schema.

Port of ``mp2p_icp_tpu/pipeline/yaml_loader.py`` (reference:
icp_pipeline_from_yaml.cpp:26-77 and FilterBase.cpp:51): the YAML files of
the reference's ``icp-run`` and ``sm2mm`` (class names such as
``mp2p_icp::Solver_GaussNewton``, camelCase parameters) build the port's
modules. Each registry entry maps a YAML class's parameters to the port
module's fields, and ``convert.*_from_config`` builds the module from
those fields: the one place that turns field dicts into the port's
classes, which also builds them from the JAX package's configs.

Numeric parameters may be ``$f{...}`` expressions (``core.params``): a
constant one is folded at load time, one over ``ICP_ITERATION`` stays an
Expression where the module takes one.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import yaml as _yaml

from mp2p_icp_tpu_torch.convert import (
    filter_from_config,
    matcher_from_config,
    quality_from_config,
    solver_from_config,
)
from mp2p_icp_tpu_torch.core.params import Expression, resolve_value
from mp2p_icp_tpu_torch.icp import ICP, ICPParameters
from mp2p_icp_tpu_torch.quality.paired_ratio import QualityPairedRatio


def _short(name: str) -> str:
    return name.split("::")[-1]


def _num(v, variables=None):
    return resolve_value(v, variables)


def _dynamic_num(v):
    """A parameter that may be an expression over run-time variables
    (ICP_ITERATION): folded when constant, an Expression otherwise."""
    if isinstance(v, str):
        expr = Expression(v)
        return expr if expr.variables else float(expr({}))
    return float(v)


def _layer_matches(p: dict) -> list:
    entries = p.get("pointLayerMatches")
    if not entries:
        return [{"global_layer": "raw", "local_layer": "raw", "weight": 1.0}]
    return [{"global_layer": e.get("global", "raw"), "local_layer": e.get("local", "raw"),
             "weight": float(e.get("weight", 1.0))} for e in entries]


def _gating(p: dict) -> dict:
    return dict(
        enabled=bool(p.get("enabled", True)),
        run_from_iteration=int(_num(p.get("runFromIteration", 0))),
        run_up_to_iteration=int(_num(p.get("runUpToIteration", 0))),
    )


# ---------------------------------------------------------------- matchers
def _distance_threshold_fields(p: dict) -> dict:
    return dict(
        threshold=_dynamic_num(p.get("threshold", 0.50)),
        threshold_angular_deg=float(_num(p.get("thresholdAngularDeg", 0.0))),
        pairings_per_point=int(_num(p.get("pairingsPerPoint", 1))),
        max_local_points_per_layer=int(_num(p.get("maxLocalPointsPerLayer", 0))),
        allow_match_already_matched_global_points=bool(
            p.get("allowMatchAlreadyMatchedGlobalPoints", False)),
        allow_match_already_matched_points=bool(p.get("allowMatchAlreadyMatchedPoints", False)),
        layer_matches=_layer_matches(p), **_gating(p))


def _inlier_ratio_fields(p: dict) -> dict:
    return dict(
        inliers_ratio=float(_num(p.get("inliersRatio", 0.80))),
        max_local_points_per_layer=int(_num(p.get("maxLocalPointsPerLayer", 0))),
        layer_matches=_layer_matches(p), **_gating(p))


def _point2line_fields(p: dict) -> dict:
    return dict(
        distance_threshold=float(_num(p.get("distanceThreshold", 0.40))),
        knn=int(_num(p.get("knn", 4))),
        line_eigen_threshold=float(_num(p.get("lineEigenThreshold", 0.01))),
        min_points_to_fit=int(_num(p.get("minimumLinePoints", 4))),
        layer_matches=_layer_matches(p), **_gating(p))


def _point2plane_fields(p: dict) -> dict:
    return dict(
        distance_threshold=float(_num(p.get("distanceThreshold", 0.40))),
        knn=int(_num(p.get("knn", 7))),
        plane_eigen_threshold=float(_num(p.get("planeEigenThreshold", 0.01))),
        min_points_to_fit=int(_num(p.get("minimumPlanePoints", 4))),
        # consume the global layer's stored normals (the reference's
        # NearestPlaneCapable maps) instead of fitting every iteration
        use_point_normals=bool(p.get("usePointNormals", False)),
        layer_matches=_layer_matches(p), **_gating(p))


def _adaptive_fields(p: dict) -> dict:
    return dict(
        confidence_interval=_dynamic_num(p.get("confidenceInterval", 0.80)),
        first_to_second_distance_max=float(_num(p.get("firstToSecondDistanceMax", 1.2))),
        absolute_max_search_distance=_dynamic_num(p.get("absoluteMaxSearchDistance", 5.0)),
        minimum_corr_dist=float(_num(p.get("minimumCorrDist", 0.1))),
        enable_detect_planes=bool(p.get("enableDetectPlanes", False)),
        plane_search_points=int(_num(p.get("planeSearchPoints", 8))),
        plane_minimum_found_points=int(_num(p.get("planeMinimumFoundPoints", 4))),
        plane_minimum_distance=float(_num(p.get("planeMinimumDistance", 0.10))),
        plane_eigen_threshold=float(_num(p.get("planeEigenThreshold", 0.01))),
        max_pt2pt_correspondences=int(_num(p.get("maxPt2PtCorrespondences", 1))),
        allow_match_already_matched_global_points=bool(
            p.get("allowMatchAlreadyMatchedGlobalPoints", False)),
        allow_match_already_matched_points=bool(p.get("allowMatchAlreadyMatchedPoints", False)),
        layer_matches=_layer_matches(p), **_gating(p))


def _matcher(cls_name: str, fields: Callable) -> Callable:
    return lambda p: matcher_from_config(cls_name, fields(p))


_MATCHERS: Dict[str, Callable] = {
    "Matcher_Points_DistanceThreshold": _matcher("MatcherPointsDistanceThreshold",
                                                 _distance_threshold_fields),
    "Matcher_Points_InlierRatio": _matcher("MatcherPointsInlierRatio", _inlier_ratio_fields),
    "Matcher_Point2Line": _matcher("MatcherPoint2Line", _point2line_fields),
    "Matcher_Point2Plane": _matcher("MatcherPoint2Plane", _point2plane_fields),
    "Matcher_Adaptive": _matcher("MatcherAdaptive", _adaptive_fields),
}


# ----------------------------------------------------------------- solvers
def _pair_weights(p: dict) -> dict:
    pw = p.get("pairWeights", {}) or {}
    return {k: float(pw.get(k, 1.0)) for k in ("pt2pt", "pt2ln", "pt2pl", "ln2ln", "pl2pl")}


def _solver_gating(p: dict) -> dict:
    g = _gating(p)
    g["run_until_translation_correction_smaller_than"] = float(
        _num(p.get("runUntilTranslationCorrectionSmallerThan", 0.0)))
    return g


def _rigid_solver(cls_name: str) -> Callable:
    def build(p: dict):
        return solver_from_config(cls_name, dict(weight_params=dict(
            use_scale_outlier_detector=bool(p.get("use_scale_outlier_detector", False)),
            scale_outlier_threshold=float(_num(p.get("scale_outlier_threshold", 1.20))),
            pair_weights=_pair_weights(p),
            robust_kernel=str(p.get("robustKernel", "None")),
            robust_kernel_param=float(_num(p.get("robustKernelParam", 1.0))),
        ), **_solver_gating(p)))

    return build


def _build_solver_gn(p: dict):
    return solver_from_config("SolverGaussNewton", dict(gn_params=dict(
        max_iterations=int(_num(p.get("maxIterations", 3))),
        min_delta=float(_num(p.get("innerLoopMinDelta", 1e-7))),
        kernel=str(p.get("robustKernel", "None")),
        kernel_param=_dynamic_num(p.get("robustKernelParam", 1.0)),
        pair_weights=_pair_weights(p),
    ), **_solver_gating(p)))


_SOLVERS: Dict[str, Callable] = {
    "Solver_Horn": _rigid_solver("SolverHorn"),
    "Solver_OLAE": _rigid_solver("SolverOLAE"),
    "Solver_GaussNewton": _build_solver_gn,
}


# ----------------------------------------------------------------- quality
def _build_quality_paired_ratio(p: dict):
    reuse = bool(p.get("reuse_icp_pairings", True))
    matcher = None
    if not reuse:
        mp = dict(p)
        mp.setdefault("allowMatchAlreadyMatchedGlobalPoints", True)
        matcher = _distance_threshold_fields(mp)
    return quality_from_config("QualityPairedRatio", dict(
        reuse_icp_pairings=reuse,
        absolute_minimum_pairing_ratio=float(_num(p.get("absolute_minimum_pairing_ratio", 0.0))),
        matcher=matcher))


_QUALITY: Dict[str, Callable] = {
    "QualityEvaluator_PairedRatio": _build_quality_paired_ratio,
    "QualityEvaluator_Voxels": lambda p: quality_from_config("QualityVoxels", dict(
        voxel_layer_name=p.get("voxel_layer_name", "voxelmap"),
        dist2quality_scale=float(_num(p.get("dist2quality_scale", 2.0))))),
    # reference initialize() (QualityEvaluator_RangeImageSimilarity.cpp:29-41)
    "QualityEvaluator_RangeImageSimilarity": lambda p: quality_from_config(
        "QualityRangeImageSimilarity", dict(
            ncols=int(_num(p.get("ncols", 100))), nrows=int(_num(p.get("nrows", 60))),
            cx=float(_num(p.get("cx", 50.0))), cy=float(_num(p.get("cy", 30.0))),
            fx=float(_num(p.get("fx", 50.0))), fy=float(_num(p.get("fy", 50.0))),
            sigma=float(_num(p.get("sigma", 0.1))),
            penalty_not_visible=float(_num(p.get("penalty_not_visible", 0.1))))),
}


# ------------------------------------------------------------------ filters
def _layers(v) -> tuple:
    return (v,) if isinstance(v, str) else tuple(v)


def _decimate_fields(p: dict, variables=None) -> dict:
    return dict(
        input_pointcloud_layer=_layers(p.get("input_pointcloud_layer", "raw")),
        output_pointcloud_layer=p.get("output_pointcloud_layer", "decimated"),
        voxel_filter_resolution=float(_num(p.get("voxel_filter_resolution", 1.0), variables)),
        decimate_method=str(p.get("decimate_method", "DecimateMethod::FirstPoint")),
        flatten_to=float(_num(p["flatten_to"], variables)) if "flatten_to" in p else None,
        minimum_input_points_to_filter=int(
            _num(p.get("minimum_input_points_to_filter", 0), variables)))


def _deskew_fields(p: dict, variables=None) -> dict:
    def const_or_zero(x):
        # twist entries are usually '$f{vx}'-style expressions, which the
        # filter reads from the run-time variables itself
        try:
            return float(_num(x, variables))
        except (KeyError, TypeError, ValueError):
            return 0.0

    tw = p.get("twist")
    return dict(
        input_pointcloud_layer=p.get("input_pointcloud_layer", "raw"),
        output_pointcloud_layer=p.get("output_pointcloud_layer", "deskewed"),
        silently_ignore_no_timestamps=bool(p.get("silently_ignore_no_timestamps", False)),
        twist=tuple(const_or_zero(x) for x in tw) if tw else (0,) * 6,
        use_precise_local_velocities=bool(p.get("use_precise_local_velocities", False)))


def _merge_fields(p: dict, variables=None) -> dict:
    # the robot pose applies only to an input in local coordinates
    # (reference FilterMerge.cpp:96-108; input_layer_in_local_coordinates
    # defaults to false)
    return dict(
        input_pointcloud_layer=p.get("input_pointcloud_layer", "raw"),
        target_layer=p.get("target_layer", "map"),
        target_capacity=int(_num(p.get("target_capacity", 1 << 20))),
        use_robot_pose=bool(p.get("input_layer_in_local_coordinates",
                                  p.get("use_robot_pose", False))))


def _filter(cls_name: str, fields: Callable) -> Callable:
    return lambda p, variables=None: filter_from_config(cls_name, fields(p, variables))


_FILTERS: Dict[str, Callable] = {
    "FilterDecimateVoxels": _filter("FilterDecimateVoxels", _decimate_fields),
    "FilterByRange": _filter("FilterByRange", lambda p, v: dict(
        input_pointcloud_layer=p.get("input_pointcloud_layer", "raw"),
        output_layer_between=p.get("output_layer_between"),
        output_layer_outside=p.get("output_layer_outside"),
        range_min=float(_num(p.get("range_min", 0.0), v)),
        range_max=float(_num(p.get("range_max", 100.0), v)))),
    "FilterBoundingBox": _filter("FilterBoundingBox", lambda p, v: dict(
        input_pointcloud_layer=p.get("input_pointcloud_layer", "raw"),
        inside_pointcloud_layer=p.get("inside_pointcloud_layer"),
        outside_pointcloud_layer=p.get("outside_pointcloud_layer"),
        bbox_min=tuple(float(_num(x, v)) for x in p.get("bounding_box_min", (-1.0,) * 3)),
        bbox_max=tuple(float(_num(x, v)) for x in p.get("bounding_box_max", (1.0,) * 3)))),
    "FilterDeskew": _filter("FilterDeskew", _deskew_fields),
    "FilterMerge": _filter("FilterMerge", _merge_fields),
    "FilterEstimateNormals": _filter("FilterEstimateNormals", lambda p, v: dict(
        input_pointcloud_layer=p.get("input_pointcloud_layer", "decimated"),
        output_pointcloud_layer=p.get("output_pointcloud_layer", ""),
        source_pointcloud_layer=p.get("source_pointcloud_layer", ""),
        knn=int(_num(p.get("knn", 8))),
        max_radius=float(_num(p.get("max_radius", 2.0))),
        plane_eigen_threshold=float(_num(p.get("planeEigenThreshold", 0.01))),
        min_points_to_fit=int(_num(p.get("minimumPlanePoints", 4))))),
    "FilterDeleteLayer": _filter("FilterDeleteLayer", lambda p, v: dict(
        pointcloud_layer_to_remove=_layers(p.get("pointcloud_layer_to_remove", ())),
        error_on_missing_input_layer=bool(p.get("error_on_missing_input_layer", True)))),
    "FilterByRing": _filter("FilterByRing", lambda p, v: dict(
        input_pointcloud_layer=p.get("input_pointcloud_layer", "raw"),
        output_layer_selected=p.get("output_layer_selected"),
        output_layer_non_selected=p.get("output_layer_non_selected"),
        selected_ring_ids=tuple(p.get("selected_ring_ids", ())))),
    "FilterByIntensity": _filter("FilterByIntensity", lambda p, v: dict(
        input_pointcloud_layer=p.get("input_pointcloud_layer", "raw"),
        output_layer_low_intensity=p.get("output_layer_low_intensity"),
        output_layer_mid_intensity=p.get("output_layer_mid_intensity"),
        output_layer_high_intensity=p.get("output_layer_high_intensity"),
        low_threshold=float(_num(p.get("low_threshold", 0.10))),
        high_threshold=float(_num(p.get("high_threshold", 0.90))))),
    "FilterNormalizeIntensity": _filter("FilterNormalizeIntensity", lambda p, v: dict(
        pointcloud_layer=p.get("pointcloud_layer", "raw"))),
    "FilterDecimateVoxelsQuadratic": _filter("FilterDecimateVoxelsQuadratic", lambda p, v: dict(
        input_pointcloud_layer=p.get("input_pointcloud_layer", "raw"),
        output_pointcloud_layer=p.get("output_pointcloud_layer", "decimated"),
        voxel_filter_resolution=float(_num(p.get("voxel_filter_resolution", 0.20), v)),
        quadratic_reference_radius=float(_num(p.get("quadratic_reference_radius", 20.0), v)))),
    "FilterDecimateAdaptive": _filter("FilterDecimateAdaptive", lambda p, v: dict(
        input_pointcloud_layer=p.get("input_pointcloud_layer", "raw"),
        output_pointcloud_layer=p.get("output_pointcloud_layer", "decimated"),
        desired_output_point_count=int(_num(p.get("desired_output_point_count", 1000))),
        assumed_minimum_pointcloud_bbox=float(
            _num(p.get("assumed_minimum_pointcloud_bbox", 10.0))),
        maximum_voxel_count_per_dimension=int(
            _num(p.get("maximum_voxel_count_per_dimension", 100))))),
    "FilterRemoveByVoxelOccupancy": _filter("FilterRemoveByVoxelOccupancy", lambda p, v: dict(
        input_pointcloud_layer=p.get("input_pointcloud_layer", "raw"),
        input_voxel_layer=p.get("input_voxel_layer", "voxelmap"),
        output_layer_static_objects=p.get("output_layer_static_objects"),
        output_layer_dynamic_objects=p.get("output_layer_dynamic_objects"),
        occupancy_threshold=float(_num(p.get("occupancy_threshold", 0.4), v)))),
    "FilterVoxelSlice": _filter("FilterVoxelSlice", lambda p, v: dict(
        input_layer=p.get("input_layer", "voxelmap"),
        output_layer=p.get("output_layer", "gridmap"),
        slice_z_min=float(_num(p.get("slice_z_min", 0.0), v)),
        slice_z_max=float(_num(p.get("slice_z_max", 1.0), v)))),
    "GeneratorVoxelMap": _filter("GeneratorVoxelMap", lambda p, v: dict(
        input_pointcloud_layer=p.get("input_pointcloud_layer", "raw"),
        output_voxel_layer=p.get("output_voxel_layer", "voxelmap"),
        resolution=float(_num(p.get("resolution", 0.5), v)),
        capacity=int(_num(p.get("capacity", 1 << 16))),
        ray_samples=int(_num(p.get("ray_samples", 32))),
        carve_free_space=bool(p.get("carve_free_space", True)))),
    "FilterAdjustTimestamps": _filter("FilterAdjustTimestamps", lambda p, v: dict(
        pointcloud_layer=p.get("pointcloud_layer", "raw"),
        method=str(p.get("method", "TimestampAdjustMethod::MiddleIsZero")),
        time_offset=float(_num(p.get("time_offset", 0.0))),
        silently_ignore_no_timestamps=bool(p.get("silently_ignore_no_timestamps", False)))),
    "FilterEdgesPlanes": _filter("FilterEdgesPlanes", lambda p, v: dict(
        input_pointcloud_layer=p.get("input_pointcloud_layer", "raw"),
        voxel_filter_resolution=float(_num(p.get("voxel_filter_resolution", 0.5), v)),
        full_pointcloud_decimation=int(_num(p.get("full_pointcloud_decimation", 20))),
        voxel_filter_decimation=int(_num(p.get("voxel_filter_decimation", 1))),
        voxel_filter_max_e2_e0=float(_num(p.get("voxel_filter_max_e2_e0", 30.0))),
        voxel_filter_max_e1_e0=float(_num(p.get("voxel_filter_max_e1_e0", 30.0))),
        voxel_filter_min_e2_e0=float(_num(p.get("voxel_filter_min_e2_e0", 100.0))),
        voxel_filter_min_e1_e0=float(_num(p.get("voxel_filter_min_e1_e0", 100.0))),
        voxel_filter_min_e1=float(_num(p.get("voxel_filter_min_e1", 0.0))))),
    "FilterCurvature": _filter("FilterCurvature", lambda p, v: dict(
        input_pointcloud_layer=p.get("input_pointcloud_layer", "raw"),
        output_layer_larger_curvature=p.get("output_layer_larger_curvature"),
        output_layer_smaller_curvature=p.get("output_layer_smaller_curvature"),
        output_layer_other=p.get("output_layer_other"),
        max_cosine=float(_num(p.get("max_cosine", 0.5))),
        min_clearance=float(_num(p.get("min_clearance", 0.02))),
        max_gap=float(_num(p.get("max_gap", 1.0))))),
    "FilterPoleDetector": _filter("FilterPoleDetector", lambda p, v: dict(
        input_pointcloud_layer=p.get("input_pointcloud_layer", "raw"),
        output_layer_poles=p.get("output_layer_poles"),
        output_layer_no_poles=p.get("output_layer_no_poles"),
        grid_size=float(_num(p.get("grid_size", 2.0), v)),
        minimum_relative_height=float(_num(p.get("minimum_relative_height", 2.5), v)),
        maximum_relative_height=float(_num(p.get("maximum_relative_height", 25.0), v)),
        minimum_pole_points=int(_num(p.get("minimum_pole_points", 5))),
        minimum_neighbors_checks_to_pass=int(
            _num(p.get("minimum_neighbors_checks_to_pass", 3))))),
    "GeneratorEdgesFromCurvature": _filter("GeneratorEdgesFromCurvature", lambda p, v: dict(
        input_pointcloud_layer=p.get("input_pointcloud_layer", "raw"),
        target_layer=p.get("target_layer", "edges"),
        max_cosine=float(_num(p.get("max_cosine", 0.5))),
        min_point_clearance=float(_num(p.get("min_point_clearance", 0.10))))),
    "GeneratorEdgesFromRangeImage": _filter("GeneratorEdgesFromRangeImage", lambda p, v: dict(
        input_pointcloud_layer=p.get("input_pointcloud_layer", "raw"),
        target_layer=p.get("target_layer", "edges"),
        score_threshold=int(_num(p.get("score_threshold", 10))))),
}


# --------------------------------------------------------------- public API
def icp_pipeline_from_yaml(cfg: dict) -> Tuple[ICP, ICPParameters]:
    """(ICP, ICPParameters) from a reference-schema YAML dict (reference:
    icp_pipeline_from_yaml.cpp:26-77)."""
    class_name = _short(str(cfg.get("class_name", "ICP")))
    if class_name == "ICP_LibPointmatcher":
        # the reference's optional libpointmatcher wrapper keeps its pipeline
        # in an opaque 'ptConfig' blob: loading it would give an ICP with
        # no matchers or solvers, so refuse
        raise ValueError(
            "ICP_LibPointmatcher configs are not supported: the wrapper delegates to the "
            "external libpointmatcher engine (optional and disabled by default in the "
            "reference). Re-express the pipeline with native mp2p_icp matcher/solver classes.")
    if class_name != "ICP":
        raise ValueError(f"Unknown ICP class: {class_name}")
    p = cfg.get("params", {}) or {}
    # an optional plugin module with user classes (icp_pipeline_from_yaml.cpp:34-38)
    plugin = cfg.get("plugin") or p.get("plugin")
    if plugin:
        from mp2p_icp_tpu_torch.pipeline.plugins import load_plugin

        load_plugin(str(plugin))

    checkpoints = tuple(sorted(
        (int(k), float(v))
        for k, v in (p.get("quality_checkpoints", {50: 0.05, 100: 0.10}) or {}).items()))
    params = ICPParameters(
        max_iterations=int(_num(p.get("maxIterations", 40))),
        min_abs_step_trans=float(_num(p.get("minAbsStep_trans", 5e-4))),
        min_abs_step_rot=float(_num(p.get("minAbsStep_rot", 1e-4))),
        quality_checkpoints=checkpoints,
        debug_print_iteration_progress=bool(p.get("debugPrintIterationProgress", False)),
        # the debug files (reference Parameters.h:66-96)
        generate_debug_files=bool(p.get("generateDebugFiles", False)),
        save_iteration_details=bool(p.get("saveIterationDetails", False)),
        decimation_iteration_details=int(_num(p.get("decimationIterationDetails", 10))),
        decimation_debug_files=int(_num(p.get("decimationDebugFiles", 1))),
        debug_file_name_format=str(p.get("debugFileNameFormat",
                                         ICPParameters.debug_file_name_format)),
    )

    def build_list(section, registry, kind):
        out = []
        for entry in cfg.get(section, []) or []:
            cls = _short(str(entry.get("class")))
            if cls not in registry:
                raise ValueError(f"Unknown {kind} class: {cls}")
            out.append(registry[cls](entry.get("params", {}) or {}))
        return out

    matchers = build_list("matchers", _MATCHERS, "matcher")
    solvers = build_list("solvers", _SOLVERS, "solver")
    # a quality entry carries 'enabled' and 'weight' of its own (reference:
    # ICP.cpp:565-599)
    quality, q_weights = [], []
    for entry in cfg.get("quality", []) or []:
        if not entry.get("enabled", True):
            continue
        cls = _short(str(entry.get("class")))
        if cls not in _QUALITY:
            raise ValueError(f"Unknown quality evaluator class: {cls}")
        quality.append(_QUALITY[cls](entry.get("params", {}) or {}))
        q_weights.append(float(_num(entry.get("weight", 1.0))))
    if not quality:
        quality, q_weights = [QualityPairedRatio()], [1.0]
    return ICP(matchers=matchers, solvers=solvers, quality_evaluators=quality,
               quality_weights=q_weights), params


def filter_pipeline_from_yaml(entries, variables=None) -> list:
    """A filter list from the reference schema, a list of {class_name,
    params} (reference: FilterBase.cpp:51)."""
    out = []
    for entry in entries or []:
        cls = _short(str(entry.get("class_name") or entry.get("class")))
        if cls not in _FILTERS:
            raise ValueError(f"Unknown filter class: {cls}")
        out.append(_FILTERS[cls](entry.get("params", {}) or {}, variables))
    return out


def icp_pipeline_from_yaml_file(path: str):
    with open(path) as f:
        return icp_pipeline_from_yaml(_yaml.safe_load(f))


def filter_pipeline_from_yaml_file(path: str, section: Optional[str] = None, variables=None):
    with open(path) as f:
        cfg = _yaml.safe_load(f)
    if section:
        cfg = cfg.get(section, [])
    return filter_pipeline_from_yaml(cfg, variables)


def load_icp_config_file(path: str):
    """An icp-run config: (icp, params, sections); the filter sections map
    to filter lists and ``generators`` to a Generator list (reference:
    apps/icp-run/main.cpp:233-244)."""
    from mp2p_icp_tpu_torch.filters.generator import generators_from_yaml

    with open(path) as f:
        cfg = _yaml.safe_load(f)
    icp, params = icp_pipeline_from_yaml(cfg)
    sections = {sec: filter_pipeline_from_yaml(cfg[sec])
                for sec in ("filters", "filters_local_map", "filters_global_map", "final_filters")
                if sec in cfg}
    if "generators" in cfg:
        sections["generators"] = generators_from_yaml(cfg["generators"])
    return icp, params, sections
