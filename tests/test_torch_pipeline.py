"""The port's YAML loader against the JAX package's, on the CPU.

- The repo's four demos load in both packages, and every module the port
  builds equals the one that ``convert`` builds from the JAX package's
  config for config (``convert.config_of``): matchers, solvers, quality
  evaluators and their weights, the ICP parameters, the filter sections,
  the generators.
- An example1 align (2048 points, its ClosestToAverage sections on both
  scans) and a 2D align (361 rays decoded by the demo's generators) from
  YAML: the align band (same termination, iterations within +-1, or +-25%
  for the 2D demo's creeping stall; pose gap < 5e-3).
- Plugins: register, idempotent, search path, missing, the ``plugin:`` key.
- The five names of the JAX filter library that the port has not yet
  raise NotImplementedError; the libpointmatcher config and unknown
  classes are refused.
"""

import dataclasses
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import mp2p_icp_tpu_torch
from mp2p_icp_tpu.core import se3 as jse3
from mp2p_icp_tpu.core.metric_map import MetricMap as JMetricMap
from mp2p_icp_tpu.core.pointcloud import PointCloud as JPointCloud
from mp2p_icp_tpu.filters import apply_filter_pipeline as japply
from mp2p_icp_tpu.filters.generator import Observation as JObservation
from mp2p_icp_tpu.filters.generator import apply_generators as japply_generators
from mp2p_icp_tpu.filters.generator import generators_from_yaml as jgenerators
from mp2p_icp_tpu.pipeline import yaml_loader as jyl
from mp2p_icp_tpu_torch import convert
from mp2p_icp_tpu_torch.core import se3
from mp2p_icp_tpu_torch.core.metric_map import MetricMap
from mp2p_icp_tpu_torch.core.pointcloud import PointCloud
from mp2p_icp_tpu_torch.filters import apply_filter_pipeline
from mp2p_icp_tpu_torch.filters.generator import Observation, apply_generators, generators_from_yaml
from mp2p_icp_tpu_torch.pipeline import yaml_loader as yl

DEMOS = Path(__file__).resolve().parents[1] / "demos"
ICP_DEMOS = ("icp-settings-kitti.yaml", "icp-settings-example1.yaml",
             "icp-settings-2d-lidar-point2line.yaml")


@pytest.fixture(autouse=True, scope="module")
def _ask_for_the_cpu():
    """The port's constructors default to the card; these tests run on the
    CPU and say so once for the whole file."""
    mp2p_icp_tpu_torch.set_default_device("cpu")
    yield
    mp2p_icp_tpu_torch.set_default_device(None)


def _from_jax(module, kind):
    return getattr(convert, f"{kind}_from_config")(*convert.config_of(module))


def _filters_equal(port, jax_filters):
    assert len(port) == len(jax_filters)
    for ft, fj in zip(port, jax_filters):
        assert convert.config_of(ft) == convert.config_of(_from_jax(fj, "filter"))


# -------------------------------------------------------------- the demos
@pytest.mark.parametrize("demo", ICP_DEMOS)
def test_icp_demo_loads_as_in_jax(demo):
    icp, params, sections = yl.load_icp_config_file(str(DEMOS / demo))
    jicp, jparams, jsections = jyl.load_icp_config_file(str(DEMOS / demo))
    for kind, a, b in (("matcher", icp.matchers, jicp.matchers),
                       ("solver", icp.solvers, jicp.solvers),
                       ("quality", icp.quality_evaluators, jicp.quality_evaluators)):
        assert len(a) == len(b) > 0
        assert [convert.config_of(m) for m in a] == [
            convert.config_of(_from_jax(m, kind)) for m in b]
    assert list(icp.quality_weights) == list(jicp.quality_weights)
    assert params == convert.params_from_config(dataclasses.asdict(jparams))
    assert sorted(sections) == sorted(jsections)
    for name, section in sections.items():
        _filters_equal(section, jsections[name])


def test_sm2mm_demo_loads_as_in_jax():
    cfg = yaml.safe_load((DEMOS / "sm2mm_voxelmap_static_dynamic.yaml").read_text())
    _filters_equal(generators_from_yaml(cfg["generators"]), jgenerators(cfg["generators"]))
    for section in ("filters", "final_filters"):
        _filters_equal(yl.filter_pipeline_from_yaml(cfg[section]),
                       jyl.filter_pipeline_from_yaml(cfg[section]))
    merge = yl.filter_pipeline_from_yaml(cfg["filters"])[1]
    assert merge.use_robot_pose and merge.target_capacity == 1 << 20


def test_kitti_and_2d_demos_equal_the_chip_configurations():
    import chip_smoke

    kitti, _, _ = yl.load_icp_config_file(str(DEMOS / "icp-settings-kitti.yaml"))
    # the demo's matchers pair the layer its filter section makes
    assert not chip_smoke.same_modules(kitti, chip_smoke.kitti_icp())
    assert chip_smoke.same_modules(kitti, chip_smoke.kitti_icp(), {"decimated": "raw"})
    planar, _, _ = yl.load_icp_config_file(str(DEMOS / "icp-settings-2d-lidar-point2line.yaml"))
    assert chip_smoke.same_modules(planar, chip_smoke.point2line_icp())


def test_every_filter_class_loads_as_in_jax():
    """chip_smoke.ALL_FILTERS_YAML (every filter class of the slice) and
    expressions in the parameters."""
    import chip_smoke

    entries = yaml.safe_load(chip_smoke.ALL_FILTERS_YAML)["filters"]
    _filters_equal(yl.filter_pipeline_from_yaml(entries), jyl.filter_pipeline_from_yaml(entries))
    expr = [{"class_name": "FilterByRange",
             "params": {"range_max": "$f{2*r}", "output_layer_between": "x"}}]
    ft, = yl.filter_pipeline_from_yaml(expr, {"r": 7.5})
    fj, = jyl.filter_pipeline_from_yaml(expr, {"r": 7.5})
    assert ft.range_max == fj.range_max == 15.0


# ---------------------------------------------------------------- aligns
def _align_band(rt, rj, planar=False):
    from mp2p_icp_tpu_torch.icp import IterTermReason

    assert rt.termination_reason == IterTermReason(int(rj.termination_reason))
    band = max(1, 0.25 * int(rj.n_iterations)) if planar else 1
    assert abs(rt.n_iterations - int(rj.n_iterations)) <= band
    log_j = np.asarray(jse3.log(rj.optimal_tf))
    gap = float(se3.error_log_norm(se3.exp(torch.tensor(log_j, dtype=torch.float32)),
                                   rt.optimal_tf))
    assert gap < 5e-3, gap


def test_example1_align_from_yaml_matches_jax():
    import chip_smoke

    l1, g1 = chip_smoke.example1_pair(chip_smoke.make_scene(np.random.RandomState(0)), n=2048)
    icp, params, sections = yl.load_icp_config_file(str(DEMOS / "icp-settings-example1.yaml"))
    jicp, jparams, jsections = jyl.load_icp_config_file(str(DEMOS / "icp-settings-example1.yaml"))
    fl = apply_filter_pipeline(sections["filters_local_map"], {"raw": PointCloud.from_numpy(l1)})
    fg = apply_filter_pipeline(sections["filters_global_map"], {"raw": PointCloud.from_numpy(g1)})
    jl = japply(jsections["filters_local_map"], {"raw": JPointCloud.from_numpy(l1)})
    jg = japply(jsections["filters_global_map"], {"raw": JPointCloud.from_numpy(g1)})
    for a, b in ((fl, jl), (fg, jg)):
        assert int(a["decimated"].count) == int(b["decimated"].count) < 2048
        np.testing.assert_array_equal(a["decimated"].xyz.numpy(), np.asarray(b["decimated"].xyz))
    rt = icp.align(fl, fg, se3.identity(), params)
    rj = jicp.align(jl, jg, jse3.identity(), jparams)
    _align_band(rt, rj)
    assert float(se3.error_log_norm(se3.from_xyz_ypr(*chip_smoke.EXAMPLE1_GT),
                                    rt.optimal_tf)) < 0.01


def test_2d_align_from_yaml_generators_matches_jax():
    import chip_smoke

    path = str(DEMOS / "icp-settings-2d-lidar-point2line.yaml")
    icp, params, sections = yl.load_icp_config_file(path)
    jicp, jparams, jsections = jyl.load_icp_config_file(path)
    (g, loc, rel), = chip_smoke.planar_range_pairs(n_rays=361, n_pairs=1)
    maps, jmaps = [], []
    for ranges in (loc, g):
        obs = chip_smoke.planar_observation(ranges)
        mm, jmm = MetricMap(), JMetricMap()
        assert apply_generators(sections["generators"], Observation(**obs), mm)
        assert japply_generators(jsections["generators"], JObservation(**obs), jmm)
        np.testing.assert_array_equal(mm.layers["2d_lidar"].xyz.numpy(),
                                      np.asarray(jmm.layers["2d_lidar"].xyz))
        maps.append(mm)
        jmaps.append(jmm)
    guess = chip_smoke.planar_guess(rel)
    rt = icp.align(maps[0], maps[1], se3.from_xyz_ypr(*guess), params)
    rj = jicp.align(jmaps[0], jmaps[1], jse3.from_xyz_ypr(*guess), jparams)
    _align_band(rt, rj, planar=True)


# --------------------------------------------------------------- refusals
def test_unported_filter_names_raise():
    """No filter name is left unported: every name of the JAX loader
    builds the port's class of that name with its defaults, and an
    unknown name still raises."""
    assert sorted(yl._FILTERS) == sorted(jyl._FILTERS)
    for name in jyl._FILTERS:
        (f,) = yl.filter_pipeline_from_yaml([{"class_name": f"mp2p_icp_filters::{name}",
                                              "params": {}}])
        assert type(f).__name__ == name and name in convert._FILTERS
    with pytest.raises(ValueError, match="unknown filter class"):
        convert.filter_from_config("FilterNope", {})


def test_refused_configs():
    with pytest.raises(ValueError, match="libpointmatcher"):
        yl.icp_pipeline_from_yaml({"class_name": "mp2p_icp::ICP_LibPointmatcher"})
    with pytest.raises(ValueError, match="Unknown ICP class"):
        yl.icp_pipeline_from_yaml({"class_name": "Other"})
    for section, kind in (("matchers", "matcher"), ("solvers", "solver"),
                          ("quality", "quality evaluator")):
        with pytest.raises(ValueError, match=f"Unknown {kind} class"):
            yl.icp_pipeline_from_yaml({"class_name": "ICP", section: [{"class": "Nope"}]})
    with pytest.raises(ValueError, match="Unknown filter class"):
        yl.filter_pipeline_from_yaml([{"class_name": "FilterNope"}])
    with pytest.raises(ValueError, match="Unknown generator class"):
        generators_from_yaml([{"class_name": "GeneratorNope"}])


# ---------------------------------------------------------------- plugins
PLUGIN_SRC = textwrap.dedent(
    """
    import dataclasses

    from mp2p_icp_tpu_torch.filters.base import FilterBase
    from mp2p_icp_tpu_torch.matchers.distance_threshold import (
        MatcherPointsDistanceThreshold,
    )


    @dataclasses.dataclass(frozen=True)
    class FilterNoOp(FilterBase):
        def __call__(self, layers, variables=None):
            return layers


    def mp2p_register(api):
        api.register_filter("FilterNoOpTorch", lambda p, variables=None: FilterNoOp())
        api.register_matcher(
            "Matcher_MyCustomTorch",
            lambda p: MatcherPointsDistanceThreshold(threshold=float(p.get("threshold", 2.0))),
        )
    """
)


@pytest.fixture()
def plugin_file(tmp_path):
    p = tmp_path / "my_torch_plugin.py"
    p.write_text(PLUGIN_SRC)
    return str(p)


def test_load_plugin_registers_classes(plugin_file):
    from mp2p_icp_tpu_torch.pipeline import filter_pipeline_from_yaml, load_plugin

    load_plugin(plugin_file)
    f, = filter_pipeline_from_yaml([{"class_name": "FilterNoOpTorch", "params": {}}])
    assert type(f).__module__.startswith("mp2p_icp_tpu_torch_plugin_")
    assert "FilterNoOpTorch" not in jyl._FILTERS  # the port's registries only


def test_load_plugin_idempotent(plugin_file):
    from mp2p_icp_tpu_torch.pipeline import load_plugin

    assert load_plugin(plugin_file) is load_plugin(plugin_file)


def test_plugin_search_path(tmp_path, monkeypatch):
    from mp2p_icp_tpu_torch.pipeline import load_plugin

    d = tmp_path / "plugdir"
    d.mkdir()
    (d / "relplug_torch.py").write_text(PLUGIN_SRC)
    monkeypatch.setenv("MP2P_ICP_TPU_PLUGIN_PATH", str(d))
    assert hasattr(load_plugin("relplug_torch.py"), "FilterNoOp")


def test_plugin_missing_raises(tmp_path, monkeypatch):
    from mp2p_icp_tpu_torch.pipeline import load_plugin

    monkeypatch.setenv("MP2P_ICP_TPU_PLUGIN_PATH", str(tmp_path))
    with pytest.raises(FileNotFoundError):
        load_plugin("does_not_exist_torch.py")


def test_yaml_plugin_key(plugin_file):
    from mp2p_icp_tpu_torch.pipeline import icp_pipeline_from_yaml

    cfg = yaml.safe_load(f"""
        class_name: mp2p_icp::ICP
        plugin: "{plugin_file}"
        params:
          maxIterations: 5
        solvers:
          - class: mp2p_icp::Solver_Horn
            params: ~
        matchers:
          - class: mp2p_icp::Matcher_MyCustomTorch
            params:
              threshold: 3.0
        quality:
          - class: mp2p_icp::QualityEvaluator_PairedRatio
            params: ~
        """)
    icp, params = icp_pipeline_from_yaml(cfg)
    assert params.max_iterations == 5
    assert float(icp.matchers[0].threshold) == 3.0
