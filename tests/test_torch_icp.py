"""The whole slice: ``ICP.align`` of the port against the JAX package on the
CPU, with the KITTI scan-to-scan configuration of bench.py:167-193
(DistanceThreshold(2.0) + Horn for iterations 0-5, then Adaptive + GN with
GemanMcClure 0.15) on a 2048-point pair of the bench street scene.

The JAX reference gives an SE(3) error of 0.0486 after 11 iterations
(STALLED) here. The checks: the same termination reason, iteration counts
within ±1, the two poses within 5e-3 of each other by error_log_norm
(measured: 7.4e-4 — the port's kNN distances are exact where the
reference's are rounded, and the robust GN weights follow them), and both
within 0.1 of the ground truth. Quality, pair counts and covariance agree
too (covariance to a relative 1e-4; measured 2e-7).
The port is built from the JAX modules with convert.icp_from_config.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import bench
import chip_smoke
from mp2p_icp_tpu.core import se3 as jse3
from mp2p_icp_tpu.core.pointcloud import PointCloud as JPointCloud
from mp2p_icp_tpu.icp import ICP as JICP
from mp2p_icp_tpu.icp import ICPParameters as JICPParameters
from mp2p_icp_tpu.matchers import MatcherAdaptive as JAdaptive
from mp2p_icp_tpu.matchers import MatcherPointsDistanceThreshold as JDistance
from mp2p_icp_tpu.quality.paired_ratio import QualityPairedRatio as JQuality
from mp2p_icp_tpu.solvers.gauss_newton import GNParams as JGNParams
from mp2p_icp_tpu.solvers.robust import RobustKernel as JRobustKernel
from mp2p_icp_tpu.solvers.solver import SolverGaussNewton as JGN
from mp2p_icp_tpu.solvers.solver import SolverHorn as JHorn
import mp2p_icp_tpu_torch
from mp2p_icp_tpu_torch import convert
from mp2p_icp_tpu_torch.core import se3
from mp2p_icp_tpu_torch.core.metric_map import MetricMap
from mp2p_icp_tpu_torch.core.pointcloud import PointCloud
from mp2p_icp_tpu_torch.icp import ICP, ICPParameters, IterTermReason
from mp2p_icp_tpu_torch.matchers import MatcherPointsDistanceThreshold
from mp2p_icp_tpu_torch.solvers.solver import SolverHorn


@pytest.fixture(autouse=True, scope="module")
def _ask_for_the_cpu():
    """The port's constructors default to the card; these tests run on the
    CPU and say so once for the whole file."""
    mp2p_icp_tpu_torch.set_default_device("cpu")
    yield
    mp2p_icp_tpu_torch.set_default_device(None)


GT = (1.1, 0.05, 0.01, 0.01, 0.002, 0.001)


def kitti_modules():
    """The JAX package's KITTI scan-to-scan modules (bench.py:167-193)."""
    return (
        [JDistance(threshold=2.0, run_up_to_iteration=5),
         JAdaptive(confidence_interval=0.75, first_to_second_distance_max=1.2,
                   absolute_max_search_distance=2.0, run_from_iteration=6)],
        [JHorn(run_up_to_iteration=5),
         JGN(run_from_iteration=6,
             gn_params=JGNParams(max_iterations=3, kernel=JRobustKernel.GEMAN_MCCLURE,
                                 kernel_param=0.15))],
    )


def street_pair(n, seed_g=1, seed_l=2):
    """bench.py's pair: two samplings of the street scene, the local one
    moved by the inverse ground truth. Returns numpy (global, local)."""
    scene = bench.make_scene(np.random.RandomState(0))
    g = bench.sample_scan(scene, np.random.RandomState(seed_g), n=n)
    loc = bench.sample_scan(scene, np.random.RandomState(seed_l), n=n)
    gt = se3.from_xyz_ypr(*GT)
    return g, se3.apply(se3.inverse(gt), torch.from_numpy(loc)).numpy()


def _align_both(jicp, ticp, g, loc, params_j, params_t):
    jres = jicp.align({"raw": JPointCloud.from_numpy(loc)},
                      {"raw": JPointCloud.from_numpy(g)}, jse3.identity(), params_j)
    tres = ticp.align({"raw": PointCloud.from_numpy(loc)},
                      {"raw": PointCloud.from_numpy(g)}, se3.identity(), params_t)
    return jres, tres


def _pose_gap(jres, tres):
    pj = convert.pose_from_numpy(np.asarray(jres.optimal_tf.R), np.asarray(jres.optimal_tf.t))
    return float(se3.error_log_norm(pj, tres.optimal_tf))


def test_kitti_align_matches_jax():
    jm, js = kitti_modules()
    jicp = JICP(matchers=jm, solvers=js)
    ticp = convert.icp_from_config([convert.config_of(m) for m in jm],
                                   [convert.config_of(s) for s in js])
    g, loc = street_pair(2048)
    jres, tres = _align_both(jicp, ticp, g, loc, JICPParameters(max_iterations=40),
                             ICPParameters(max_iterations=40))
    assert tres.termination_reason == int(jres.termination_reason) == IterTermReason.STALLED
    assert abs(tres.n_iterations - int(jres.n_iterations)) <= 1
    assert _pose_gap(jres, tres) < 5e-3
    gt = se3.from_xyz_ypr(*GT)
    assert float(se3.error_log_norm(gt, tres.optimal_tf)) < 0.1
    jgt = jse3.from_xyz_ypr(*GT)
    assert float(jse3.error_log_norm(jgt, jres.optimal_tf)) < 0.1
    # quality = paired / potential over the final pairings: same counts
    # up to tie rows (1%)
    assert abs(float(tres.quality) - float(jres.quality)) < 0.01
    cj = np.asarray(jres.covariance)
    np.testing.assert_allclose(tres.covariance.numpy(), cj, atol=1e-4 * np.abs(cj).max())
    # the final pairings keep the JAX layout: DT pt2pt, then Adaptive pt2pt
    fj, ft = jres.final_pairings, tres.final_pairings
    assert ft.pt2pt.capacity == fj.pt2pt.capacity and ft.pt2pl.capacity == fj.pt2pl.capacity
    assert abs(int(ft.size()) - int(fj.size())) <= 0.01 * int(fj.size())


def test_latch_and_quality_checkpoint_match_jax():
    """Horn until the step is below 5 cm, then GN (the run_until latch), and
    a quality checkpoint at iteration 2 that the pair cannot meet."""
    jm = [JDistance(threshold=1.0)]
    js = [JHorn(run_until_translation_correction_smaller_than=0.05),
          JGN(gn_params=JGNParams(max_iterations=2))]
    ticp = convert.icp_from_config([convert.config_of(m) for m in jm],
                                   [convert.config_of(s) for s in js],
                                   [convert.config_of(JQuality())])
    g, loc = street_pair(512)
    for ckpt, reason in [(((2, 0.99),), IterTermReason.QUALITY_CHECKPOINT_FAILED),
                         (((50, 0.05),), IterTermReason.STALLED)]:
        jres, tres = _align_both(
            JICP(matchers=jm, solvers=js), ticp, g, loc,
            JICPParameters(max_iterations=12, quality_checkpoints=ckpt),
            ICPParameters(max_iterations=12, quality_checkpoints=ckpt),
        )
        assert tres.termination_reason == int(jres.termination_reason) == reason
        assert abs(tres.n_iterations - int(jres.n_iterations)) <= 1
        assert _pose_gap(jres, tres) < 5e-3


def test_no_pairings_terminates():
    g, loc = street_pair(256)
    icp = ICP(matchers=[MatcherPointsDistanceThreshold(threshold=0.5)],
              solvers=[SolverHorn()])
    far = PointCloud.from_numpy(g + 1000.0)
    res = icp.align({"raw": PointCloud.from_numpy(loc)}, {"raw": far}, se3.identity())
    assert res.termination_reason == IterTermReason.NO_PAIRINGS
    assert res.n_iterations == 1
    assert torch.equal(res.optimal_tf.t, torch.zeros(3))
    assert float(res.quality) == 0.0
    assert (res.covariance == 1.0e6 * torch.eye(6)).all()


@pytest.mark.parametrize("option", [
    dict(record_iterations=True), dict(record_pairings=True),
    dict(iteration_hook=lambda *a: False), dict(generate_debug_files=True),
])
def test_unported_options_raise(option, tmp_path):
    """The options that raised before they were ported run now and leave
    the registration as it is: the same pose, iterations and quality as
    the align without them (tests/test_torch_engine_options.py holds each
    against the JAX package)."""
    g, loc = street_pair(256)
    icp = ICP(matchers=[MatcherPointsDistanceThreshold()], solvers=[SolverHorn()])
    maps = ({"raw": PointCloud.from_numpy(loc)}, {"raw": PointCloud.from_numpy(g)})
    option = dict(option, debug_file_name_format=str(tmp_path / "run-$UNIQUE_ID.icplog.npz"))
    res = icp.align(*maps, se3.identity(), ICPParameters(**option))
    ref = icp.align(*maps, se3.identity(), ICPParameters())
    assert torch.equal(res.optimal_tf.R, ref.optimal_tf.R)
    assert torch.equal(res.optimal_tf.t, ref.optimal_tf.t)
    assert res.n_iterations == ref.n_iterations
    assert float(res.quality) == float(ref.quality)
    assert (res.iteration_poses is not None) == bool(option.get("record_iterations"))
    assert len(list(tmp_path.iterdir())) == int(bool(option.get("generate_debug_files")))


def test_unported_inputs_raise():
    g, loc = street_pair(256)
    icp = ICP(matchers=[MatcherPointsDistanceThreshold()], solvers=[SolverHorn()])
    local = {"raw": PointCloud.from_numpy(loc)}
    # a global layer above crop_capacity is cropped now (it raised before
    # the crop was ported): the recorded ids still address the user's map
    res = icp.align(local, {"raw": PointCloud.from_numpy(g)}, se3.identity(),
                    ICPParameters(crop_capacity=128))
    assert res.n_iterations > 0 and int(res.final_pairings.pt2pt.global_idx.max()) < 256
    # a MetricMap gives the align of its point layers; any other object raises
    mm = MetricMap(layers=dict(local), id=3, label="scan")
    res_mm = icp.align(mm, {"raw": PointCloud.from_numpy(g)}, se3.identity())
    res_dict = icp.align(local, {"raw": PointCloud.from_numpy(g)}, se3.identity())
    assert torch.equal(res_mm.optimal_tf.t, res_dict.optimal_tf.t)
    with pytest.raises(TypeError, match="MetricMap"):
        icp.align(dataclasses.make_dataclass("M", ["layers"])(local),
                  {"raw": PointCloud.from_numpy(g)}, se3.identity())
    with pytest.raises(ValueError):
        ICP(matchers=[], solvers=[SolverHorn()]).align(local, local, se3.identity())


# ------------------------------------------------- the engine configurations
def _engine_reference():
    """scripts/torch_engine_reference.py: the JAX package's configurations
    of chip_smoke.py's engine phase and the runs on both packages."""
    path = str(Path(__file__).resolve().parents[1] / "scripts")
    if path not in sys.path:
        sys.path.insert(0, path)
    import torch_engine_reference

    return torch_engine_reference


def _assert_runs_match(port, ref, scale=False):
    """Same termination, iterations ±1, poses within 5e-3 (error_log_norm
    of the two SE(3) logs), quality within 5e-3, the scale to 1e-4."""
    assert port["termination"] == ref["termination"]
    assert abs(port["iterations"] - ref["iterations"]) <= 1
    gap = se3.error_log_norm(se3.exp(torch.tensor(ref["log"])), se3.exp(torch.tensor(port["log"])))
    assert float(gap) < 5e-3
    assert port["quality"] == pytest.approx(ref["quality"], abs=5e-3)
    if scale:
        assert port["scale"] == pytest.approx(ref["scale"], rel=1e-4)


def test_engine_configuration_matches_jax():
    """chip_smoke.py's 3D engine configuration (InlierRatio + OLAE, then
    Adaptive with planes + Gauss-Newton; paired-ratio, voxel and
    range-image qualities; a Horn solver's scale) at 2048 points and 2^16
    voxel cells, without a hook and with the hook that stops at iteration
    4. convert builds chip_smoke.py's configuration from the JAX one."""
    ref = _engine_reference()
    jicp = ref.jax_engine_icp()
    ticp = convert.icp_from_config(
        [convert.config_of(m) for m in jicp.matchers], [convert.config_of(s) for s in jicp.solvers],
        [convert.config_of(q) for q in jicp.quality_evaluators])
    mine = chip_smoke.engine_icp()
    assert (ticp.matchers, ticp.solvers, ticp.quality_evaluators) == (
        mine.matchers, mine.solvers, tuple(mine.quality_evaluators))
    jax_runs = ref.run_engine(2048, 1 << 16)
    port_runs = ref.run_port_engine(2048, 1 << 16)
    for label in ("no hook", "stopping hook"):
        _assert_runs_match(port_runs[label], jax_runs[label], scale=True)
    assert port_runs["stopping hook"]["iterations"] == chip_smoke.ENGINE_HOOK_STOP + 1
    assert float(se3.error_log_norm(se3.from_xyz_ypr(*GT), se3.exp(torch.tensor(
        port_runs["no hook"]["log"])))) < 0.1


def test_point2line_configuration_matches_jax():
    """The 2D demo (Point2Line k=5 + DistanceThreshold + Gauss-Newton) on
    chip_smoke.py's 9 planar pairs at 361 rays, each from its motion-model
    guess: every align as the JAX package's and within 0.1 of the truth."""
    ref = _engine_reference()
    jicp = ref.jax_point2line_icp()
    ticp = convert.icp_from_config([convert.config_of(m) for m in jicp.matchers],
                                   [convert.config_of(s) for s in jicp.solvers])
    assert (ticp.matchers, ticp.solvers) == (chip_smoke.point2line_icp().matchers,
                                             chip_smoke.point2line_icp().solvers)
    jax_runs, port_runs = ref.run_planar(361), ref.run_port_planar(361)
    for (_, _, rel), port, jax_run in zip(chip_smoke.planar_pairs(361), port_runs, jax_runs):
        _assert_runs_match(port, jax_run)
        gt = se3.from_xyz_ypr(rel[0], rel[1], 0.0, rel[2], 0.0, 0.0)
        assert float(se3.error_log_norm(gt, se3.exp(torch.tensor(port["log"])))) < 0.1
