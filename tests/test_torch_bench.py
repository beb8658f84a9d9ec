"""bench_torch.py, the port's benchmark, against bench.py and the JAX package.

- it imports nothing of the JAX side (a fresh process);
- its workloads are bench.py's: the scene pool, the sweeps, the corridor and
  its windows equal bit for bit for bench.py's seeds (``corridor_scene`` and
  ``local_window`` are nested in ``bench.main``: they are read out of
  bench.py's source with ``ast``, so the copies are held to the file as it
  stands). What passes through float32 pose arithmetic cannot be equal to
  the bit without the JAX package's own float32 sin, cos, arccos and fused
  products: the street drive's true poses, valid rays, rings and times are
  equal, its twists (the log of relative poses) within 8 ulp, its points
  within 1 ulp of their coordinates; the bench pair's sensor-frame scan
  within 1e-5 m (the scene spans ±60 m);
- its three configurations equal the JAX package's, built as bench.py:169-193,
  386-402 and 621-683 build them, through ``convert``;
- ``bench_torch.py --smoke --device cpu`` prints one stdout line with every
  key of bench.py's line (BENCH_r05.json's names), finite numbers, errors
  under 0.1, ATEs under 0.5 m, backend "cpu"; C++ keys null only where the
  build or run failed, said on stderr;
- the smoke run's scan-to-scan pair aligned by the JAX package: the same
  termination, iterations within 1 and poses within 5e-3, the bands of an
  align;
- on a card (marked ``cuda``): K2 at a scaled 16-problem shape, each problem
  its own map, against ``knn_plain_batched`` bit for bit.
"""

import ast
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import bench
import bench_torch as bt
from mp2p_icp_tpu.core import se3 as jse3
from mp2p_icp_tpu.core.pointcloud import PointCloud as JPointCloud
from mp2p_icp_tpu.filters.decimate_voxels import FilterDecimateVoxels as JDecimate
from mp2p_icp_tpu.filters.deskew import FilterDeskew as JDeskew
from mp2p_icp_tpu.icp import ICP as JICP
from mp2p_icp_tpu.icp import ICPParameters as JICPParameters
from mp2p_icp_tpu.matchers import MatcherAdaptive as JAdaptive
from mp2p_icp_tpu.matchers import MatcherPointsDistanceThreshold as JDistance
from mp2p_icp_tpu.matchers.base import LayerMatch as JLayerMatch
from mp2p_icp_tpu.matchers.point2plane import MatcherPoint2Plane as JPoint2Plane
from mp2p_icp_tpu.odometry import OdometryMapper as JOdometryMapper
from mp2p_icp_tpu.solvers.gauss_newton import GNParams as JGNParams
from mp2p_icp_tpu.solvers.robust import RobustKernel as JRobustKernel
from mp2p_icp_tpu.solvers.solver import SolverGaussNewton as JGN
from mp2p_icp_tpu.solvers.solver import SolverHorn as JHorn
import mp2p_icp_tpu_torch
from mp2p_icp_tpu_torch import convert
from mp2p_icp_tpu_torch.core import se3
from mp2p_icp_tpu_torch.eval import lidar_sim as sim
from mp2p_icp_tpu_torch.icp import ICPParameters
from mp2p_icp_tpu_torch.ops import nn_bruteforce as tnb

REPO = Path(__file__).resolve().parents[1]
BENCH_SRC = (REPO / "bench.py").read_text()
BENCH_KEYS = set(json.loads((REPO / "BENCH_r05.json").read_text())["parsed"]["extra"])
CPP_KEYS = ("cpp_kdtree_icp_aligns_per_s", "cpp_iters", "scan2map_cpp_aligns_per_s",
            "scan2map_cpp_aligns_per_s_tree_cached", "scan2map_cpp_tree_build_s",
            "scan2map_16M_cpp_aligns_per_s", "scan2map_16M_cpp_tree_build_s",
            "odometry_cpp_scans_per_s", "odometry_cpp_ate_m")


@pytest.fixture(autouse=True, scope="module")
def _ask_for_the_cpu():
    """The port's constructors default to the card; these tests run on the
    CPU and say so once for the whole file."""
    mp2p_icp_tpu_torch.set_default_device("cpu")
    yield
    mp2p_icp_tpu_torch.set_default_device(None)


def _bench_main():
    tree = ast.parse(BENCH_SRC)
    return next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")


def _nested(name):
    """A function defined inside bench.main, compiled from bench.py's source."""
    node = next(n for n in ast.walk(_bench_main())
                if isinstance(n, ast.FunctionDef) and n.name == name)
    ns = {"np": np}
    exec(compile(ast.Module(body=[node], type_ignores=[]), "bench.py", "exec"), ns)
    return ns[name]


def _bench_drive(n_frames):
    """bench.py's odometry drive (its statements from ``n_frames = ...`` up
    to the mapper), run with the JAX package as bench.py runs it: the
    namespace with ``gt_o``, ``otwists`` (noisy) and ``oframes``."""
    main = _bench_main()
    branch = next(n for n in ast.walk(main) if isinstance(n, ast.If)
                  and "MP2P_BENCH_ODOMETRY" in ast.get_source_segment(BENCH_SRC, n.test))
    body = []
    for st in branch.body:
        if ast.get_source_segment(BENCH_SRC, st).startswith("icp_o"):
            break
        body.append(st)
    import jax.numpy as jnp

    ns = {"np": np, "os": os, "se3": jse3, "jnp": jnp}
    old = os.environ.get("MP2P_BENCH_ODO_FRAMES")
    os.environ["MP2P_BENCH_ODO_FRAMES"] = str(n_frames)
    try:
        exec(compile(ast.Module(body=body, type_ignores=[]), "bench.py", "exec"), ns)
    finally:
        if old is None:
            del os.environ["MP2P_BENCH_ODO_FRAMES"]
        else:
            os.environ["MP2P_BENCH_ODO_FRAMES"] = old
    return ns


def test_bench_torch_imports_nothing_of_the_jax_side():
    """bench_torch.py imports torch, numpy and the port: neither jax, nor
    the JAX package, nor the JAX benchmark's script."""
    code = (
        "import sys, bench_torch; "
        "bad = [m for m in ('jax', 'mp2p_icp_tpu', 'bench') if m in sys.modules]; "
        "assert not bad, bad; "
        "assert callable(bench_torch.main) and 'mp2p_icp_tpu_torch' in sys.modules"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("seed", [0])
def test_scene_pool_and_pair_sweeps_are_bench_py_s(seed):
    """bench.py:151-156 and :224-226: the scene of seed 0 and the sweeps of
    seeds 1, 2 and 100-131, to the bit."""
    scene_b = bench.make_scene(np.random.RandomState(seed))
    scene_t = sim.make_scene(np.random.RandomState(seed))
    np.testing.assert_array_equal(scene_t, scene_b)
    for s in [1, 2] + list(range(100, 132)):
        np.testing.assert_array_equal(sim.sample_scan(scene_t, np.random.RandomState(s)),
                                      bench.sample_scan(scene_b, np.random.RandomState(s)))


def test_corridor_and_windows_are_bench_py_s():
    """bench.py:349-378, read out of bench.main: the corridor of seed 33
    (at 2^20 points; bench.py draws 2^24 or 2^21) and the windows of the
    sequential scan (seed 34, x = 200) and of the batch (seeds 100-107,
    bench.py:435-441), to the bit."""
    corridor_b, window_b = _nested("corridor_scene"), _nested("local_window")
    corridor = bt.corridor_scene(np.random.RandomState(33), 1 << 20)
    np.testing.assert_array_equal(corridor, corridor_b(np.random.RandomState(33), 1 << 20))
    assert corridor.dtype == np.float32 and corridor.shape == (1 << 20, 3)
    cases = [(200.0, 34)] + [(60.0 + 280.0 * b / 7, 100 + b) for b in range(8)]
    for cx, seed in cases:
        np.testing.assert_array_equal(bt.local_window(corridor, cx, np.random.RandomState(seed)),
                                      window_b(corridor, cx, np.random.RandomState(seed)))


def test_sensor_frame_scans_are_bench_py_s_to_float32_rounding():
    """The pair's local scan (bench.py:154-157) and the corridor scan in the
    sensor frame (:380-385): the port's float32 pose arithmetic against the
    JAX package's on the same draws (the poses' sin and cos round apart by
    an ulp: no bit equality without JAX)."""
    scene = sim.make_scene(np.random.RandomState(0))
    loc, glob = bt.street_pair(scene, 1, 2)
    np.testing.assert_array_equal(glob["raw"].xyz.numpy(),
                                  sim.sample_scan(scene, np.random.RandomState(1)))
    gt = jse3.from_xyz_ypr(*bt.GT)
    want = np.array(jse3.apply(jse3.inverse(gt), sim.sample_scan(scene, np.random.RandomState(2))))
    assert np.abs(loc["raw"].xyz.numpy() - want).max() <= 1e-5  # ±60 m: 4 ulp at 32 m
    corridor = bt.corridor_scene(np.random.RandomState(33), 1 << 20)
    err = (0.9, 0.2, 0.02, 0.02, 0.003, -0.004)
    layers, sensor, truth = bt.sensor_scan(corridor, 200.0, 34, err)
    sensor_j = jse3.from_xyz_ypr(200.0, 0.0, 1.5, 0.0, 0.0, 0.0)
    truth_j = jse3.compose(sensor_j, jse3.from_xyz_ypr(*err))
    np.testing.assert_array_equal(sensor.R.numpy(), np.asarray(sensor_j.R))
    np.testing.assert_array_equal(sensor.t.numpy(), np.asarray(sensor_j.t))
    np.testing.assert_allclose(truth.R.numpy(), np.asarray(truth_j.R), rtol=0, atol=2e-7)
    scan = bt.local_window(corridor, 200.0, np.random.RandomState(34))
    want = np.array(jse3.apply(jse3.inverse(truth_j), scan))
    assert np.abs(layers["raw"].xyz.numpy() - want).max() <= 1e-4  # x up to 250 m: 4 ulp at 128 m


def test_street_drive_is_bench_py_s():
    """bench.py:580-619 run by the JAX package against the port's
    make_street_sequence for 4 frames at 48 x 768 rays: true poses, valid
    rays, rings and times to the bit; the twists within 8 ulp and the points
    within 1 ulp of their coordinates (the relative poses' float32 log rounds
    apart by an ulp and the twist deskews each ray)."""
    ns = _bench_drive(4)
    gt, twists, scans = sim.make_street_sequence(4)
    np.testing.assert_array_equal(gt, ns["gt_o"])
    tw, tw_b = np.array(twists), np.array(ns["otwists"])
    assert tw.dtype == tw_b.dtype == np.float32
    assert (np.abs(tw - tw_b) <= 8 * np.spacing(np.abs(tw_b))).all()
    for scan, frame in zip(scans, ns["oframes"]):
        pc = frame["raw"]
        n = int(pc.count)
        v = scan["valid"]
        assert n == int(v.sum())
        np.testing.assert_array_equal(scan["time"][v], np.asarray(pc.time[:n]))
        np.testing.assert_array_equal(scan["ring"][v], np.asarray(pc.ring[:n]))
        xyz, xyz_b = scan["xyz"][v], np.asarray(pc.xyz[:n])
        assert (np.abs(xyz - xyz_b) <= np.spacing(np.maximum(np.abs(xyz), np.abs(xyz_b)))).all()
        np.testing.assert_allclose(scan["intensity"][v], np.asarray(pc.intensity[:n]),
                                   rtol=0, atol=1e-5)


def _same(port_icp, jax_matchers, jax_solvers):
    import chip_smoke

    return chip_smoke.same_modules(
        convert.icp_from_config([convert.config_of(m) for m in jax_matchers],
                                [convert.config_of(s) for s in jax_solvers]), port_icp)


def test_scan_configurations_are_bench_py_s():
    """kitti_icp (bench.py:169-193) and map_icp (:386-402) equal the JAX
    package's modules, config for config."""
    assert _same(bt.kitti_icp(),
                 [JDistance(threshold=2.0, run_up_to_iteration=5),
                  JAdaptive(confidence_interval=0.75, first_to_second_distance_max=1.2,
                            absolute_max_search_distance=2.0, run_from_iteration=6)],
                 [JHorn(run_up_to_iteration=5),
                  JGN(run_from_iteration=6, gn_params=JGNParams(
                      max_iterations=3, kernel=JRobustKernel.GEMAN_MCCLURE, kernel_param=0.15))])
    assert _same(bt.map_icp(),
                 [JDistance(threshold=2.0, layer_matches=(
                     JLayerMatch(global_layer="map", local_layer="raw"),))],
                 [JHorn(run_up_to_iteration=5),
                  JGN(run_from_iteration=6, gn_params=JGNParams(max_iterations=3))])


@pytest.mark.parametrize("incremental, backend", [(True, "sort"), (False, "hash")])
def test_odometry_mapper_is_bench_py_s(incremental, backend):
    """odometry_mapper (bench.py:621-683) under MP2P_ODO_INC_MAP and
    MP2P_ODO_DEC_BACKEND: the ICP, its parameters, the filters, the map
    filters and every other field equal the JAX package's mapper."""
    icp = JICP(matchers=[JPoint2Plane(distance_threshold=1.5, use_point_normals=True,
                                      layer_matches=(JLayerMatch(global_layer="map",
                                                                 local_layer="decimated"),))],
               solvers=[JGN(gn_params=JGNParams(max_iterations=3))])
    jm = JOdometryMapper(
        icp=icp,
        params=JICPParameters(max_iterations=30, crop_capacity=1 << 14, crop_extra_margin=3.0),
        filters=[JDeskew(input_pointcloud_layer="raw", output_pointcloud_layer="deskewed"),
                 JDecimate(input_pointcloud_layer=("deskewed",),
                           output_pointcloud_layer="decimated", voxel_filter_resolution=0.5,
                           output_capacity=6144, backend=backend)],
        incremental_map_resolution=0.5 if incremental else None,
        normals_knn=8, normals_radius=1.5, normals_query_capacity=2048,
        map_filters=[] if incremental else [JDecimate(
            input_pointcloud_layer=("map",), output_pointcloud_layer="map",
            voxel_filter_resolution=0.5, output_capacity=1 << 15)],
        local_layer="decimated", map_layer="map", map_capacity=1 << 15)
    tm = bt.odometry_mapper(incremental, backend)
    assert _same(tm.icp, icp.matchers, icp.solvers)
    assert tm.params == convert.params_from_config(dataclasses.asdict(jm.params))
    for mine, theirs in ((tm.filters, jm.filters), (tm.map_filters, jm.map_filters)):
        assert list(mine) == [convert.filter_from_config(*convert.config_of(f)) for f in theirs]
    for field in dataclasses.fields(tm):
        if field.name not in ("icp", "params", "filters", "map_filters"):
            assert getattr(tm, field.name) == getattr(jm, field.name), field.name


@pytest.fixture(scope="module")
def smoke():
    """One run of ``bench_torch.py --smoke --device cpu`` (bench.py's
    environment variables unset): (the process, its parsed line)."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("MP2P_")}
    out = subprocess.run([sys.executable, str(REPO / "bench_torch.py"), "--smoke", "--device",
                          "cpu"], capture_output=True, text=True, cwd=REPO, env=env, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1, out.stdout
    return out, json.loads(lines[0])


def _numbers(x):
    if isinstance(x, dict):
        for v in x.values():
            yield from _numbers(v)
    elif isinstance(x, (int, float)) and not isinstance(x, bool):
        yield x


def test_smoke_run_prints_bench_py_s_line(smoke):
    out, line = smoke
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "extra"}
    assert line["metric"] == "kitti_style_scan2scan_registrations_per_s_per_chip"
    extra = line["extra"]
    assert BENCH_KEYS | {"device", "power_limit_w"} <= set(extra), BENCH_KEYS - set(extra)
    assert extra["backend"] == "cpu" and extra["power_limit_w"] is None
    assert extra["n_points"] == bt.SMOKE.n_points and extra["batch_size"] == 2
    assert all(math.isfinite(v) for v in _numbers(line))
    for key in ("pose_err_se3_log", "batched_max_err", "scan2map_err", "scan2map_batched_max_err",
                "scan2map_streamed_err", "scan2map_16M_err"):
        assert 0.0 <= extra[key] < 0.1, key
    for key in ("odometry_ate_m", "odometry_offline_ate_m", "odometry_batched_max_ate_m"):
        assert 0.0 <= extra[key] < 0.5, key
    speeds = [k for k in extra if k.endswith("_per_s") and "cpp" not in k]
    assert all(extra[k] > 0 for k in speeds), speeds
    assert set(extra["stage_profile_ms"]) == {"nn_k1_ms", "dt_iter_ms", "ad_iter_ms",
                                              "dispatch_fetch_ms"}
    missing = [k for k in CPP_KEYS if extra[k] is None]
    if missing:
        # allowed only where the C++ could not be built or run, and said so
        assert "[bench] C++ " in out.stderr and line["vs_baseline"] is None, missing
        print(f"the C++ baselines failed here ({missing}): {out.stderr[-2000:]}")
    else:
        cpp = extra["cpp_kdtree_icp_aligns_per_s"]
        assert abs(line["vs_baseline"] - line["value"] / cpp) <= 0.005 + 0.005 / cpp
        assert (REPO / "build" / "native" / "baseline_icp").exists()
        print("the C++ baselines were built from native/*.cpp and ran")
    assert line["value"] == max(extra["sequential_scans_per_s"], extra["batched_scans_per_s"])
    assert [ln for ln in out.stderr.splitlines() if ln.startswith("[bench] scan to scan rep ")]


def test_smoke_pair_aligns_as_the_jax_package(smoke):
    """The smoke run's scan-to-scan pair (2048 points of bench.py's pair)
    through the port here and the JAX package on the same arrays: the
    same termination, iterations within 1, poses within 5e-3; the port's
    iterations and error are the line's."""
    _, line = smoke
    scene = sim.make_scene(np.random.RandomState(0))
    loc, glob = bt.street_pair(scene, 1, 2, bt.SMOKE.n_points)
    res = bt.kitti_icp().align(loc, glob, se3.identity(), ICPParameters(max_iterations=40))
    gt = se3.from_xyz_ypr(*bt.GT)
    assert res.n_iterations == line["extra"]["iters"]
    err = float(se3.error_log_norm(gt, res.optimal_tf))
    assert round(err, 5) == line["extra"]["pose_err_se3_log"]
    jicp = JICP(matchers=[JDistance(threshold=2.0, run_up_to_iteration=5),
                          JAdaptive(confidence_interval=0.75, first_to_second_distance_max=1.2,
                                    absolute_max_search_distance=2.0, run_from_iteration=6)],
                solvers=[JHorn(run_up_to_iteration=5),
                         JGN(run_from_iteration=6, gn_params=JGNParams(
                             max_iterations=3, kernel=JRobustKernel.GEMAN_MCCLURE,
                             kernel_param=0.15))])
    jres = jicp.align({"raw": JPointCloud.from_numpy(loc["raw"].xyz.numpy())},
                      {"raw": JPointCloud.from_numpy(glob["raw"].xyz.numpy())},
                      jse3.identity(), JICPParameters(max_iterations=40))
    assert int(jres.termination_reason) == res.termination_reason
    assert abs(int(jres.n_iterations) - res.n_iterations) <= 1
    pj = convert.pose_from_numpy(np.asarray(jres.optimal_tf.R), np.asarray(jres.optimal_tf.t))
    assert float(se3.error_log_norm(pj, res.optimal_tf)) < 5e-3


@pytest.mark.cuda
def test_k2_at_the_pair_batch_shape_on_card():
    """K2 as the B = 16 scan-to-scan batch calls it, each problem its own
    map (scaled to 2048 points a scan), equal to knn_plain_batched bit for
    bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the batched kNN kernel has no CPU mode")
    scene = sim.make_scene(np.random.RandomState(0))
    pairs = [bt.street_pair(scene, 100 + 2 * b, 101 + 2 * b, 2048) for b in range(16)]
    q = torch.stack([pl["raw"].xyz for pl, _ in pairs]).cuda()
    p = torch.stack([pg["raw"].xyz for _, pg in pairs]).cuda()
    d, i = tnb.knn_sweep_batched(q, p, 1)
    d_ref, i_ref = tnb.knn_plain_batched(q, p, 1)
    torch.cuda.synchronize()
    assert torch.equal(d, d_ref) and torch.equal(i, i_ref)
