"""The port's map building from keyframes against the JAX package, on the CPU.

Mirrors tests/test_sm2mm.py, tests/test_precise_deskew.py and
tests/test_generator_decode.py, each case run through both packages on
the same numpy inputs:

- generators: gating, sensor pose, decoders, ``metric_map_definition``
  (points exact; a voxel layer: keys exact, occupancy 1e-6);
- the velocity buffer: the reconstructed tangents within 1e-6;
- the precise deskew in sm2mm: the deskewed rows within 1e-5 m of the
  JAX package's, and the wall that constant twist cannot recover;
- ``SimpleMap`` files written by one package and read by the other;
- a 4-keyframe sm2mm of the repo's demo YAML (constant twist and precise):
  counts equal, map rows within 1e-5 m, voxel keys exact;
- the voxel map of that demo lies in another frame than its map points
  (ROADMAP C, inherited: kept).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import yaml

import mp2p_icp_tpu_torch
from mp2p_icp_tpu.core import se3 as jse3
from mp2p_icp_tpu.core.metric_map import MetricMap as JMetricMap
from mp2p_icp_tpu.core.velocity_buffer import LocalVelocityBuffer as JBuffer
from mp2p_icp_tpu.filters import generator as jgen
from mp2p_icp_tpu.filters import sm2mm as jsm
from mp2p_icp_tpu_torch import convert
from mp2p_icp_tpu_torch.core import se3
from mp2p_icp_tpu_torch.core.metric_map import MetricMap, VoxelGridLayer
from mp2p_icp_tpu_torch.core.pointcloud import PointCloud
from mp2p_icp_tpu_torch.core.velocity_buffer import LocalVelocityBuffer
from mp2p_icp_tpu_torch.filters.deskew import FilterDeskew
from mp2p_icp_tpu_torch.filters.generator import (
    Generator,
    Observation,
    apply_generators,
    decode_rotating_scan,
    decode_scan2d,
    generators_from_yaml,
)
from mp2p_icp_tpu_torch.filters.sm2mm import (
    Keyframe,
    SimpleMap,
    Sm2MmOptions,
    simplemap_to_metricmap,
)


@pytest.fixture(autouse=True, scope="module")
def _ask_for_the_cpu():
    """The port's constructors default to the card; these tests run on the
    CPU and say so once for the whole file."""
    mp2p_icp_tpu_torch.set_default_device("cpu")
    yield
    mp2p_icp_tpu_torch.set_default_device(None)


def _poses(mat):
    """(JAX pose, port pose) of a [4, 4] numpy pose."""
    R, t = np.asarray(mat[:3, :3], np.float32), np.asarray(mat[:3, 3], np.float32)
    return jse3.Pose(jnp.asarray(R), jnp.asarray(t)), se3.Pose(torch.from_numpy(R),
                                                               torch.from_numpy(t))


def _both(fn_kwargs):
    """(JAX Observation, port Observation) of the same keywords."""
    return jgen.Observation(**fn_kwargs), Observation(**fn_kwargs)


def _rows(layer):
    n = int(layer.count)
    return (layer.xyz[:n].numpy() if isinstance(layer.xyz, torch.Tensor)
            else np.asarray(layer.xyz)[:n])


def _points_equal(lj, lt, atol=0.0):
    assert int(lj.count) == int(lt.count)
    np.testing.assert_allclose(_rows(lt), _rows(lj), rtol=0, atol=atol)
    for ch in ("intensity", "ring", "time"):
        a, b = getattr(lj, ch), getattr(lt, ch)
        assert (a is None) == (b is None), ch
        if a is not None:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


# ---------------------------------------------------------------- generators
def test_generator_gating_matches_jax():
    cases = [
        (dict(), dict(xyz=np.ones((5, 3), np.float32)), True),
        (dict(process_class_names_regex="CObservationVelodyneScan"),
         dict(class_name="CObservation2DRangeScan", xyz=np.ones((3, 3))), False),
        (dict(process_class_names_regex="CObservationVelodyneScan"),
         dict(class_name="CObservationVelodyneScan", xyz=np.ones((3, 3))), True),
        (dict(process_sensor_labels_regex="lidar_front"),
         dict(sensor_label="lidar_rear", xyz=np.ones((2, 3))), False),
        (dict(process_sensor_labels_regex="lidar_front"),
         dict(sensor_label="lidar_front", xyz=np.ones((2, 3))), True),
        (dict(), dict(class_name="CObservationIMU", angular_velocity=(0, 0, 1)), False),
    ]
    for gen_kw, obs_kw, handled in cases:
        oj, ot = _both(obs_kw)
        mj, mt = JMetricMap(), MetricMap()
        assert apply_generators([Generator(**gen_kw)], ot, mt) is handled
        assert jgen.apply_generators([jgen.Generator(**gen_kw)], oj, mj) is handled
        if handled:
            _points_equal(mj.layers["raw"], mt.layers["raw"])


def test_generator_sensor_pose_and_from_yaml():
    T = np.eye(4)
    T[:3, :3] = [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]
    T[:3, 3] = [10.0, 0.5, 1.0]
    pj, pt = _poses(T)
    xyz = np.random.RandomState(1).uniform(-5, 5, (50, 3)).astype(np.float32)
    mj, mt = JMetricMap(), MetricMap()
    jgen.Generator().process(jgen.Observation(xyz=xyz, sensor_pose=pj), mj)
    Generator().process(Observation(xyz=xyz, sensor_pose=pt), mt)
    _points_equal(mj.layers["raw"], mt.layers["raw"], atol=1e-6)
    entries = yaml.safe_load("""
- class_name: mp2p_icp_filters::Generator
  params:
    target_layer: 'scan'
    process_class_names_regex: '.*Velodyne.*'
""")
    g, = generators_from_yaml(entries)
    assert g == convert.filter_from_config(*convert.config_of(jgen.generators_from_yaml(entries)[0]))
    assert g.target_layer == "scan"
    assert generators_from_yaml(None) == [Generator()]


def test_decoders_match_jax():
    rng = np.random.RandomState(2)
    scans = [
        dict(class_name="CObservation2DRangeScan", scan_ranges=np.full(181, 4.0, np.float32),
             aperture=np.pi, max_range=20.0),
        dict(class_name="CObservation2DRangeScan",
             scan_ranges=np.array([1.0, 0.0, 5.0, 100.0], np.float32),
             scan_valid=np.array([True, True, False, True]), max_range=80.0),
        dict(class_name="CObservation2DRangeScan", right_to_left=False,
             scan_ranges=rng.uniform(0.5, 30, 361).astype(np.float32), aperture=np.pi * 1.5),
    ]
    for kw in scans:
        oj, ot = _both(kw)
        np.testing.assert_array_equal(decode_scan2d(ot)[0], jgen.decode_scan2d(oj)[0])
    pts = decode_scan2d(Observation(**scans[0]))[0]
    np.testing.assert_allclose(pts[90], [4.0, 0.0, 0.0], atol=1e-5)
    assert decode_scan2d(Observation(**scans[1]))[0].shape == (1, 3)
    R = np.full((4, 360), 10.0, np.float32)
    R[1, 5] = 0.0
    kw = dict(class_name="CObservationRotatingScan", range_image=R, sweep_duration=0.1,
              elevation_angles=np.deg2rad([-2.0, 0.0, 2.0, 4.0]).astype(np.float32),
              intensity_image=rng.rand(4, 360).astype(np.float32))
    oj, ot = _both(kw)
    for a, b in zip(decode_rotating_scan(ot), jgen.decode_rotating_scan(oj)):
        np.testing.assert_array_equal(a, b)
    assert decode_rotating_scan(ot)[0].shape == (4 * 360 - 1, 3)


def test_generator_dispatch_2d_and_rotating_scans():
    for kw, layer, n in (
            (dict(class_name="CObservation2DRangeScan", scan_ranges=np.full(11, 2.0, np.float32),
                  aperture=np.pi / 2), "2d_lidar", 11),
            (dict(class_name="CObservationRotatingScan",
                  range_image=np.full((2, 16), 3.0, np.float32), sweep_duration=0.1), "raw", 32)):
        T = np.eye(4)
        T[2, 3] = 1.0
        pj, pt = _poses(T)
        oj, ot = jgen.Observation(**kw, sensor_pose=pj), Observation(**kw, sensor_pose=pt)
        mj, mt = JMetricMap(), MetricMap()
        assert jgen.apply_generators([jgen.Generator(target_layer=layer)], oj, mj)
        assert apply_generators([Generator(target_layer=layer)], ot, mt)
        _points_equal(mj.layers[layer], mt.layers[layer], atol=1e-6)
        assert int(mt.layers[layer].count) == n


def test_metric_map_definitions_match_jax():
    entries = [{"class_name": "Generator", "params": {
        "target_layer": "voxels", "metric_map_definition": {
            "class": "mrpt::maps::CVoxelMap",
            "creationOpts": {"resolution": 0.5, "capacity": 4096},
            "insertOpts": {"ray_trace": False}}}}]
    xyz = np.random.RandomState(0).uniform(-3, 3, (500, 3)).astype(np.float32)
    for carve in (False, True):
        entries[0]["params"]["metric_map_definition"]["insertOpts"]["ray_trace"] = carve
        mj, mt = JMetricMap(), MetricMap()
        oj, ot = _both(dict(xyz=xyz))
        assert jgen.apply_generators(jgen.generators_from_yaml(entries), oj, mj)
        assert apply_generators(generators_from_yaml(entries), ot, mt)
        vj, vt = mj.layers["voxels"], mt.layers["voxels"]
        assert isinstance(vt, VoxelGridLayer) and int(vt.valid.sum()) > 0
        np.testing.assert_array_equal(vt.keys.numpy(), np.asarray(vj.keys))
        np.testing.assert_allclose(vt.occupancy.numpy(), np.asarray(vj.occupancy), atol=1e-6)
    for cls, channels in (("CSimplePointsMap", ()), ("CPointsMapXYZI", ("intensity",)),
                          ("CPointsMapXYZIRT", ("intensity", "ring", "time"))):
        g = Generator(target_layer="pts", metric_map_definition=(("class", cls),))
        mt = MetricMap()
        kw = dict(xyz=np.zeros((10, 3), np.float32), intensity=np.ones(10, np.float32),
                  ring=np.ones(10, np.float32), time=np.ones(10, np.float32))
        assert g.process(Observation(**kw), mt) and g.process(Observation(**kw), mt)
        assert int(mt.layers["pts"].count) == 20
        assert {c for c in ("intensity", "ring", "time")
                if getattr(mt.layers["pts"], c) is not None} == set(channels)
    with pytest.raises(ValueError):
        Generator(target_layer="x", metric_map_definition=(("class", "CWeirdMap"),),
                  throw_on_unhandled_observation_class=True).process(
            Observation(xyz=np.zeros((3, 3), np.float32)), MetricMap())
    with pytest.raises(ValueError):
        Generator(throw_on_unhandled_observation_class=True).process(
            Observation(class_name="CObservationOdometry"), MetricMap())


# ------------------------------------------------------------ velocity buffer
def test_velocity_buffer_matches_jax():
    bufs = (LocalVelocityBuffer(max_time_window=1.0), JBuffer(max_time_window=1.0))
    for b in bufs:
        b.add_linear_velocity(0.0, [1, 0, 0])
        b.add_linear_velocity(2.0, [2, 0, 0])
        assert 0.0 not in b._lin and 2.0 in b._lin and not b.empty()
        b.clear()
        assert b.empty()
    for b in bufs:
        r = np.random.RandomState(3)
        for t in np.arange(0, 0.2, 0.01):
            b.add_linear_velocity(t, [2.0, 0.1 * r.randn(), 0])
            b.add_angular_velocity(t + 0.003, [0.0, 0.2, 1.5 * np.sign(t - 0.1)])
    (tt, gt_), (tj, gj) = (b.reconstruct_poses_around_reference_time(0.1, 0.05, dt=0.01)
                           for b in bufs)
    np.testing.assert_array_equal(tt, tj)
    np.testing.assert_allclose(gt_, gj, atol=1e-6)
    i, j = np.argmin(np.abs(tt - 0.15)), np.argmin(np.abs(tt - 0.05))
    assert abs(gt_[i, 0] - 0.1) < 2e-3 and abs(gt_[j, 0] + 0.1) < 2e-3
    d = bufs[0].to_yaml_dict()
    assert d == bufs[1].to_yaml_dict()
    back = JBuffer.from_yaml_dict(yaml.safe_load(yaml.safe_dump(d)))
    assert sorted(back._lin) == sorted(bufs[0]._lin)


# ----------------------------------------------------------- precise deskew
W, T_REF = 1.5, 100.0  # yaw-rate magnitude (rad/s), the scan's timestamp


def _skewed_wall(rng, n=800):
    """A flat wall at x = 5 seen while the yaw rate flips sign mid-scan
    (yaw(t) = -W|t|): a motion that a constant twist cannot represent."""
    t = rng.uniform(-0.05, 0.05, n).astype(np.float32)
    world = np.stack([np.full(n, 5.0), rng.uniform(-2, 2, n), rng.uniform(0, 2, n)],
                     1).astype(np.float32)
    yaw = -W * np.abs(t)
    c, s = np.cos(yaw), np.sin(yaw)
    raw = np.stack([c * world[:, 0] + s * world[:, 1], -s * world[:, 0] + c * world[:, 1],
                    world[:, 2]], 1).astype(np.float32)
    return raw, t


def _wall_keyframe_obs(via_imu, n=800):
    raw, t = _skewed_wall(np.random.RandomState(8), n)
    obs = [dict(class_name="CObservationPointCloud", timestamp=T_REF, xyz=raw, time=t)]
    rates = [(T_REF + ti, (0.0, 0.0, W if ti < 0 else -W)) for ti in np.arange(-0.08, 0.081, 0.005)]
    if via_imu:
        return [dict(class_name="CObservationIMU", timestamp=ts, angular_velocity=w)
                for ts, w in rates] + obs
    buf = LocalVelocityBuffer(max_time_window=1.0)
    for ts, w in rates:
        buf.add_angular_velocity(ts, w)
    text = yaml.safe_dump({"local_velocity_buffer": buf.to_yaml_dict()})
    return [dict(class_name="CObservationComment", timestamp=T_REF, text=text)] + obs


def _both_maps(keyframes, pipeline, options=None):
    """(JAX MetricMap, port MetricMap) of [(pose [4, 4], twist, [obs kw])]."""
    sj = jsm.SimpleMap([jsm.Keyframe(pose=_poses(T)[0], twist=tw,
                                     observations=[jgen.Observation(**o) for o in obs])
                        for T, tw, obs in keyframes])
    st = SimpleMap([Keyframe(pose=_poses(T)[1], twist=tw,
                             observations=[Observation(**o) for o in obs])
                    for T, tw, obs in keyframes])
    jopt = jsm.Sm2MmOptions(**options) if options else jsm.Sm2MmOptions()
    topt = Sm2MmOptions(**options) if options else Sm2MmOptions()
    return jsm.simplemap_to_metricmap(sj, pipeline, jopt), simplemap_to_metricmap(st, pipeline,
                                                                                 topt)


def _deskew_pipeline(precise):
    return {"generators": None, "filters": [{"class_name": "FilterDeskew", "params": {
        "input_pointcloud_layer": "raw", "output_pointcloud_layer": "deskewed",
        "use_precise_local_velocities": precise}}]}


@pytest.mark.parametrize("via_imu", [False, True], ids=["comment_buffer", "imu"])
def test_precise_recovers_the_wall_as_jax(via_imu):
    kfs = [(np.eye(4), None, _wall_keyframe_obs(via_imu))]
    mj, mt = _both_maps(kfs, _deskew_pipeline(True))
    _points_equal(mj.layers["deskewed"], mt.layers["deskewed"], atol=1e-5)
    flat_precise = float(np.std(_rows(mt.layers["deskewed"])[:, 0]))
    _, mc = _both_maps(kfs, _deskew_pipeline(False))
    flat_const = float(np.std(_rows(mc.layers["deskewed"])[:, 0]))
    assert flat_precise < 0.02 and flat_const > 5 * flat_precise, (flat_precise, flat_const)


def test_deskew_falls_back_without_trajectory():
    raw, t = _skewed_wall(np.random.RandomState(9), n=100)
    pc = PointCloud.from_numpy(raw, time=t)
    out = FilterDeskew(use_precise_local_velocities=True)({"raw": pc}, {"vx": 0.0})
    assert torch.equal(out["deskewed"].xyz, FilterDeskew()({"raw": pc}, {"vx": 0.0})["deskewed"].xyz)


# ------------------------------------------------------------ simple maps
PIPELINE = yaml.safe_load("""
generators:
  - class_name: mp2p_icp_filters::Generator
    params:
      target_layer: 'raw'
filters:
  - class_name: mp2p_icp_filters::FilterMerge
    params:
      input_pointcloud_layer: 'raw'
      target_layer: 'map'
      input_layer_in_local_coordinates: true
final_filters:
  - class_name: mp2p_icp_filters::FilterDecimateVoxels
    params:
      input_pointcloud_layer: 'map'
      output_pointcloud_layer: 'map_decim'
      voxel_filter_resolution: 0.5
""")


def _three_keyframes(n_kfs=3):
    rng = np.random.RandomState(0)
    out = []
    for i in range(n_kfs):
        T = np.eye(4)
        T[0, 3] = 2.0 * i
        out.append((T, None, [dict(xyz=rng.uniform(-1, 1, (64, 3)).astype(np.float32))]))
    return out


@pytest.mark.parametrize("options,n_map", [(None, 3 * 64),
                                           (dict(start_index=1, end_index=2), 64)])
def test_sm2mm_accumulates_as_jax(options, n_map):
    mj, mt = _both_maps(_three_keyframes(), PIPELINE, options)
    assert int(mt.layers["map"].count) == n_map
    _points_equal(mj.layers["map"], mt.layers["map"], atol=1e-6)
    _points_equal(mj.layers["map_decim"], mt.layers["map_decim"], atol=1e-6)
    if options is None:
        assert _rows(mt.layers["map"])[:, 0].max() > 3.5


def test_simplemap_files_cross_packages(tmp_path):
    """A file saved by either package loads in the other: poses, twists,
    channels, comments, IMU samples."""
    kfs = _three_keyframes(2) + [(np.eye(4), (1, 0, 0, 0, 0, 0.1), [
        dict(class_name="CObservationComment", text="hello: 1\n"),
        dict(class_name="CObservationIMU", timestamp=3.5, angular_velocity=(0.1, 0.2, 0.3),
             linear_velocity=(1.0, 0.0, 0.0)),
        dict(xyz=np.ones((4, 3), np.float32), intensity=np.arange(4, dtype=np.float32),
             ring=np.zeros(4, np.float32), time=np.linspace(0, 1, 4).astype(np.float32))])]
    sj = jsm.SimpleMap([jsm.Keyframe(pose=_poses(T)[0], twist=tw,
                                     observations=[jgen.Observation(**o) for o in obs])
                        for T, tw, obs in kfs])
    st = SimpleMap([Keyframe(pose=_poses(T)[1], twist=tw,
                             observations=[Observation(**o) for o in obs]) for T, tw, obs in kfs])
    pj, pt = str(tmp_path / "jax.sm.npz"), str(tmp_path / "port.sm.npz")
    sj.save(pj)
    st.save(pt)
    for a, b in ((SimpleMap.load(pj), sj), (jsm.SimpleMap.load(pt), st)):
        assert len(a.keyframes) == len(b.keyframes) == 3
        for ka, kb in zip(a.keyframes, b.keyframes):
            np.testing.assert_array_equal(np.asarray(ka.pose.R), np.asarray(kb.pose.R))
            np.testing.assert_array_equal(np.asarray(ka.pose.t), np.asarray(kb.pose.t))
            assert ka.twist == kb.twist
            for oa, ob in zip(ka.observations, kb.observations):
                for f in ("class_name", "sensor_label", "timestamp", "text", "angular_velocity",
                          "linear_velocity"):
                    assert getattr(oa, f) == getattr(ob, f), f
                for ch in ("xyz", "intensity", "ring", "time"):
                    x, y = getattr(oa, ch), getattr(ob, ch)
                    assert (x is None) == (y is None)
                    if x is not None:
                        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


# ------------------------------------------------------------- the demo
def _demo_inputs(precise, n_keyframes=4):
    import chip_smoke
    from mp2p_icp_tpu_torch.eval.lidar_sim import make_street_sequence

    gt, twists, scans = make_street_sequence(n_keyframes, n_rings=16, n_azimuth=256)
    cfg = chip_smoke.sm2mm_config(precise)
    # the JAX package's occupancy lookup compares every map row with every
    # voxel record: a map of 2^15 rows keeps it to seconds
    for f in cfg["filters"]:
        if f["class_name"].endswith("FilterMerge"):
            f["params"]["target_capacity"] = 1 << 15
    return chip_smoke.sm2mm_inputs(gt, twists, scans, precise=precise, n_keyframes=n_keyframes,
                                   box_points=100), cfg


@pytest.mark.parametrize("precise", [False, True], ids=["constant_twist", "precise"])
def test_demo_sm2mm_four_keyframes_matches_jax(precise):
    inputs, cfg = _demo_inputs(precise)
    mj, mt = _both_maps(inputs, cfg)
    assert sorted(mt.layers) == sorted(mj.layers)
    for name in ("map_points", "static_points", "dynamic_points", "deskewed"):
        _points_equal(mj.layers[name], mt.layers[name], atol=1e-5)
    vj, vt = mj.layers["voxelmap"], mt.layers["voxelmap"]
    np.testing.assert_array_equal(vt.valid.numpy(), np.asarray(vj.valid))
    np.testing.assert_array_equal(vt.keys.numpy(), np.asarray(vj.keys))
    np.testing.assert_allclose(vt.occupancy.numpy(), np.asarray(vj.occupancy), atol=1e-6)
    n_raw = sum(len(o["xyz"]) for _, _, obs in inputs for o in obs if "xyz" in o)
    assert int(mt.layers["map_points"].count) == n_raw
    assert 0 < int(mt.layers["dynamic_points"].count) < n_raw


def test_demo_voxel_map_and_map_points_lie_in_different_frames():
    """Inherited from the JAX package, kept (ROADMAP C): the demo's
    GeneratorVoxelMap inserts the sensor-frame "deskewed" layer but casts
    its rays from the robot's map position, while FilterMerge moves the
    same points into the map frame. A keyframe 100 m along x: its voxel
    cells lie around the sensor-frame points (x within +-15 m), its map
    points around x = 100 m; in both packages."""
    import chip_smoke

    T = np.eye(4)
    T[:3, 3] = [100.0, 0.0, 1.7]
    xyz = np.random.RandomState(5).uniform(-10, 10, (2000, 3)).astype(np.float32)
    kfs = [(T, (0,) * 6, [dict(xyz=xyz, time=np.zeros(2000, np.float32))])]
    cfg = chip_smoke.sm2mm_config(False)
    cfg["filters"][1]["params"]["target_capacity"] = 1 << 12
    for mm in _both_maps(kfs, cfg):
        vg = mm.layers["voxelmap"]
        valid = np.asarray(vg.valid)
        hits = np.asarray(vg.occupancy)[valid] > 0.5
        centres = (np.asarray(vg.keys)[valid][hits] + 0.5) * vg.resolution
        assert np.abs(centres[:, 0]).max() < 15.0  # the sensor frame
        assert _rows(mm.layers["map_points"])[:, 0].min() > 85.0  # the map frame


def test_point2line_room_registration_from_yaml_as_jax():
    """tests/test_generator_decode.py's 2D e2e: two range scans of a room
    (test_generator_decode._room_scan2d) decoded by the 2D demo's
    generators and registered by its ICP; the align band against the JAX
    package (same termination, iterations within 25%, pose gap < 5e-3) and
    the reference's bound |log| < 0.1."""
    from pathlib import Path

    from mp2p_icp_tpu.pipeline.yaml_loader import load_icp_config_file as jload
    from mp2p_icp_tpu_torch.icp import IterTermReason
    from mp2p_icp_tpu_torch.pipeline import load_icp_config_file
    from test_generator_decode import _room_scan2d

    path = str(Path(__file__).resolve().parents[1] / "demos"
               / "icp-settings-2d-lidar-point2line.yaml")
    icp, params, sections = load_icp_config_file(path)
    jicp, jparams, jsections = jload(path)
    rng = np.random.RandomState(5)
    gt = jse3.from_xyz_ypr(0.15, -0.10, 0.0, 0.06, 0.0, 0.0)
    maps = []
    for pose in (gt, jse3.identity()):
        ranges = _room_scan2d(pose, rng)
        kw = dict(class_name="CObservation2DRangeScan", scan_ranges=ranges,
                  scan_valid=ranges > 0, aperture=2 * np.pi, max_range=50.0)
        mj, mt = JMetricMap(), MetricMap()
        assert jgen.apply_generators(jsections["generators"], jgen.Observation(**kw), mj)
        assert apply_generators(sections["generators"], Observation(**kw), mt)
        maps.append((mj, mt))
    rj = jicp.align(maps[0][0], maps[1][0], jse3.identity(), jparams)
    rt = icp.align(maps[0][1], maps[1][1], se3.identity(), params)
    assert rt.termination_reason == IterTermReason(int(rj.termination_reason))
    assert abs(rt.n_iterations - int(rj.n_iterations)) <= max(1, 0.25 * int(rj.n_iterations))
    ref = se3.exp(torch.tensor(np.asarray(jse3.log(rj.optimal_tf)), dtype=torch.float32))
    assert float(se3.error_log_norm(ref, rt.optimal_tf)) < 5e-3
    truth = se3.Pose(torch.from_numpy(np.asarray(gt.R)), torch.from_numpy(np.asarray(gt.t)))
    assert float(se3.error_log_norm(truth, rt.optimal_tf)) < 0.1
